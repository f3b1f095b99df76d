"""Runtime staging race sanitizer — a happens-before shadow state machine.

Counterpart of ``repro/analysis/sanitizer.py``, with the same states,
hooks, codes and counters.  The arena engine's correctness rests on
invariants (DESIGN.md §§4, 7, 10): a staging buffer is rewritten only after
its fence is waited, only the ACTIVE buffer of a bucket is ever enqueued,
fences are trimmed at ``FENCE_DEPTH``, a program pass synchronizes exactly
once and never inside its enqueue half, staged bytes are immutable while a
copy is in flight, and in-place host mutators call ``mark_dirty`` before
the next identity-trusted pack.  This module checks all of that
mechanically, with a shadow state machine per (bucket, buffer)::

    IDLE -> PACKING -> ENQUEUED -> IN_FLIGHT -> DRAINED
             (write)    (copy        (barrier     (finish
              begins)    issued)       started)     bookkeeping ran)

On the card the hazard is real: a ``non_blocking`` copy from pinned
staging still reads the buffer after the call that issued it returned, so
a rewrite before the copy's event has completed changes the bytes that
land on the device.

Violations raise typed exceptions carrying a ``DC3xx`` code from
:mod:`repro_torch.analysis.diagnostics`:

    DC301  staging write while the target buffer's fence is pending
    DC302  enqueued tensor is not the bucket's active staging buffer
    DC303  fence group count past ``FENCE_DEPTH`` (fence leak)
    DC304  a sync inside an enqueue half / a pass with ``syncs != 1``
    DC305  staged bytes changed between enqueue and drain (fingerprint)
    DC306  identity-trusted leaf differs from its staged bytes

Opt-in and off by default: enable with ``REPRO_SANITIZE=1`` in the
environment, ``TransferSession(sanitize=True)``, or :func:`enable` /
:func:`sanitize`.  Every hook site in the engine, the schemes and the
program guards on ``_ACTIVE is not None`` (one module-global read), so
the disabled cost is a branch.  Enabled, it adds one word-fold fingerprint
per enqueued bucket at enqueue and one at drain, a host reduction over the
whole staging buffer, and a byte compare per verified identity-skipped
leaf.

Only the standard library, numpy and torch here, so the core engine can
import it without a cycle.
"""
from __future__ import annotations

import contextlib
import os
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .diagnostics import CODES

IDLE = "IDLE"
PACKING = "PACKING"
ENQUEUED = "ENQUEUED"
IN_FLIGHT = "IN_FLIGHT"
DRAINED = "DRAINED"


class StagingRaceError(RuntimeError):
    """A staging/fence happens-before violation (DC301/302/303/305/306)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message} ({CODES[code][1]})")
        self.code = code


class SyncDisciplineError(StagingRaceError):
    """The one-sync-per-pass contract broke (DC304): a barrier ran inside
    an enqueue half, or a pass reported ``syncs != 1``."""


class _BufferShadow:
    """Shadow state of one (bucket, buffer-index) staging buffer."""

    __slots__ = ("state", "pending_fences", "checksum", "enq_ref")

    def __init__(self):
        self.state = IDLE
        self.pending_fences = 0
        self.checksum: Optional[int] = None
        self.enq_ref: Optional[torch.Tensor] = None


def _fingerprint(t: torch.Tensor) -> int:
    """Content fingerprint of a host staging tensor: xor- and sum-fold of
    its 64-bit words (the reference's fold).  The raw bytes are read
    through a ``uint8`` view, so any dtype folds, bf16 included.  Any
    accidental in-flight write perturbs at least one word and so both
    folds; a mutation detector, not a cryptographic digest."""
    view = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    split = view.size - (view.size % 8)
    words = view[:split].view(np.uint64)
    xor_fold = int(np.bitwise_xor.reduce(words)) if words.size else 0
    sum_fold = int(np.sum(words, dtype=np.uint64)) if words.size else 0
    tail = int.from_bytes(view[split:].tobytes(), "little")
    return hash((xor_fold, sum_fold, tail, view.size))


class Sanitizer:
    """The shadow machine.  One instance is installed process-wide
    (:data:`_ACTIVE`); hooks are called by the engine, the schemes'
    ``_begin_*`` / finish halves and the compiled program and its future.
    Shadow records are weak on the
    :class:`~repro_torch.core.engine.ArenaEntry`, so the sanitizer never
    extends an entry's lifetime."""

    #: identity-skipped leaves are re-verified on their first two skips
    #: after every staging write of their bucket, then every Nth: DC306 is
    #: caught within N passes at about 1/N of the skipped bytes per pass.
    VERIFY_EVERY = 4

    def __init__(self):
        self._records: "weakref.WeakKeyDictionary[Any, Dict[Tuple[str, int], _BufferShadow]]" = \
            weakref.WeakKeyDictionary()
        self._skips: "weakref.WeakKeyDictionary[Any, Dict[Tuple[str, int], int]]" = \
            weakref.WeakKeyDictionary()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.events: Dict[str, int] = {}

    # -- bookkeeping ---------------------------------------------------------
    def _shadow(self, entry: Any, bucket: str, buf_idx: int) -> _BufferShadow:
        per_entry = self._records.get(entry)
        if per_entry is None:
            per_entry = self._records.setdefault(entry, {})
        shadow = per_entry.get((bucket, buf_idx))
        if shadow is None:
            shadow = per_entry[(bucket, buf_idx)] = _BufferShadow()
        return shadow

    def _count(self, event: str) -> None:
        with self._lock:
            self.events[event] = self.events.get(event, 0) + 1

    @property
    def _enqueue_depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    # -- the enqueue-half context (TransferProgram._begin) -------------------
    def begin_enqueue_half(self) -> None:
        self._tls.depth = self._enqueue_depth + 1

    def end_enqueue_half(self) -> None:
        self._tls.depth = max(0, self._enqueue_depth - 1)

    # -- engine hooks (ArenaEntry) -------------------------------------------
    def on_staging_write(self, entry: Any, bucket: str, buf_idx: int) -> None:
        """``pack_host`` is about to rewrite buffer ``buf_idx`` of
        ``bucket`` (its fence must have been waited)."""
        self._count("staging_write")
        shadow = self._shadow(entry, bucket, buf_idx)
        if shadow.pending_fences:
            raise StagingRaceError(
                "DC301",
                f"pack_host rewrites bucket {bucket!r} buffer {buf_idx} "
                f"while {shadow.pending_fences} fence group(s) are still "
                f"pending — the fence wait was skipped")
        shadow.state = PACKING
        shadow.checksum = None
        shadow.enq_ref = None
        # a rewrite of this bucket re-arms full identity verification for
        # its slots (their skip streak is broken)
        skips = self._skips.get(entry)
        if skips:
            for key in [k for k in skips if k[0] == bucket]:
                del skips[key]

    def on_rotate(self, entry: Any, bucket: str, new_active: int) -> None:
        """The bucket rotated: ``new_active`` now holds the newest bytes."""
        self._count("rotate")
        shadow = self._shadow(entry, bucket, new_active)
        if shadow.state in (ENQUEUED, IN_FLIGHT):
            raise StagingRaceError(
                "DC302",
                f"bucket {bucket!r} rotated onto buffer {new_active} while "
                f"it is still {shadow.state} (double rotate / missing "
                f"drain)")

    def on_add_fence(self, entry: Any, bucket: str, buf_idx: int,
                     depth: int, limit: int) -> None:
        """A fence group was registered; ``depth`` is the group count after
        the engine's trim, ``limit`` is ``FENCE_DEPTH``."""
        self._count("add_fence")
        shadow = self._shadow(entry, bucket, buf_idx)
        shadow.pending_fences = depth
        if depth > limit:
            raise StagingRaceError(
                "DC303",
                f"bucket {bucket!r} buffer {buf_idx} holds {depth} fence "
                f"groups, past FENCE_DEPTH={limit} — the trim was skipped "
                f"and events accumulate without bound")

    def on_fence_wait(self, entry: Any, bucket: str, buf_idx: int) -> None:
        """``_wait_fence`` completed for this buffer: its copies are done,
        a rewrite is now legal."""
        self._count("fence_wait")
        self._shadow(entry, bucket, buf_idx).pending_fences = 0

    def on_identity_skip(self, entry: Any, slot: Any, leaf: Any) -> None:
        """``pack_host(trust_identity=True)`` skipped the byte compare for
        a leaf because the identical object was packed last time.  The
        sanitizer runs the compare anyway (a mismatch means the caller
        mutated the leaf in place and forgot ``mark_dirty``), amortized per
        :data:`VERIFY_EVERY`."""
        from ..core.arena import flat_leaf

        self._count("identity_skip")
        skips = self._skips.get(entry)
        if skips is None:
            skips = self._skips.setdefault(entry, {})
        streak = skips.get((slot.bucket, slot.offset), 0) + 1
        skips[(slot.bucket, slot.offset)] = streak
        if streak > 2 and streak % self.VERIFY_EVERY:
            return
        self._count("identity_verify")
        buf = entry._bufs[slot.bucket][entry._active[slot.bucket]]
        staged = buf[slot.offset:slot.offset + slot.size]
        if not torch.equal(staged.view(torch.uint8),
                           flat_leaf(leaf, slot).view(torch.uint8)):
            raise StagingRaceError(
                "DC306",
                f"identity-trusted leaf in bucket {slot.bucket!r} (offset "
                f"{slot.offset}) no longer matches its staged bytes — the "
                f"leaf was mutated in place without mark_dirty()")

    # -- scheme hooks (the _begin_* / finish halves) -------------------------
    def on_enqueue(self, entry: Any, bucket: str, t: torch.Tensor) -> None:
        """A scheme issued the H2D copy of ``bucket``'s staging.  ``t`` is
        the exact host tensor the copy reads, or whose per-shard views a
        sharded pass copies (held by identity)."""
        self._count("enqueue")
        active_idx = entry._active[bucket]
        shadow = self._shadow(entry, bucket, active_idx)
        if t is not entry._bufs[bucket][active_idx]:
            raise StagingRaceError(
                "DC302",
                f"enqueued tensor for bucket {bucket!r} is not the "
                f"bucket's ACTIVE staging buffer — a stale (drained) "
                f"buffer was reused")
        shadow.checksum = _fingerprint(t)
        shadow.enq_ref = t
        shadow.state = ENQUEUED

    def on_sync(self, where: str = "") -> None:
        """A blocking barrier is starting.  Illegal inside an enqueue half
        (the one-sync-per-pass contract); otherwise advances every
        ENQUEUED buffer to IN_FLIGHT."""
        self._count("sync")
        if self._enqueue_depth > 0:
            raise SyncDisciplineError(
                "DC304",
                f"barrier at {where or 'a scheme'} inside a program's "
                f"enqueue half — a pass must synchronize exactly once, "
                f"after every region has enqueued")
        for per_entry in list(self._records.values()):
            for shadow in per_entry.values():
                if shadow.state == ENQUEUED:
                    shadow.state = IN_FLIGHT

    def on_drain(self, entry: Any, bucket: str) -> None:
        """A scheme's finish ran for ``bucket`` (after the barrier): the
        copy drained.  Verifies the staged bytes are the ones enqueued."""
        self._count("drain")
        per_entry = self._records.get(entry)
        if per_entry is None:
            return
        for (b, _), shadow in per_entry.items():
            if b != bucket or shadow.state not in (ENQUEUED, IN_FLIGHT):
                continue
            if shadow.enq_ref is not None and shadow.checksum is not None:
                if _fingerprint(shadow.enq_ref) != shadow.checksum:
                    shadow.state = DRAINED
                    shadow.checksum = None
                    shadow.enq_ref = None
                    raise StagingRaceError(
                        "DC305",
                        f"staging bytes of bucket {bucket!r} changed "
                        f"between enqueue and drain — the buffer was "
                        f"mutated while its copy was in flight")
            shadow.state = DRAINED
            shadow.checksum = None
            shadow.enq_ref = None

    # -- program hooks -------------------------------------------------------
    def on_pass_stats(self, stats: Any) -> None:
        """A program pass completed with ``stats``; the one-sync contract
        must hold."""
        self._count("pass")
        if stats is not None and stats.syncs != 1:
            raise SyncDisciplineError(
                "DC304",
                f"program pass reported syncs={stats.syncs}; the contract "
                f"is exactly one barrier per pass")

    def reset(self) -> None:
        self._records = weakref.WeakKeyDictionary()
        self._skips = weakref.WeakKeyDictionary()
        self.events.clear()


# ---------------------------------------------------------------------------
# process-wide activation
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Sanitizer] = None


def active() -> Optional[Sanitizer]:
    return _ACTIVE


def enable(fresh: bool = False) -> Sanitizer:
    """Install (and return) the process-wide sanitizer.  Idempotent unless
    ``fresh=True``, which installs a new shadow machine."""
    global _ACTIVE
    if _ACTIVE is None or fresh:
        _ACTIVE = Sanitizer()
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def sanitize():
    """``with sanitize() as san: ...`` — enable for a block, restoring the
    previous activation state after."""
    global _ACTIVE
    prev = _ACTIVE
    san = Sanitizer()
    _ACTIVE = san
    try:
        yield san
    finally:
        _ACTIVE = prev


class _EnqueueHalf:
    """No-op when the sanitizer is off; marks the thread as inside a
    program's enqueue half when on.  Keeps the machine it entered with, so
    an enable / disable inside the block cannot unbalance the depth."""

    __slots__ = ("_san",)

    def __enter__(self):
        self._san = _ACTIVE
        if self._san is not None:
            self._san.begin_enqueue_half()
        return self

    def __exit__(self, *exc):
        if self._san is not None:
            self._san.end_enqueue_half()
        return False


def enqueue_half() -> _EnqueueHalf:
    return _EnqueueHalf()


if os.environ.get("REPRO_SANITIZE", "").strip() not in ("", "0"):
    enable()
