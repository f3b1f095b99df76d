"""Arena transfer engine — sessions, persistent layouts, versioned staging.

Counterpart of ``repro/core/engine.py``.  Planning (the requestList) is a
cached artifact, and the staging contents are versioned so a steady-state
repeat transfer can skip buckets whose bytes have not changed:

  * :class:`TransferSession` — owns the LRU-bounded layout and entry caches
    keyed by (treedef, leaf signature, alignment, shards, pinned staging)
    and the :class:`DeltaState` registry (retained device buckets, or
    bucket shards).  The module-level functions delegate to a default
    session.
  * :class:`ArenaEntry` — per-layout persistent state:
      - TWO host staging tensors per dtype bucket (double buffering),
        page-locked (``pin_memory``) when the target is a CUDA device so
        ``non_blocking`` copies really run on the copy engines;
      - per-bucket monotone version counters: ``pack_host`` compares each
        leaf's RAW BYTES with the staged copy and bumps a bucket's version
        only when they differ (bytes, not values: NaN != NaN);
      - per-(bucket, shard) version counters (``shard_versions``) for a
        sharded layout: a changed slot bumps exactly the shards whose
        element ranges it overlaps, so a per-device delta transfer re-ships
        only those shards (``shard_views`` are the staging's zero-copy
        per-shard views);
      - per-buffer fences: CUDA events recorded after the copies that read
        a staging buffer (on the CPU, where every copy has completed when
        it returns, a completed stand-in).  ``pack_host`` waits the target
        buffer's fence before rewriting it.

The aliasing hazard on the card: a ``non_blocking`` copy from pinned
memory still reads the staging buffer after the call that issued it has
returned.  So every path either synchronizes before staging can be
rewritten (blocking marshal) or fences the buffer with the copy's event
(``+db`` / ``+delta``).  On the CPU every "device" buffer is a real copy
(``torch.empty(...).copy_(src)``), so nothing aliases staging there.

The device-side direction of Alg. 1 has free functions for tensors that
already live on the device (the gradient arena of the train step):
:func:`pack_traced` scatters leaves into fresh zeroed buckets,
:func:`unpack_traced` attaches views, :func:`repack_traced` scatters a tree
over copies of existing buckets (``arena.repack_into``).  The reference
traces these into one fused region under ``jit``; here each leaf is one
``copy_`` on the device's stream.

Attach (:meth:`ArenaEntry.unpack`) returns VIEWS into the device buckets,
where the reference's gather produced fresh arrays: a view aliases the
bucket, and under ``+delta`` the retained bucket outlives the pass.  No
caller writes into attached leaves in place; the Algorithm-2 kernel
returns new tensors.

The staging race sanitizer (:mod:`repro_torch.analysis.sanitizer`) is
hooked where the reference hooks it: fence registration and wait, each
identity-trusted skip, each staging rewrite and each rotation.  Every
hook guards on ``_sanitizer._ACTIVE is not None``, one module-global read
when it is off.
"""
from __future__ import annotations

import collections
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..analysis import sanitizer as _sanitizer
from . import arena as arena_lib
from .arena import ArenaLayout, as_tensor, dtype_name, flat_leaf
from .treepath import tree_flatten, tree_leaves

Buffers = arena_lib.Buffers

LAYOUT_CACHE_MAX = 512
ENTRY_CACHE_MAX = 64


def _leaf_signature(leaves) -> Tuple:
    sig = []
    for leaf in leaves:
        t = as_tensor(leaf)
        sig.append((tuple(t.shape), dtype_name(t.dtype)))
    return tuple(sig)


def _layout_key(tree: Any, align_elems: int,
                num_shards: int = 1) -> Tuple[Any, ...]:
    leaves, treedef = tree_flatten(tree)
    key = (treedef, _leaf_signature(leaves), align_elems)
    return key + (num_shards,) if num_shards > 1 else key


def num_shards_of(sharding: Any) -> int:
    """Shard count of a sharding target: ``None`` (1), an int mesh size or
    a mesh (a sequence of devices, the port's ``NamedSharding``).  Anything
    else is a ``TypeError``."""
    if sharding is None:
        return 1
    if isinstance(sharding, (list, tuple)):
        return len(sharding)
    if isinstance(sharding, int):
        return int(sharding)
    raise TypeError(f"cannot read a shard count off {sharding!r}")


class DeltaState:
    """What a delta executor has already SHIPPED: per entry, the retained
    device buffer of every bucket keyed by shipped version, plus the
    memoized fully-clean attach."""

    def __init__(self):
        # entry -> {bucket: (shipped version, retained device buffer, its
        # write count when retained)}, or for a sharded layout {bucket:
        # [that triple, or None, per shard]}
        self.retained: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # entry -> (versions snapshot, attached device tree)
        self.last_unpack: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def clear(self) -> None:
        self.retained.clear()
        self.last_unpack.clear()


class TransferSession:
    """Owns every artifact that outlives one transfer call: cached layouts
    and entries (LRU-bounded) and the delta states holding retained device
    buckets."""

    def __init__(self, layout_max: Optional[int] = None,
                 entry_max: Optional[int] = None, sanitize: bool = False):
        if sanitize:
            # the shadow machine is process-wide (entries and schemes hold
            # no pointer to their session); the keyword is the opt-in next
            # to REPRO_SANITIZE=1
            _sanitizer.enable()
        self.layout_max = LAYOUT_CACHE_MAX if layout_max is None else int(layout_max)
        self.entry_max = ENTRY_CACHE_MAX if entry_max is None else int(entry_max)
        self._layouts: "collections.OrderedDict[Tuple, ArenaLayout]" = \
            collections.OrderedDict()
        self._entries: "collections.OrderedDict[Tuple, ArenaEntry]" = \
            collections.OrderedDict()
        self._stats = {"hits": 0, "misses": 0,
                       "layout_evictions": 0, "entry_evictions": 0}
        self._spec_states: Dict[Any, DeltaState] = {}
        self._delta_states: "weakref.WeakSet[DeltaState]" = weakref.WeakSet()

    # -- plans & entries -----------------------------------------------------
    def cached_plan(self, tree: Any, align_elems: int = 1) -> ArenaLayout:
        """``arena.plan`` behind the persistent layout cache."""
        return self._plan_for_key(_layout_key(tree, align_elems), tree,
                                  align_elems)

    def plan(self, tree: Any, spec: Any) -> ArenaLayout:
        """``cached_plan`` keyed by a
        :class:`~repro_torch.core.spec.TransferSpec`: its alignment and its
        shard count (every bucket padded to a multiple of it) are the plan
        parameters."""
        from .spec import TransferSpec

        spec = TransferSpec.parse(spec)
        return self._plan_for_key(
            _layout_key(tree, spec.align_elems, spec.num_shards), tree,
            spec.align_elems, spec.num_shards)

    def _plan_for_key(self, key: Tuple, tree: Any, align_elems: int,
                      shard_multiple: int = 1) -> ArenaLayout:
        layout = self._layouts.get(key)
        if layout is None:
            self._stats["misses"] += 1
            layout = arena_lib.plan(tree, align_elems, shard_multiple)
            self._layouts[key] = layout
            self._trim()
        else:
            self._stats["hits"] += 1
            self._layouts.move_to_end(key)
        return layout

    def get_entry(self, tree: Any, align_elems: int = 1,
                  pin_memory: bool = False,
                  num_shards: int = 1) -> "ArenaEntry":
        """Cached :class:`ArenaEntry` for this tree's shape.  ``pin_memory``
        (a CUDA target) is part of the key: pinned and pageable staging are
        different entries.  ``num_shards > 1`` plans per-device arenas
        (every bucket padded to a multiple of it), a distinct entry."""
        key = _layout_key(tree, align_elems, num_shards)
        entry_key = key + (pin_memory,)
        entry = self._entries.get(entry_key)
        if entry is None:
            entry = ArenaEntry(self._plan_for_key(key, tree, align_elems,
                                                  num_shards),
                               pin_memory=pin_memory)
            self._entries[entry_key] = entry
            self._trim()
        else:
            self._stats["hits"] += 1
            self._entries.move_to_end(entry_key)
        return entry

    def _trim(self) -> None:
        while len(self._layouts) > self.layout_max:
            self._layouts.popitem(last=False)
            self._stats["layout_evictions"] += 1
        while len(self._entries) > self.entry_max:
            self._entries.popitem(last=False)
            self._stats["entry_evictions"] += 1

    def set_cache_limits(self, layout_max: Optional[int] = None,
                         entry_max: Optional[int] = None) -> None:
        """Set the cache caps (a deployment's memory budget), trimming the
        caches to them at once."""
        if layout_max is not None:
            self.layout_max = int(layout_max)
        if entry_max is not None:
            self.entry_max = int(entry_max)
        self._trim()

    def pinned_bytes(self) -> int:
        """Bytes of page-locked host staging held by this session's cached
        entries (both buffers of every bucket)."""
        return sum(buf.numel() * buf.element_size()
                   for entry in self._entries.values() if entry.pin_memory
                   for bufs in entry._bufs.values() for buf in bufs)

    def cache_stats(self) -> Dict[str, int]:
        out = dict(self._stats)
        out["layout_size"] = len(self._layouts)
        out["entry_size"] = len(self._entries)
        # every device bucket (or bucket shard) a delta state still holds
        out["retained_device_buckets"] = sum(
            sum(1 for x in held if x is not None)
            if isinstance(held, list) else 1
            for state in list(self._delta_states)
            for per_entry in state.retained.values()
            for held in per_entry.values())
        return out

    # -- delta state ---------------------------------------------------------
    def delta_state(self, spec: Any = None) -> DeltaState:
        """Retained-device-state container for a delta executor: shared by
        every executor of ``spec`` in this session, or private when no spec
        is given."""
        if spec is not None:
            state = self._spec_states.get(spec)
            if state is None:
                state = self._spec_states[spec] = DeltaState()
                self._delta_states.add(state)
            return state
        state = DeltaState()
        self._delta_states.add(state)
        return state

    # -- compiled programs ---------------------------------------------------
    def compile(self, tree: Any, policy: Any, device: Any = None) -> Any:
        """Compile a :class:`~repro_torch.core.policy.TransferPolicy` against
        ``tree``'s structure into a
        :class:`~repro_torch.core.policy.TransferProgram` over THIS
        session's caches, on ``device`` (the card unless ``"cpu"``; a
        sharded rule on the mesh it names): one executor per region, every
        region's copies enqueued before one synchronize per pass."""
        from .policy import compile_program

        return compile_program(tree, policy, session=self, device=device)

    def clear(self) -> None:
        """Drop cached layouts/entries, every retained device bucket and the
        stats counters.  Live schemes keep working (cold)."""
        self._layouts.clear()
        self._entries.clear()
        self._spec_states.clear()
        for state in list(self._delta_states):
            state.clear()
        for k in self._stats:
            self._stats[k] = 0


_DEFAULT_SESSION = TransferSession()


def get_session() -> TransferSession:
    """The process-default session (what session-less construction uses)."""
    return _DEFAULT_SESSION


def cached_plan(tree: Any, align_elems: int = 1) -> ArenaLayout:
    return _DEFAULT_SESSION.cached_plan(tree, align_elems)


def get_entry(tree: Any, align_elems: int = 1, pin_memory: bool = False,
              num_shards: int = 1) -> "ArenaEntry":
    return _DEFAULT_SESSION.get_entry(tree, align_elems, pin_memory,
                                      num_shards)


def set_cache_limits(layout_max: Optional[int] = None,
                     entry_max: Optional[int] = None) -> None:
    _DEFAULT_SESSION.set_cache_limits(layout_max, entry_max)


def cache_stats() -> Dict[str, int]:
    return _DEFAULT_SESSION.cache_stats()


def clear_cache() -> None:
    _DEFAULT_SESSION.clear()


# ---------------------------------------------------------------------------
# the device-side transforms (free functions over device tensors)
# ---------------------------------------------------------------------------

def unpack_traced(buffers: Buffers, layout: ArenaLayout) -> Any:
    """acc_attach over device buckets: every leaf a view of its bucket."""
    return arena_lib.unpack(buffers, layout)


def pack_traced(tree: Any, layout: ArenaLayout) -> Buffers:
    """Scatter the leaves into fresh zeroed buckets on the leaves' device
    (the device-side direction of Alg. 1)."""
    leaves = tree_leaves(tree)
    if len(leaves) != layout.num_leaves:
        raise ValueError("tree does not match arena layout")
    device = as_tensor(leaves[0]).device if leaves else "cpu"
    return arena_lib.pack_into(arena_lib.alloc_buffers(layout, device),
                               layout, tree)


def repack_traced(buffers: Buffers, layout: ArenaLayout, tree: Any) -> Buffers:
    """``arena.repack_into`` on device buckets: a tree's leaves scattered
    over copies of existing buckets."""
    return arena_lib.repack_into(buffers, layout, tree)


# per-buffer fences are trimmed to this depth: older events are waited so a
# long clean streak cannot grow the list without bound.
FENCE_DEPTH = 8


class _Completed:
    """The fence of a CPU copy, which has completed when it returns: an
    event that is always done.  Registering it keeps the fence discipline
    (the trim, the wait, the sanitizer's view of them) the same on both
    devices."""

    __slots__ = ()

    def synchronize(self) -> None:
        pass

    def query(self) -> bool:
        return True


COMPLETED = _Completed()


class ArenaEntry:
    """Everything reusable about one (treedef, signature, alignment, shards,
    pinning) point: the layout, double-buffered host staging per bucket with
    content version counters (bucket- and shard-granular), and per-buffer
    fences."""

    def __init__(self, layout: ArenaLayout, pin_memory: bool = False):
        self.layout = layout
        self.pin_memory = pin_memory
        # zero-initialised: alignment gaps stay zero forever
        pair = [arena_lib.alloc_buffers(layout, pin_memory=pin_memory)
                for _ in range(2)]
        self._bufs: Dict[str, List[torch.Tensor]] = {
            b: [pair[0][b], pair[1][b]] for b in layout.bucket_sizes}
        self._active: Dict[str, int] = {b: 0 for b in self._bufs}
        self._fences: Dict[str, List[List[Any]]] = {
            b: [[], []] for b in self._bufs}
        # versions[b] bumps exactly when bucket b's staged bytes change (or
        # bump_version forces it) — monotone.
        self.versions: Dict[str, int] = {b: 0 for b in self._bufs}
        # shard s of bucket b bumps exactly when a changed slot overlaps its
        # element range: the per-device half of the dirty tracking
        self.shard_versions: Dict[str, List[int]] = {
            b: [0] * self.num_shards for b in self._bufs}
        self._slot_vers: List[int] = [0] * layout.num_leaves
        self._bucket_slots: Dict[str, List[int]] = {b: [] for b in self._bufs}
        for i, slot in enumerate(layout.slots):
            if slot.size:
                self._bucket_slots[slot.bucket].append(i)
        self._buf_slot_vers: Dict[str, List[List[int]]] = {
            b: [[-1] * len(idx), [-1] * len(idx)]
            for b, idx in self._bucket_slots.items()}
        self._last_leaf: List[Any] = [None] * layout.num_leaves
        self._recheck: set = set()
        self.pack_host_calls = 0
        self.fence_wait_s = 0.0

    @property
    def num_shards(self) -> int:
        return max(1, self.layout.shard_multiple)

    @property
    def staging(self) -> Buffers:
        """The ACTIVE buffer per bucket (the one holding the newest bytes)."""
        return {b: bufs[self._active[b]] for b, bufs in self._bufs.items()}

    def shard_views(self, num_shards: Optional[int] = None
                    ) -> Dict[str, List[torch.Tensor]]:
        """Zero-copy per-shard views of every active staging buffer."""
        ranges = arena_lib.shard_ranges(self.layout, num_shards)
        stg = self.staging
        return {b: [stg[b][lo:hi] for lo, hi in rs]
                for b, rs in ranges.items()}

    # -- dirty tracking ------------------------------------------------------
    def mark_dirty(self, *buckets: str) -> None:
        """Disable the identity fast path for these buckets (all if none
        given) until the next ``pack_host``."""
        self._recheck.update(buckets or self._bufs)

    def bump_version(self, *buckets: str) -> None:
        """Advance bucket (and shard) versions (all buckets if none given),
        forcing the next delta transfer to re-ship them."""
        for b in (buckets or list(self._bufs)):
            self.versions[b] += 1
            self.shard_versions[b] = [v + 1 for v in self.shard_versions[b]]

    def _bump_shards(self, bucket: str, changed: List[int]) -> None:
        """Bump the versions of the shards the changed slots overlap."""
        shards = self.shard_versions[bucket]
        k = len(shards)
        if k == 1:
            shards[0] += 1
            return
        step = self.layout.bucket_sizes[bucket] // k
        touched = set()
        for i in changed:
            slot = self.layout.slots[i]
            touched.update(range(slot.offset // step, min(
                (slot.offset + slot.size - 1) // step, k - 1) + 1))
        for s in touched:
            shards[s] += 1

    # -- fences --------------------------------------------------------------
    def add_fence(self, bucket: str, event: Optional[Any]) -> None:
        """Register a CUDA event after which the bucket's ACTIVE staging
        buffer is no longer read.  ``None`` (a CPU target, whose copies
        have completed) registers the completed stand-in."""
        fence = self._fences[bucket][self._active[bucket]]
        fence.append(COMPLETED if event is None else event)
        while len(fence) > FENCE_DEPTH:
            fence.pop(0).synchronize()
        if _sanitizer._ACTIVE is not None:
            _sanitizer._ACTIVE.on_add_fence(self, bucket, self._active[bucket],
                                            len(fence), FENCE_DEPTH)

    def _wait_fence(self, bucket: str, buf_idx: int) -> None:
        fence = self._fences[bucket][buf_idx]
        if any(event is not COMPLETED for event in fence):
            t0 = time.perf_counter()
            for event in fence:
                event.synchronize()
            self.fence_wait_s += time.perf_counter() - t0
        fence.clear()
        if _sanitizer._ACTIVE is not None:
            _sanitizer._ACTIVE.on_fence_wait(self, bucket, buf_idx)

    def take_fence_wait(self) -> float:
        s, self.fence_wait_s = self.fence_wait_s, 0.0
        return s

    # -- host side ----------------------------------------------------------
    def pack_host(self, tree: Any, *, trust_identity: bool = False) -> Buffers:
        """Marshal into the persistent staging buffers and update the
        version counters.  Per leaf: skip when the staged bytes already
        match; with ``trust_identity`` also skip the compare when the
        identical leaf object was packed last time (in-place mutators must
        ``mark_dirty``).  A bucket that changes rotates to its spare buffer
        (after waiting that buffer's fence) and bumps its version, and the
        shards its changed slots overlap bump theirs."""
        leaves = tree_leaves(tree)
        if len(leaves) != self.layout.num_leaves:
            raise ValueError("tree does not match arena layout")
        pending: Dict[int, torch.Tensor] = {}
        for i, (leaf, slot) in enumerate(zip(leaves, self.layout.slots)):
            if slot.size == 0:
                continue
            if (trust_identity and slot.bucket not in self._recheck
                    and self._last_leaf[i] is leaf):
                if _sanitizer._ACTIVE is not None:
                    # the shadow byte compare this fast path elides: catches
                    # an in-place mutation without mark_dirty (DC306)
                    _sanitizer._ACTIVE.on_identity_skip(self, slot, leaf)
                continue
            arr = flat_leaf(leaf, slot)
            # a slot never packed is always dirty; otherwise compare raw
            # bytes with the staged copy
            if self._last_leaf[i] is not None:
                act = self._bufs[slot.bucket][self._active[slot.bucket]]
                staged = act[slot.offset:slot.offset + slot.size]
                if torch.equal(staged.view(torch.uint8),
                               arr.view(torch.uint8)):
                    self._last_leaf[i] = leaf
                    continue
            self._slot_vers[i] += 1
            pending[i] = arr
            self._last_leaf[i] = leaf
        for b in {self.layout.slots[i].bucket for i in pending}:
            tgt = 1 - self._active[b]
            self._wait_fence(b, tgt)
            if _sanitizer._ACTIVE is not None:
                _sanitizer._ACTIVE.on_staging_write(self, b, tgt)
            buf = self._bufs[b][tgt]
            held = self._buf_slot_vers[b][tgt]
            for lj, si in enumerate(self._bucket_slots[b]):
                if held[lj] < self._slot_vers[si]:
                    slot = self.layout.slots[si]
                    arr = pending.get(si)
                    if arr is None:
                        arr = flat_leaf(leaves[si], slot)
                    buf[slot.offset:slot.offset + slot.size].copy_(arr)
                    held[lj] = self._slot_vers[si]
            self._active[b] = tgt
            if _sanitizer._ACTIVE is not None:
                _sanitizer._ACTIVE.on_rotate(self, b, tgt)
            self.versions[b] += 1
            self._bump_shards(b, [i for i in pending
                                  if self.layout.slots[i].bucket == b])
        self._recheck.clear()
        self.pack_host_calls += 1
        return self.staging

    # -- device side --------------------------------------------------------
    def unpack(self, buffers: Buffers) -> Any:
        """acc_attach: every leaf a view into its device bucket."""
        return arena_lib.unpack(buffers, self.layout)

    def pack_device(self, tree: Any, device: torch.device) -> Buffers:
        """The device-side direction of Alg. 1: copy every leaf into fresh
        zeroed buckets on ``device``."""
        buffers = arena_lib.alloc_buffers(self.layout, device=device)
        return arena_lib.pack_into(buffers, self.layout, tree)

    def repack(self, buffers: Buffers, tree: Any) -> Buffers:
        """:func:`repack_traced` over this entry's layout."""
        return repack_traced(buffers, self.layout, tree)
