"""Transfer schemes — thin executors of a :class:`TransferSpec`.

Counterpart of ``repro/core/schemes.py`` on one device:

  * :class:`UVMScheme`          — demand-paged analogue: leaf-granular,
                                  on-access transfers (simulated faults).
  * :class:`MarshalScheme`      — Algorithm 1: pack into contiguous arenas,
                                  one copy per dtype bucket, attach views.
                                  Blocking, ``+db`` and ``+delta``.
  * :class:`PointerChainScheme` — declared chains only (selective deep copy).

Host -> device on the card (:meth:`TransferScheme._enqueue_h2d`): every copy
is a ``non_blocking`` copy issued on a dedicated copy stream; the compute
stream waits on one event recorded after them, so attach and kernels are
ordered behind the copies.  The blocking path then synchronizes once per
pass; the ``+db`` / ``+delta`` paths do not, and fence the staging buffers
with that event instead (see :mod:`repro_torch.core.engine`).  Marshal
staging is pinned; per-leaf schemes copy straight from the caller's
(pageable) host leaves, which the runtime stages before the call returns.

Device -> host (:meth:`TransferScheme._get_batch`): ``non_blocking`` copies
into fresh pinned host tensors on the compute stream, then one
synchronize.  On the CPU every copy is an explicit ``copy_`` into a new
tensor, so "device" values never alias host memory there either.

Every scheme records its traffic in a :class:`TransferLedger`, field for
field the reference's, so tests can hold bytes and copy counts equal.

The staging race sanitizer's hooks sit where the reference's do: a
blocking ``_put_batch`` reports its barrier (``on_sync``), and the
``+db`` / ``+delta`` halves report each bucket they enqueue and drain.
The barriers the reference does not hook are not hooked here either: the
D2H synchronize of ``_get_batch`` (the reference's ``device_get``) and the
fence trim in :meth:`~repro_torch.core.engine.ArenaEntry.add_fence`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import _device
from ..analysis import sanitizer as _sanitizer
from . import arena as arena_lib
from . import engine as engine_lib
from .chainref import ChainRef, declare, extract, insert
from .spec import TransferSpec, UnsupportedSpecError
from .treepath import TreePath, leaf_items, tree_flatten, tree_leaves, tree_map


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclasses.dataclass
class TransferLedger:
    """Counts H2D/D2H traffic: the paper's implicit metric made explicit.

    ``wall_s`` is the caller-visible transfer time, split into
    ``enqueue_s`` (issuing the copies), ``sync_s`` (blocked in a barrier
    or fence wait) and ``finish_s`` (a program pass's bookkeeping after its
    barrier).  ``overlap_s`` is barrier time the caller did not wait for
    (an async program pass); it is not part of ``wall_s``.

    ``h2d_bytes`` / ``h2d_calls`` record only bytes that actually moved;
    ``skipped_bytes`` records bytes a delta transfer proved unchanged, so
    per pass ``h2d_bytes + skipped_bytes`` equals the full-marshal motion.
    ``*_by_device`` split the same totals per target device, keyed by the
    device index as a string.
    """

    h2d_bytes: int = 0
    d2h_bytes: int = 0
    h2d_calls: int = 0
    d2h_calls: int = 0
    wall_s: float = 0.0
    enqueue_s: float = 0.0
    sync_s: float = 0.0
    overlap_s: float = 0.0
    finish_s: float = 0.0
    skipped_bytes: int = 0
    delta_calls: int = 0
    h2d_bytes_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    h2d_calls_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    skipped_bytes_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def _device_key(device: Any) -> str:
        if isinstance(device, torch.device):
            return str(device.index or 0)
        return str(device)

    def record_h2d(self, nbytes: int, device: Optional[Any] = None) -> None:
        self.h2d_bytes += int(nbytes)
        self.h2d_calls += 1
        if device is not None:
            key = self._device_key(device)
            self.h2d_bytes_by_device[key] = \
                self.h2d_bytes_by_device.get(key, 0) + int(nbytes)
            self.h2d_calls_by_device[key] = \
                self.h2d_calls_by_device.get(key, 0) + 1

    def record_skip(self, nbytes: int, device: Optional[Any] = None) -> None:
        self.skipped_bytes += int(nbytes)
        if device is not None:
            key = self._device_key(device)
            self.skipped_bytes_by_device[key] = \
                self.skipped_bytes_by_device.get(key, 0) + int(nbytes)

    def record_d2h(self, nbytes: int) -> None:
        self.d2h_bytes += int(nbytes)
        self.d2h_calls += 1

    def record_wall(self, enqueue_s: float, sync_s: float) -> None:
        self.enqueue_s += enqueue_s
        self.sync_s += sync_s
        self.wall_s += enqueue_s + sync_s

    def record_overlap(self, overlap_s: float) -> None:
        self.overlap_s += overlap_s

    def record_finish(self, finish_s: float) -> None:
        self.finish_s += finish_s
        self.wall_s += finish_s

    def merge(self, *others: "TransferLedger") -> "TransferLedger":
        """Add other ledgers into this one (the per-device maps union-add);
        returns self, so ``TransferLedger().merge(a, b)`` is their sum."""
        for o in others:
            self.h2d_bytes += o.h2d_bytes
            self.d2h_bytes += o.d2h_bytes
            self.h2d_calls += o.h2d_calls
            self.d2h_calls += o.d2h_calls
            self.skipped_bytes += o.skipped_bytes
            self.delta_calls += o.delta_calls
            self.record_wall(o.enqueue_s, o.sync_s)
            self.record_overlap(o.overlap_s)
            self.record_finish(o.finish_s)
            for field in ("h2d_bytes_by_device", "h2d_calls_by_device",
                          "skipped_bytes_by_device"):
                mine = getattr(self, field)
                for k, v in getattr(o, field).items():
                    mine[k] = mine.get(k, 0) + v
        return self

    def per_device(self) -> Dict[str, Tuple[int, int]]:
        """{device index: (h2d_bytes, h2d_calls)}."""
        return {d: (self.h2d_bytes_by_device[d],
                    self.h2d_calls_by_device.get(d, 0))
                for d in self.h2d_bytes_by_device}

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        self.h2d_bytes = self.d2h_bytes = 0
        self.h2d_calls = self.d2h_calls = 0
        self.wall_s = self.enqueue_s = self.sync_s = 0.0
        self.overlap_s = self.finish_s = 0.0
        self.skipped_bytes = self.delta_calls = 0
        self.h2d_bytes_by_device.clear()
        self.h2d_calls_by_device.clear()
        self.skipped_bytes_by_device.clear()


class TransferScheme:
    """Protocol: move a nested state tree host<->device under a policy.

    Thin executor over a (spec, session) pair.  ``device`` is where it
    runs: the CUDA card by default (``cuda:N`` for a spec's ``@devN``), the
    CPU only when the caller passes ``device="cpu"``.
    """

    kind: str = "marshal"
    name: str = "base"

    def __init__(self, spec: Union[TransferSpec, str, None] = None,
                 session: Optional[engine_lib.TransferSession] = None,
                 device: _device.DeviceLike = None):
        spec = TransferSpec.parse(spec) if spec is not None \
            else TransferSpec(kind=self.kind)
        if spec.kind != self.kind:
            raise UnsupportedSpecError(
                f"{type(self).__name__} executes kind={self.kind!r} specs, "
                f"got {spec}")
        if spec.num_shards > 1:
            raise NotImplementedError(
                f"spec {spec}: sharded execution (@dpK, K > 1) is not yet "
                f"ported to the PyTorch package")
        # @dp1 runs on one device, unsharded, as in the reference
        self.spec = spec
        self.session = session if session is not None \
            else engine_lib.get_session()
        self.device = _device.resolve_device(device, spec.device)
        self.ledger = TransferLedger()
        self.name = spec.name

    @classmethod
    def from_spec(cls, spec: Union[TransferSpec, str],
                  session: Optional[engine_lib.TransferSession] = None,
                  **kw: Any) -> "TransferScheme":
        """Executor for ``spec``, dispatched on its kind."""
        spec = TransferSpec.parse(spec)
        return _EXECUTORS[spec.kind](spec, session, **kw)

    def to_device(self, tree: Any,
                  paths: Optional[Sequence[Union[str, TreePath]]] = None) -> Any:
        raise NotImplementedError

    def begin_pass(self, tree: Any,
                   paths: Optional[Sequence[Union[str, TreePath]]] = None
                   ) -> Tuple[List[Any], Callable[[], Any]]:
        """Enqueue this scheme's H2D copies for ``tree`` WITHOUT a
        synchronize: the enqueue-only half of ``to_device`` that lets a
        :class:`~repro_torch.core.policy.TransferProgram` enqueue every
        region before its one barrier.

        Returns ``(pending, finish)``: ``pending`` are the device tensors
        being copied (one per copy), ``finish()`` — called after the
        caller's barrier — books the rest of the ledger and returns the
        device tree.  Staging buffers are fenced with their copies' event
        here, at enqueue, not in ``finish``."""
        raise NotImplementedError

    def from_device(self, device_tree: Any, host_tree: Any,
                    paths: Optional[Sequence[Union[str, TreePath]]] = None) -> Any:
        raise NotImplementedError

    def stage(self, tree: Any, used_paths: Sequence[Union[str, TreePath]],
              uvm_access: Optional[Sequence[Union[str, TreePath]]] = None,
              declare_refs: bool = True) -> tuple:
        """Algorithm-2 transfer step under this scheme's policy: returns
        ``(device_tree, refs)`` (refs of the kernel's declared leaves)."""
        dev = self.to_device(tree)
        return dev, (declare(tree, *used_paths) if declare_refs else ())

    # -- host -> device ------------------------------------------------------
    def _enqueue_h2d(self, xs: Sequence[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], Optional[Any]]:
        """Issue one copy per host tensor WITHOUT waiting for them.

        Returns the device tensors and the CUDA event recorded after the
        copies (``None`` on the CPU, where the copies are done).  The
        destinations are allocated on the compute stream, so the copy
        stream first waits on it (a block the allocator recycled may still
        be read there), and the compute stream waits on the event before
        anything reads them."""
        dev = self.device
        if dev.type != "cuda":
            return [torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)
                    for x in xs], None
        compute = torch.cuda.current_stream(dev)
        stream = _device.copy_stream(dev)
        ys = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x in xs]
        stream.wait_stream(compute)
        with torch.cuda.stream(stream):
            for x, y in zip(xs, ys):
                y.copy_(x, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        compute.wait_event(event)
        return ys, event

    def _put_batch(self, xs: Sequence[torch.Tensor], sync: bool = True
                   ) -> Tuple[List[torch.Tensor], Optional[Any]]:
        """Enqueue every H2D copy, then (``sync``) wait for them ONCE.

        One ledger record per buffer.  ``sync=False`` is the pipelined
        path: the caller fences the staging buffers with the returned
        event instead."""
        if not xs:
            return [], None
        t0 = time.perf_counter()
        ys, event = self._enqueue_h2d(xs)
        t1 = time.perf_counter()
        if sync:
            if _sanitizer._ACTIVE is not None:
                _sanitizer._ACTIVE.on_sync(f"{type(self).__name__}._put_batch")
            if event is not None:
                event.synchronize()
        t2 = time.perf_counter()
        self.ledger.record_wall(t1 - t0, t2 - t1)
        for x in xs:
            self.ledger.record_h2d(_nbytes(x), device=self.device)
        return ys, event

    def _put(self, x: torch.Tensor) -> torch.Tensor:
        return self._put_batch([x])[0][0]

    # -- device -> host ------------------------------------------------------
    def _get_batch(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Enqueue every D2H copy into fresh pinned host tensors, then
        synchronize once (a non-blocking copy into pageable memory would not
        be safe to read)."""
        if not xs:
            return []
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            ys = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                  for x in xs]
            for x, y in zip(xs, ys):
                y.copy_(x, non_blocking=True)
            t1 = time.perf_counter()
            torch.cuda.current_stream(self.device).synchronize()
        else:
            ys = [torch.empty(x.shape, dtype=x.dtype).copy_(x) for x in xs]
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        self.ledger.record_wall(t1 - t0, t2 - t1)
        for y in ys:
            self.ledger.record_d2h(_nbytes(y))
        return ys


# ---------------------------------------------------------------------------
# UVM — demand paging, simulated at leaf granularity
# ---------------------------------------------------------------------------

class LazyLeaf:
    """A leaf that is faulted to the device on first access (a page fault)."""

    __slots__ = ("_host", "_dev", "_scheme")

    def __init__(self, host_value: Any, scheme: "UVMScheme"):
        self._host = host_value
        self._dev: Optional[torch.Tensor] = None
        self._scheme = scheme

    def get(self) -> torch.Tensor:
        if self._dev is None:
            self._dev = self._scheme._put(arena_lib.as_tensor(self._host))
        return self._dev


def _touch(node: Any) -> Any:
    return tree_map(lambda l: l.get() if isinstance(l, LazyLeaf) else l, node)


class UVMScheme(TransferScheme):
    """Demand paging, simulated as the reference does (and not with CUDA
    managed memory, so the motion stays the reference's): ``to_device``
    wraps every leaf in a :class:`LazyLeaf`, and the access walk of
    :meth:`materialize` faults the touched leaves — one copy per leaf, the
    faults of one burst enqueued together and synchronized once."""

    kind = "uvm"
    name = "uvm"

    def to_device(self, tree, paths=None):
        return tree_map(lambda leaf: LazyLeaf(leaf, self), tree)

    def begin_pass(self, tree, paths=None):
        # demand paging moves data at access time: nothing is enqueued here
        return [], lambda: self.to_device(tree)

    def _fault_batch(self, subtree: Any) -> None:
        pending, seen = [], set()
        for l in tree_leaves(subtree):
            if isinstance(l, LazyLeaf) and l._dev is None and id(l) not in seen:
                seen.add(id(l))
                pending.append(l)
        if pending:
            devs, _ = self._put_batch(
                [arena_lib.as_tensor(l._host) for l in pending])
            for leaf, dev in zip(pending, devs):
                leaf._dev = dev

    def materialize(self, lazy_tree: Any,
                    paths: Optional[Sequence[Union[str, TreePath]]] = None) -> Any:
        """Touch leaves (all, or the chains a kernel dereferences)."""
        if paths is None:
            self._fault_batch(lazy_tree)
            return _touch(lazy_tree)
        nodes = [(tp, tp.resolve(lazy_tree))
                 for tp in map(TreePath.parse, paths)]
        self._fault_batch([node for _, node in nodes])
        out = lazy_tree
        for tp, node in nodes:
            out = tp.set(out, _touch(node))
        return out

    def stage(self, tree, used_paths, uvm_access=None, declare_refs=True):
        dev = self.materialize(self.to_device(tree),
                               paths=list(uvm_access or used_paths))
        return dev, (declare(tree, *used_paths) if declare_refs else ())

    def from_device(self, device_tree, host_tree, paths=None):
        # every faulted leaf, and every tensor a kernel put in the tree, is a
        # device value; unfaulted leaves never left the host
        leaves, treedef = tree_flatten(device_tree)
        fetch_idx, fetch_vals = [], []
        for i, l in enumerate(leaves):
            if isinstance(l, LazyLeaf):
                if l._dev is not None:
                    fetch_idx.append(i)
                    fetch_vals.append(l._dev)
                else:
                    leaves[i] = l._host
            elif isinstance(l, torch.Tensor):
                fetch_idx.append(i)
                fetch_vals.append(l)
        for i, y in zip(fetch_idx, self._get_batch(fetch_vals)):
            leaves[i] = y
        return treedef.unflatten(leaves)


# ---------------------------------------------------------------------------
# Marshalling — Algorithm 1
# ---------------------------------------------------------------------------

def _write_count(t: torch.Tensor) -> Optional[int]:
    """torch's count of in-place writes to ``t`` and its views; ``None``
    for an inference tensor, which keeps no count."""
    return None if t.is_inference() else t._version


class MarshalScheme(TransferScheme):
    """Algorithm 1 on the persistent arena engine.

    * default         — every bucket shipped, one synchronize before
                        returning, so staging may be rewritten at once.
    * ``staging=db``  — same motion, no synchronize: the copies' event
                        fences the staging buffers, so the next
                        ``pack_host`` overlaps this call's copies.
    * ``delta``       — the executor's :class:`~repro_torch.core.engine.DeltaState`
                        retains every bucket on the device and re-ships only
                        buckets whose staging version moved or whose
                        retained tensor was written in place; clean buckets
                        are ``skipped_bytes``.
    """

    kind = "marshal"
    name = "marshal"

    def __init__(self, spec=None, session=None, device=None,
                 shared_state: bool = False):
        super().__init__(spec, session, device)
        self.align_elems = self.spec.align_elems
        self.delta = self.spec.delta
        self.staging = self.spec.staging
        self.layout: Optional[arena_lib.ArenaLayout] = None
        self._entry: Optional[engine_lib.ArenaEntry] = None
        self._delta_state = self.session.delta_state(
            self.spec if shared_state else None)

    def _entry_for(self, tree) -> engine_lib.ArenaEntry:
        entry = self.session.get_entry(
            tree, self.align_elems, pin_memory=self.device.type == "cuda")
        self._entry = entry
        self.layout = entry.layout
        return entry

    def mark_dirty(self, tree, *paths: Union[str, TreePath]) -> None:
        """Flag the buckets under ``paths`` (all if none) so the next
        ``to_device`` re-compares them: for callers that mutate host leaves
        in place."""
        entry = self._entry_for(tree)
        if not paths:
            entry.mark_dirty()
            return
        slots = entry.layout.slots
        entry.mark_dirty(*{slots[r.flat_index].bucket
                           for r in declare(tree, *paths)})

    def to_device(self, tree, paths=None):
        # 1) requestList (cached); 2) pack into the persistent staging;
        # 3) ONE copy per dtype bucket (only dirty buckets under delta);
        # 4) attach = views into the device buckets.
        if self.delta:
            return self._to_device_delta(tree)
        if self.staging == "double_buffered":
            return self._to_device_pipelined(tree)
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree)
        names = list(buffers)
        dev, _ = self._put_batch([buffers[b] for b in names])
        return entry.unpack(dict(zip(names, dev)))

    def _record_fence_wait(self, entry) -> None:
        fence_s = entry.take_fence_wait()
        if fence_s:
            self.ledger.record_wall(0.0, fence_s)

    def begin_pass(self, tree, paths=None):
        """Enqueue-only half of :meth:`to_device`: every mode fences its
        staging with its copies' event, so the program's barrier is not
        what keeps staging safe."""
        if self.delta:
            return self._begin_delta(tree)
        return self._begin_pipelined(tree)

    # -- sanitizer hooks -----------------------------------------------------
    @staticmethod
    def _san_enqueued(entry, buffers, names) -> None:
        """Report each enqueued bucket to the staging sanitizer.
        ``buffers`` maps bucket -> the exact host tensor handed to
        ``_enqueue_h2d``."""
        san = _sanitizer._ACTIVE
        if san is not None:
            for b in names:
                san.on_enqueue(entry, b, buffers[b])

    @staticmethod
    def _san_drained(entry, names) -> None:
        san = _sanitizer._ACTIVE
        if san is not None:
            for b in names:
                san.on_drain(entry, b)

    def _begin_pipelined(self, tree):
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree)
        self._record_fence_wait(entry)
        names = list(buffers)
        dev, event = self._put_batch([buffers[b] for b in names], sync=False)
        self._san_enqueued(entry, buffers, names)
        for b in names:
            entry.add_fence(b, event)

        def finish():
            self._san_drained(entry, names)
            return entry.unpack(dict(zip(names, dev)))

        return dev, finish

    def _to_device_pipelined(self, tree):
        return self._begin_pipelined(tree)[1]()

    def _begin_delta(self, tree):
        """Ship only the dirty buckets; attach every bucket from what is
        retained on the device.

        A bucket is dirty when its staging version moved (the host changed
        it) or when its retained device tensor was written since it was
        shipped: the tree this returns is views of the retained buckets, so
        a caller's in-place write to a leaf (``mul_``, ``index_copy_``)
        lands in them.  The second test reads torch's version counter, which
        a bucket shares with all its views, against the one recorded when
        the bucket was retained.  A dirty bucket is re-shipped from staging
        and booked as H2D; the memoized attach is returned only when no
        bucket is dirty by either test.

        What the counter cannot see: a write through ``.data`` or
        ``.detach()``, a write by a kernel through ``data_ptr()``, and
        anything done to a tensor made under ``torch.inference_mode``, which
        has no counter (such a bucket is treated as dirty on every pass).
        No path of this package writes a staged leaf in any of these ways.
        """
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree, trust_identity=True)
        self._record_fence_wait(entry)
        # bucket -> (staging version, retained device tensor, its counter)
        retained = self._delta_state.retained.setdefault(entry, {})
        names = list(buffers)
        versions = dict(entry.versions)
        bucket_bytes = entry.layout.bucket_bytes()

        def is_clean(b):
            held = retained.get(b)
            return (held is not None and held[0] == versions[b]
                    and held[2] is not None
                    and _write_count(held[1]) == held[2])

        dirty = [b for b in names if not is_clean(b)]
        clean = [b for b in names if b not in dirty]

        def book_clean():
            for b in clean:
                self.ledger.record_skip(bucket_bytes[b], device=self.device)
            if clean:
                self.ledger.delta_calls += 1

        if not dirty:
            memo = self._delta_state.last_unpack.get(entry)
            if memo is not None and memo[0] == versions:
                def finish_memo():
                    # fully clean repeat: no staging version moved and no
                    # retained bucket was written, so the attached tree
                    # still holds the host's bytes
                    book_clean()
                    return memo[1]

                return [], finish_memo
        dev, event = self._put_batch([buffers[b] for b in dirty], sync=False)
        self._san_enqueued(entry, buffers, dirty)
        for b in dirty:
            # the only reader of staging is the copy; device buckets never
            # alias host memory, so the copy's event is the whole fence
            entry.add_fence(b, event)

        def finish():
            self._san_drained(entry, dirty)
            for b, arr in zip(dirty, dev):
                retained[b] = (versions[b], arr, _write_count(arr))
            book_clean()
            out = entry.unpack({b: retained[b][1] for b in names})
            self._delta_state.last_unpack[entry] = (versions, out)
            return out

        return dev, finish

    def _to_device_delta(self, tree):
        return self._begin_delta(tree)[1]()

    def from_device(self, device_tree, host_tree, paths=None):
        # demarshal: slice copies into fresh device buckets, one D2H per
        # bucket behind one synchronize, views of the host buckets
        entry = self._entry if self._entry is not None \
            else self._entry_for(host_tree)
        buffers = entry.pack_device(device_tree, self.device)
        names = list(buffers)
        host = self._get_batch([buffers[b] for b in names])
        return arena_lib.unpack(dict(zip(names, host)), entry.layout)


# ---------------------------------------------------------------------------
# pointerchain — selective deep copy of declared chains
# ---------------------------------------------------------------------------

class PointerChainScheme(TransferScheme):
    kind = "pointerchain"
    name = "pointerchain"

    def __init__(self, spec=None, session=None, device=None):
        super().__init__(spec, session, device)
        self.refs: tuple[ChainRef, ...] = ()

    def to_device(self, tree, paths=None):
        """Extract the declared chains' leaves and move ONLY them (one copy
        per chain, one synchronize for the declare set); everything else
        stays on the host."""
        if paths is None:
            paths = [str(p) for p, _ in leaf_items(tree)]
        self.refs = declare(tree, *paths)
        leaves = [arena_lib.as_tensor(l) for l in extract(tree, self.refs)]
        dev_leaves, _ = self._put_batch(leaves)
        return insert(tree, self.refs, dev_leaves)

    def stage(self, tree, used_paths, uvm_access=None, declare_refs=True):
        dev = self.to_device(tree, paths=list(used_paths))
        return dev, self.refs

    def begin_pass(self, tree, paths=None):
        # one copy per declared chain (every leaf when no chains are
        # named), no synchronize: the caller's barrier covers them
        if paths is None:
            paths = [str(p) for p, _ in leaf_items(tree)]
        refs = self.refs = declare(tree, *paths)
        leaves = [arena_lib.as_tensor(l) for l in extract(tree, refs)]
        dev, _ = self._put_batch(leaves, sync=False)
        return dev, lambda: insert(tree, refs, dev)

    def from_device(self, device_tree, host_tree, paths=None):
        host_leaves = self._get_batch(extract(device_tree, self.refs))
        return insert(host_tree, self.refs, host_leaves)


_EXECUTORS: Dict[str, Callable[..., TransferScheme]] = {
    "uvm": UVMScheme,
    "marshal": MarshalScheme,
    "pointerchain": PointerChainScheme,
}

SCHEME_NAMES = ("uvm", "marshal", "marshal_delta", "pointerchain")


def transfer_scheme(spec: Union[TransferSpec, str],
                    session: Optional[engine_lib.TransferSession] = None,
                    device: _device.DeviceLike = None,
                    **kw: Any) -> TransferScheme:
    """Executor for ``spec`` on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``)."""
    return TransferScheme.from_spec(spec, session, device=device, **kw)


def _named_factory(name: str) -> Callable[..., TransferScheme]:
    def factory(**kw: Any) -> TransferScheme:
        return transfer_scheme(name, **kw)
    factory.__name__ = f"make_{name}"
    return factory


# the reference's name -> factory shim over the registry names
SCHEMES: Dict[str, Callable[..., TransferScheme]] = {
    name: _named_factory(name) for name in SCHEME_NAMES}


def make_scheme(name: str, **kw: Any) -> TransferScheme:
    """Executor for a scheme-registry name (``marshal_delta`` is
    ``marshal+delta``)."""
    if name not in SCHEME_NAMES:
        raise KeyError(f"unknown transfer scheme {name!r}; "
                       f"options: {sorted(SCHEME_NAMES)}")
    return transfer_scheme(name, **kw)
