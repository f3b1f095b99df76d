"""Transfer schemes — thin executors of a :class:`TransferSpec`.

Counterpart of ``repro/core/schemes.py``:

  * :class:`UVMScheme`          — demand-paged analogue: leaf-granular,
                                  on-access transfers (simulated faults).
  * :class:`MarshalScheme`      — Algorithm 1: pack into contiguous arenas,
                                  one copy per dtype bucket, attach views.
                                  Blocking, ``+db`` and ``+delta``.
  * :class:`PointerChainScheme` — declared chains only (selective deep copy).

Host -> device on the card (:func:`_enqueue_copies`): every copy
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

Sharded specs (``@dpK``, K > 1) run on a mesh of K positions
(:func:`~repro_torch.core.sharded.resolve_mesh`: the default mesh is
``cuda:0 ... cuda:K-1``, ``device="cpu"`` is K positions on the CPU, a
sequence of devices is the mesh as given) and return
:class:`~repro_torch.core.sharded.ShardedTensor` leaves.  Marshal plans
per-device arenas (every bucket padded to a multiple of K), packs once and
enqueues one copy per (bucket, position) from the staging's per-shard
views, each with its own CUDA event as the fence of that copy; one barrier
covers the pass over every device of the mesh.  Under ``+delta`` only the
dirty shards re-ship (staging shard versions, plus each retained shard's
write count: the in-place write check, per shard), and each clean shard
is booked as skipped on its position.  UVM and pointerchain copy each
leaf per position: dim 0 split K ways where it divides, the whole leaf
replicated otherwise.
``from_device`` copies each piece back (D2H per piece) and reassembles.
@dp1 runs unsharded on one device, as in the reference.

Every scheme records its traffic in a :class:`TransferLedger`, field for
field the reference's, so tests can hold bytes and copy counts equal.  A
sharded transfer books its copies per mesh position (keys ``"0"`` ...
``"K-1"``), not per device index: on the CPU, or on a mesh that repeats a
card, a device index would merge the shards.

The staging race sanitizer's hooks sit where the reference's do: a
blocking ``_put_batch`` (and the blocking sharded marshal pass) reports its
barrier (``on_sync``), and the ``+db`` / ``+delta`` / sharded halves report
each bucket they enqueue and drain.  A sharded half reports the bucket's
active staging buffer, whose per-shard views it copies from (the reference
reports no array there), so DC302 and DC305 hold on sharded passes too.
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
from . import sharded as sharded_lib
from .chainref import ChainRef, declare, extract, insert
from .sharded import ShardedTensor
from .spec import TransferSpec, UnsupportedSpecError
from .treepath import TreePath, leaf_items, tree_flatten, tree_leaves, tree_map


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _enqueue_copies(jobs: Sequence[Tuple[torch.Tensor, torch.device]],
                    mark_each: bool = False
                    ) -> Tuple[List[torch.Tensor], List[Optional[Any]]]:
    """Issue one copy per ``(host tensor, device)`` job WITHOUT waiting.

    Returns the device tensors and, per job, the CUDA event recorded on its
    device's copy stream right after it: after every copy when
    ``mark_each`` (a shard copy's own fence), else only after each device's
    last copy (``None`` elsewhere, and everywhere on the CPU, where the
    copies are done).  The destinations are allocated on each device's
    compute stream, so its copy stream first waits on it (a block the
    allocator recycled may still be read there), and the compute stream
    waits on the device's last event before anything reads them."""
    ys = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x, dev in jobs]
    marks: List[Optional[Any]] = [None] * len(jobs)
    last = {dev: i for i, (_, dev) in enumerate(jobs) if dev.type == "cuda"}
    for dev in last:
        _device.copy_stream(dev).wait_stream(torch.cuda.current_stream(dev))
    for i, ((x, dev), y) in enumerate(zip(jobs, ys)):
        if dev.type != "cuda":
            y.copy_(x)
            continue
        stream = _device.copy_stream(dev)
        with torch.cuda.stream(stream):
            y.copy_(x, non_blocking=True)
            if mark_each or last[dev] == i:
                marks[i] = torch.cuda.Event()
                marks[i].record(stream)
    for dev, i in last.items():
        torch.cuda.current_stream(dev).wait_event(marks[i])
    return ys, marks


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
    device index as a string (by mesh position for a sharded transfer).
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
    CPU only when the caller passes ``device="cpu"``.  A sharded spec runs
    on :attr:`mesh`, its K positions (``device`` is then the first).
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
        self.spec = spec
        self.session = session if session is not None \
            else engine_lib.get_session()
        # @dp1 runs on one device, unsharded, as in the reference
        self.mesh: Optional[sharded_lib.Mesh] = None
        if spec.num_shards > 1:
            self.mesh = sharded_lib.resolve_mesh(device, spec.num_shards)
            self.device = self.mesh[0]
        else:
            self.device = sharded_lib.resolve_one(device, spec.device)
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
    def _put_batch(self, xs: Sequence[torch.Tensor], sync: bool = True
                   ) -> Tuple[List[Any], Optional[Any]]:
        """Enqueue every H2D copy, then (``sync``) wait for them ONCE.

        One ledger record per copy: one per buffer, or on a mesh one per
        piece of each leaf (booked on its position), each returned leaf a
        :class:`ShardedTensor`.  ``sync=False`` is the pipelined path: the
        caller fences the staging buffers with the returned event (the
        CUDA event after the copies; ``None`` on the CPU) instead; on a
        mesh it is the :class:`~repro_torch._device.Barrier` of the
        copies."""
        if not xs:
            return [], None
        t0 = time.perf_counter()
        if self.mesh is None:
            out, marks = _enqueue_copies([(x, self.device) for x in xs])
            event = marks[-1]
        else:
            split = [sharded_lib.host_pieces(x, len(self.mesh)) for x in xs]
            ys, marks = _enqueue_copies([(p.tensor, self.mesh[p.position])
                                         for ps in split for p in ps])
            it = iter(ys)
            out = [ShardedTensor(x.shape, x.dtype,
                                 [p._replace(tensor=next(it)) for p in ps])
                   for x, ps in zip(xs, split)]
            event = _device.Barrier(marks)
        t1 = time.perf_counter()
        if sync:
            if _sanitizer._ACTIVE is not None:
                _sanitizer._ACTIVE.on_sync(f"{type(self).__name__}._put_batch")
            if event is not None:
                event.synchronize()
        t2 = time.perf_counter()
        self.ledger.record_wall(t1 - t0, t2 - t1)
        if self.mesh is None:
            for x in xs:
                self.ledger.record_h2d(_nbytes(x), device=self.device)
        else:
            for x, ps in zip(xs, split):
                for p in ps:
                    self.ledger.record_h2d((p.hi - p.lo) * x.element_size(),
                                           device=str(p.position))
        return out, event

    def _put(self, x: torch.Tensor) -> Any:
        return self._put_batch([x])[0][0]

    # -- device -> host ------------------------------------------------------
    def _get_batch(self, xs: Sequence[Any]) -> List[torch.Tensor]:
        """Enqueue every D2H copy into fresh host tensors (pinned when the
        scheme runs on the card), then synchronize once (a non-blocking
        copy into pageable memory would not be safe to read).  A
        :class:`ShardedTensor` is copied back piece by piece (one copy a
        covering piece) into its slice of one host tensor; it is one ledger
        record, as the reference's one ``device_get`` of a global array."""
        if not xs:
            return []
        t0 = time.perf_counter()
        pin = any(d.type == "cuda" for d in (self.mesh or (self.device,)))
        ys, devices = [], set()
        for x in xs:
            y = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            if isinstance(x, ShardedTensor):
                flat = y.view(-1)
                copies = [(flat[p.lo:p.hi], p.tensor.reshape(-1))
                          for p in x.covering()]
            else:
                copies = [(y, x)]
            for dst, src in copies:
                dst.copy_(src, non_blocking=pin)
                devices.add(src.device)
            ys.append(y)
        t1 = time.perf_counter()
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
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
            elif isinstance(l, (torch.Tensor, ShardedTensor)):
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
    * ``sharding``    — per-device arenas: every (bucket, position) shard
                        is one copy, all enqueued before one barrier.
    * ``delta + sharding`` — per-(bucket, position) incremental transfers:
                        only the dirty shards re-ship; clean shards are
                        skipped on their position, so ``h2d + skipped ==
                        the full sharded motion`` holds on every position.
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
            tree, self.align_elems,
            pin_memory=any(d.type == "cuda"
                           for d in (self.mesh or (self.device,))),
            num_shards=len(self.mesh) if self.mesh else 1)
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
        if self.mesh is not None:
            if self.delta:
                return self._begin_delta_sharded(tree)[1]()
            return self._to_device_sharded(tree)
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
        if self.mesh is not None:
            if self.delta:
                return self._begin_delta_sharded(tree)
            return self._begin_sharded(tree)
        if self.delta:
            return self._begin_delta(tree)
        return self._begin_pipelined(tree)

    # -- sanitizer hooks -----------------------------------------------------
    @staticmethod
    def _san_enqueued(entry, buffers, names) -> None:
        """Report each enqueued bucket to the staging sanitizer.
        ``buffers`` maps bucket -> the exact host tensor the copies read
        (a sharded pass copies from its per-shard views)."""
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

    # -- sharded: per-device arenas ------------------------------------------
    def _ship_shards(self, entry, buffers, ships, sync: bool):
        """Enqueue one copy per ``(bucket, shard)`` of ``ships``, from the
        staging's shard view to its mesh position, each with its own CUDA
        event.  ``sync``: then wait them all (the pass's one barrier);
        otherwise each event fences its bucket's active staging buffer
        (in stream order it also covers the earlier copies of its stream,
        so the fence is conservative, never short).  Books one H2D record
        per shard on its position."""
        if not ships:
            return []
        ranges = arena_lib.shard_ranges(entry.layout)
        t0 = time.perf_counter()
        dev, marks = _enqueue_copies(
            [(buffers[b][slice(*ranges[b][s])], self.mesh[s])
             for b, s in ships], mark_each=True)
        t1 = time.perf_counter()
        if sync:
            if _sanitizer._ACTIVE is not None:
                _sanitizer._ACTIVE.on_sync("MarshalScheme._put_sharded")
            _device.Barrier(marks).synchronize()
        else:
            for (b, _), event in zip(ships, marks):
                entry.add_fence(b, event)
        self.ledger.record_wall(t1 - t0, time.perf_counter() - t1)
        for (b, s), y in zip(ships, dev):
            self.ledger.record_h2d(_nbytes(y), device=str(s))
        return dev

    def _all_shards(self, names):
        return [(b, s) for b in names for s in range(len(self.mesh))]

    def _to_device_sharded(self, tree):
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree)
        names = list(buffers)
        dev = iter(self._ship_shards(entry, buffers, self._all_shards(names),
                                     sync=True))
        return sharded_lib.unpack(
            {b: [next(dev) for _ in self.mesh] for b in names}, entry.layout)

    def _begin_sharded(self, tree):
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree)
        self._record_fence_wait(entry)
        names = list(buffers)
        dev = self._ship_shards(entry, buffers, self._all_shards(names),
                                sync=False)
        self._san_enqueued(entry, buffers, names)

        def finish():
            self._san_drained(entry, names)
            it = iter(dev)
            return sharded_lib.unpack(
                {b: [next(it) for _ in self.mesh] for b in names},
                entry.layout)

        return dev, finish

    def _begin_delta_sharded(self, tree):
        """The composed axes: re-ship only the (bucket, shard) pieces that
        are dirty, by the staging's shard version or by a write to the
        retained shard since it was shipped (the in-place write check, per
        shard: a write through a leaf's piece on shard s re-ships shard s
        only); book every clean shard as skipped on its position; attach
        every bucket from the retained + fresh shards.  A fully clean
        repeat returns the memoized attach."""
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree, trust_identity=True)
        self._record_fence_wait(entry)
        retained = self._delta_state.retained.setdefault(entry, {})
        names = list(buffers)
        k = len(self.mesh)
        versions = {b: list(v) for b, v in entry.shard_versions.items()}
        ranges = arena_lib.shard_ranges(entry.layout)
        itemsizes = {b: buffers[b].element_size() for b in names}
        ships, skips = [], []
        for b in names:
            held = retained.setdefault(b, [None] * k)
            for s in range(k):
                h = held[s]
                clean = (h is not None and h[0] == versions[b][s]
                         and h[2] is not None and _write_count(h[1]) == h[2])
                (skips if clean else ships).append((b, s))

        def book_clean():
            for b, s in skips:
                lo, hi = ranges[b][s]
                self.ledger.record_skip((hi - lo) * itemsizes[b],
                                        device=str(s))
            if skips:
                self.ledger.delta_calls += 1

        if not ships:
            memo = self._delta_state.last_unpack.get(entry)
            if memo is not None and memo[0] == versions:
                def finish_memo():
                    book_clean()
                    return memo[1]

                return [], finish_memo
        dev = self._ship_shards(entry, buffers, ships, sync=False)
        shipped = sorted({b for b, _ in ships}, key=names.index)
        self._san_enqueued(entry, buffers, shipped)

        def finish():
            self._san_drained(entry, shipped)
            for (b, s), arr in zip(ships, dev):
                retained[b][s] = (versions[b][s], arr, _write_count(arr))
            book_clean()
            out = sharded_lib.unpack(
                {b: [retained[b][s][1] for s in range(k)] for b in names},
                entry.layout)
            self._delta_state.last_unpack[entry] = (versions, out)
            return out

        return dev, finish

    def _pack_shards(self, entry, device_tree) -> Dict[str, ShardedTensor]:
        """The device-side direction of Alg. 1 on a mesh: every leaf's
        elements copied into fresh zeroed per-shard buckets on their
        positions (from the piece on the same position where one holds
        them), each bucket a :class:`ShardedTensor`."""
        layout = entry.layout
        ranges = arena_lib.shard_ranges(layout)
        bufs = {b: [torch.zeros(hi - lo, dtype=layout.bucket_dtypes[b],
                                device=self.mesh[s])
                    for s, (lo, hi) in enumerate(rs)]
                for b, rs in ranges.items()}
        leaves = tree_leaves(device_tree)
        if len(leaves) != layout.num_leaves:
            raise ValueError("tree does not match arena layout")
        for leaf, slot in zip(leaves, layout.slots):
            for sl in sharded_lib.slot_slices(slot, ranges[slot.bucket]):
                a, b = sl.lo - slot.offset, sl.hi - slot.offset
                src = leaf.piece_at(sl.shard, a, b) \
                    if isinstance(leaf, ShardedTensor) \
                    else arena_lib.as_tensor(leaf).reshape(-1)[a:b]
                bufs[slot.bucket][sl.shard][
                    sl.local_lo:sl.local_lo + sl.size].copy_(src)
        return {b: ShardedTensor(
            (layout.bucket_sizes[b],), layout.bucket_dtypes[b],
            [sharded_lib.Piece(s, lo, hi, t)
             for s, ((lo, hi), t) in enumerate(zip(ranges[b], bufs[b]))])
            for b in ranges}

    def from_device(self, device_tree, host_tree, paths=None):
        # demarshal: slice copies into fresh device buckets (per shard on a
        # mesh), the D2H of every bucket behind one synchronize, views of
        # the host buckets
        entry = self._entry if self._entry is not None \
            else self._entry_for(host_tree)
        if self.mesh is not None:
            buffers = self._pack_shards(entry, device_tree)
        else:
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
