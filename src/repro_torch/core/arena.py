"""Arena — the paper's marshalling scheme (Algorithm 1) for trees of tensors.

Counterpart of ``repro/core/arena.py``:

  * ``plan()``   = determineTotalBytes + the requestList (an
                   :class:`ArenaLayout`: per-leaf (bucket, offset, size)).
                   Integer arithmetic over the leaf order of
                   :mod:`~repro_torch.core.treepath`, so the layout equals the
                   reference's slot for slot.
  * ``pack()``   = serving the allocations: every leaf copied into its dtype
                   bucket's contiguous 1-D tensor.
  * ``unpack()`` = acc_attach: every leaf rebuilt as a VIEW of its bucket
                   (``bucket[offset:offset+size].view(shape)``) — metadata
                   only, no copy.
  * ``repack_into()`` = the reverse direction, functionally: a tree's
                   leaves scattered over copies of existing buckets (the
                   gradient-arena update path).
  * ``shard_ranges()`` = the per-device requestList of a sharded layout:
                   each bucket split into equal contiguous sub-ranges.

Buckets are per dtype and named by the dtype's numpy name (``float32``,
``int32``, ``bfloat16``), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .treepath import TreeDef, tree_flatten, tree_leaves


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.float32`` ->
    ``"float32"``) — the bucket key the reference uses."""
    return str(dtype).removeprefix("torch.")


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def as_tensor(x: Any) -> torch.Tensor:
    """A host leaf as a tensor (numpy values and Python scalars convert).
    A signature leaf — a shape and a torch dtype without data, such as
    ``analysis.cost.LeafSig`` — becomes a meta tensor, which has no
    storage, so plans and motion derivations price it without a buffer."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(getattr(x, "dtype", None), torch.dtype):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return torch.as_tensor(np.asarray(x))


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One entry of the requestList."""

    bucket: str          # dtype name
    offset: int          # elements into the bucket buffer
    size: int            # number of elements
    shape: Tuple[int, ...]
    dtype: torch.dtype


# eq=False: layouts are compared field by field where that matters (the
# parity tests), and hashed by identity so caches can key on them.
@dataclasses.dataclass(frozen=True, eq=False)
class ArenaLayout:
    treedef: TreeDef
    slots: Tuple[LeafSlot, ...]
    bucket_sizes: Dict[str, int]      # elements per bucket
    align_elems: int
    bucket_dtypes: Dict[str, torch.dtype] = dataclasses.field(default_factory=dict)
    # per-device arenas: bucket sizes are padded to a multiple of this, so
    # each of ``shard_multiple`` mesh positions owns an equal contiguous
    # sub-range (:func:`shard_ranges`)
    shard_multiple: int = 1

    @property
    def num_leaves(self) -> int:
        return len(self.slots)

    def bucket_bytes(self) -> Dict[str, int]:
        return {b: int(n) * itemsize(self.bucket_dtypes[b])
                for b, n in self.bucket_sizes.items()}

    def total_bytes(self) -> int:
        """determineTotalBytes(struct) — Alg. 1 line 2."""
        return int(sum(self.bucket_bytes().values()))

    def payload_bytes(self) -> int:
        """Bytes of live leaf data (excludes alignment padding)."""
        return int(sum(s.size * itemsize(s.dtype) for s in self.slots))


def _align(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a


def plan(tree: Any, align_elems: int = 1,
         shard_multiple: int = 1) -> ArenaLayout:
    """Walk the tree once, assign every leaf an offset in its dtype bucket.

    ``shard_multiple > 1`` pads every bucket's total size up to a multiple of
    it (tail padding only; slot offsets are unchanged), so the bucket splits
    into that many equal contiguous per-device sub-ranges.
    """
    leaves, treedef = tree_flatten(tree)
    cursors: Dict[str, int] = {}
    dtypes: Dict[str, torch.dtype] = {}
    slots: List[LeafSlot] = []
    for leaf in leaves:
        t = as_tensor(leaf)
        bucket = dtype_name(t.dtype)
        dtypes.setdefault(bucket, t.dtype)
        off = _align(cursors.get(bucket, 0), align_elems)
        size = t.numel()
        slots.append(LeafSlot(bucket, off, size, tuple(t.shape), t.dtype))
        cursors[bucket] = off + size
    if shard_multiple > 1:
        cursors = {b: _align(n, shard_multiple) for b, n in cursors.items()}
    return ArenaLayout(treedef, tuple(slots), dict(cursors), align_elems,
                       dtypes, shard_multiple)


def shard_ranges(layout: ArenaLayout, num_shards: Optional[int] = None
                 ) -> Dict[str, List[Tuple[int, int]]]:
    """Equal contiguous ``(lo, hi)`` element ranges per shard for every
    bucket: the per-device half of the requestList.  Shard ``i`` of a bucket
    of ``n`` elements owns ``[i*n/k, (i+1)*n/k)``; the bucket size must be a
    multiple of the shard count (``plan(..., shard_multiple=k)`` pads it)."""
    k = num_shards or layout.shard_multiple
    out: Dict[str, List[Tuple[int, int]]] = {}
    for bucket, n in layout.bucket_sizes.items():
        if n % k:
            raise ValueError(
                f"bucket {bucket!r} has {n} elements, not divisible into "
                f"{k} shards; plan with shard_multiple={k}")
        step = n // k
        out[bucket] = [(i * step, (i + 1) * step) for i in range(k)]
    return out


Buffers = Dict[str, torch.Tensor]


def flat_leaf(leaf: Any, slot: LeafSlot) -> torch.Tensor:
    """A host leaf as the 1-D, slot-typed, contiguous tensor the arena
    stores."""
    t = as_tensor(leaf)
    if t.dtype != slot.dtype:
        t = t.to(slot.dtype)
    return t.reshape(-1).contiguous()


def pack(tree: Any, layout: Optional[ArenaLayout] = None,
         align_elems: int = 1) -> Tuple[Buffers, ArenaLayout]:
    """Marshal the tree into fresh contiguous per-dtype host buffers."""
    if layout is None:
        layout = plan(tree, align_elems)
    leaves = tree_leaves(tree)
    if len(leaves) != layout.num_leaves:
        raise ValueError("tree does not match arena layout")
    buffers = alloc_buffers(layout)
    return pack_into(buffers, layout, tree), layout


def unpack(buffers: Buffers, layout: ArenaLayout) -> Any:
    """acc_attach — rebuild every leaf as a view of its bucket buffer."""
    leaves = [buffers[s.bucket][s.offset:s.offset + s.size].view(s.shape)
              for s in layout.slots]
    return layout.treedef.unflatten(leaves)


def alloc_buffers(layout: ArenaLayout, device: Any = "cpu",
                  pin_memory: bool = False) -> Buffers:
    """One zeroed buffer per dtype bucket."""
    # lint: allow=DC201 -- the arena allocates the engine's pinned staging; the engine decides when
    return {b: torch.zeros(int(n), dtype=layout.bucket_dtypes[b],
                           device=device, pin_memory=pin_memory)
            for b, n in layout.bucket_sizes.items()}


def pack_into(buffers: Buffers, layout: ArenaLayout, tree: Any) -> Buffers:
    """Copy every leaf to its planned offset in PREALLOCATED buffers, in
    place (the buffers may live on another device than the leaves).
    Alignment gaps keep whatever the buffers already hold."""
    leaves = tree_leaves(tree)
    if len(leaves) != layout.num_leaves:
        raise ValueError("tree does not match arena layout")
    for leaf, slot in zip(leaves, layout.slots):
        if slot.size:
            buffers[slot.bucket][slot.offset:slot.offset + slot.size].copy_(
                flat_leaf(leaf, slot))
    return buffers


def repack_into(buffers: Buffers, layout: ArenaLayout, tree: Any) -> Buffers:
    """Functionally update the arena from a (possibly modified) tree: each
    bucket is copied once and every leaf written at its offset in the copy,
    so the given buffers are left as they were.  Alignment gaps keep the
    given buffers' bytes."""
    leaves = tree_leaves(tree)
    if len(leaves) != layout.num_leaves:
        raise ValueError("tree does not match arena layout")
    out = {b: buf.clone() for b, buf in buffers.items()}
    for leaf, slot in zip(leaves, layout.slots):
        if slot.size:
            out[slot.bucket][slot.offset:slot.offset + slot.size].copy_(
                flat_leaf(leaf, slot))
    return out


# -- data-size model (paper Eq. 1–3 hooks) -----------------------------------

def datasize_linear(k: int, n: int, all_levels_init: bool = True,
                    header_bytes: int = 24, elem_bytes: int = 8) -> int:
    """Eq. 1 (allinit-*): 24k + 8nk.  Eq. 2 (LLinit): 24k + 8n."""
    if all_levels_init:
        return header_bytes * k + elem_bytes * n * k
    return header_bytes * k + elem_bytes * n


def datasize_dense(q: int, n: int, depth: int, header_bytes: int = 24,
                   last_header_bytes: int = 12, elem_bytes: int = 8) -> int:
    """Eq. 3, recursive: DataSize(q,n,D) = 24 + 8n + q*DataSize(q,n,D-1)."""
    if depth == 0:
        return last_header_bytes + elem_bytes * n
    return (header_bytes + elem_bytes * n
            + q * datasize_dense(q, n, depth - 1, header_bytes,
                                 last_header_bytes, elem_bytes))
