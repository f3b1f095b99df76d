"""Sharded tensors on a mesh: the port's stand-in for a ``jax.Array`` under
a ``NamedSharding`` over a 1-D data mesh.

PyTorch has no single-process global sharded tensor: ``DTensor`` needs a
process group, and the reference is one controller driving every device.
So a sharded spec (``@dpK``, K > 1) runs on a **mesh**, a tuple of K
``torch.device`` positions, and its values are :class:`ShardedTensor`s: a
global shape and dtype plus one :class:`Piece` per position, each its
position, its global (flattened) element range ``[lo, hi)`` and a tensor
on that position's device.

How a leaf splits:

  * marshal leaves are views into the per-shard device buffers, at the
    ranges :func:`~repro_torch.core.chainref.resolve_shards` gives
    (:func:`unpack`); a leaf that straddles a shard boundary has two pieces
    and a leaf of size 0 none;
  * per-leaf schemes (uvm, pointerchain) and ``full_deepcopy`` split dim 0
    into K even row blocks where it divides, and replicate the leaf on every
    position otherwise (:func:`host_pieces`, the reference's
    ``_policy_target`` rule).

Mesh resolution (:func:`resolve_mesh`), from the ``device`` a caller
passes:

  * ``None`` or a CUDA device: the default mesh ``cuda:0 ... cuda:K-1``; with
    fewer cards visible it raises the reference's stale-mesh error (an
    :class:`~repro_torch.core.spec.UnsupportedSpecError`, a ``ValueError``),
    which ``TransferPolicy.reshard``'s recovery relies on;
  * ``"cpu"``: K positions on the CPU (the counterpart of the reference's
    forced host device count); ``"meta"``: K meta positions (the dry run);
  * a sequence of devices: the mesh as given, repeats included (its first K
    positions; a shorter one raises the stale-mesh error).

Nothing wraps positions onto fewer cards unless the caller passed that
mesh.  Ledgers key a sharded transfer's bookings by mesh position
(``"0"`` ... ``"K-1"``), which equal the device indices on the default mesh
and the reference's device ids.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from .._device import DeviceLike, resolve_device
from .arena import ArenaLayout, as_tensor, shard_ranges
from .chainref import slot_slices
from .placement import PlacedTensor
from .spec import UnsupportedSpecError

MeshLike = Union[DeviceLike, Sequence[DeviceLike]]
Mesh = Tuple[torch.device, ...]


def _stale(k: int, visible: int) -> UnsupportedSpecError:
    return UnsupportedSpecError(
        f"sharded spec names a dp{k} mesh, but only {visible} device(s) are "
        f"visible — the policy is stale for this (surviving) mesh; "
        f"re-derive it for {visible} device(s)")


def resolve_mesh(device: MeshLike, k: int) -> Mesh:
    """The K positions a sharded spec runs on (see the module docstring)."""
    if isinstance(device, (list, tuple)):
        if len(device) < k:
            raise _stale(k, len(device))
        return tuple(resolve_device(d) for d in device[:k])
    dev = resolve_device(device)
    if dev.type in ("cpu", "meta"):
        return (dev,) * k
    visible = torch.cuda.device_count()
    if k > visible:
        raise _stale(k, visible)
    return tuple(torch.device("cuda", i) for i in range(k))


def live_mesh(device: torch.device) -> MeshLike:
    """The mesh a runtime placed on ``device`` shards over, as its
    degradation ladder counts it: the visible cards (the default mesh) on a
    CUDA device, one position on the CPU.  A sharded rule wider than that
    raises the stale-mesh error, which the ladder degrades on."""
    return device if device.type == "cuda" else (device,)


def resolve_one(device: MeshLike, index: Optional[int] = None) -> torch.device:
    """The one device an unsharded spec runs on: ``resolve_device``, or for
    a mesh its position ``index`` (``@devN``), 0 by default."""
    if isinstance(device, (list, tuple)):
        i = index or 0
        if i >= len(device):
            raise UnsupportedSpecError(
                f"device index {i} is past the {len(device)}-position mesh")
        return resolve_device(device[i])
    return resolve_device(device, index)


class Piece(NamedTuple):
    """One position's part of a sharded value: the global flattened element
    range ``[lo, hi)`` it holds, as a tensor of ``hi - lo`` elements."""

    position: int
    lo: int
    hi: int
    tensor: torch.Tensor


class ShardedTensor:
    """A value of global ``shape`` and ``dtype`` held as pieces on a mesh.
    A replicated value has K pieces that each cover the whole."""

    __slots__ = ("shape", "dtype", "pieces")

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 pieces: Sequence[Piece]):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.pieces = tuple(pieces)

    def numel(self) -> int:
        return self.shape.numel()

    def covering(self) -> List[Piece]:
        """The pieces that tile ``[0, numel)`` once (a replica's copies
        after the first are dropped), in element order."""
        out, end = [], 0
        for p in sorted(self.pieces, key=lambda p: (p.lo, p.position)):
            if p.lo >= end and p.hi > p.lo:
                out.append(p)
                end = p.hi
        return out

    def piece_at(self, position: int, lo: int, hi: int) -> torch.Tensor:
        """Elements ``[lo, hi)`` as a flat view of one piece that holds
        them, the piece on ``position`` if it does."""
        holders = [p for p in self.pieces if p.lo <= lo and hi <= p.hi]
        if not holders:
            raise ValueError(f"no piece holds elements [{lo}, {hi}) of a "
                             f"sharded value of shape {tuple(self.shape)}")
        p = next((p for p in holders if p.position == position), holders[0])
        return p.tensor.reshape(-1)[lo - p.lo:hi - p.lo]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ShardedTensor":
        """``fn`` applied to every piece on its own device (the ranges are
        kept, so ``fn`` must be elementwise)."""
        pieces = [p._replace(tensor=fn(p.tensor)) for p in self.pieces]
        dtype = pieces[0].tensor.dtype if pieces else self.dtype
        return ShardedTensor(self.shape, dtype, pieces)

    def gather(self) -> torch.Tensor:
        """The whole value on the host: one copy a covering piece."""
        out = torch.empty(self.shape, dtype=self.dtype)
        flat = out.view(-1)
        for p in self.covering():
            flat[p.lo:p.hi].copy_(p.tensor.reshape(-1))
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, pieces="
                f"{[(p.position, p.lo, p.hi) for p in self.pieces]})")


def replicated(copies: Sequence[torch.Tensor]) -> ShardedTensor:
    """A value held whole by every position: ``copies[p]`` is position
    ``p``'s copy (one piece a position, each covering the whole value)."""
    t = copies[0]
    return ShardedTensor(t.shape, t.dtype,
                         [Piece(p, 0, t.numel(), c)
                          for p, c in enumerate(copies)])


def replica(x: Any, position: int = 0) -> Any:
    """Position ``position``'s whole copy of a replicated value (a plain
    value is returned as it is)."""
    if not isinstance(x, ShardedTensor):
        return x
    for p in x.pieces:
        if p.position == position and p.lo == 0 and p.hi == x.numel():
            return p.tensor.view(x.shape)
    raise ValueError(f"position {position} holds no whole copy of {x!r}")


def replica_count(tree_leaves: Sequence[Any]) -> int:
    """How many positions a tree's leaves are replicated over: 0 for plain
    leaves, else the pieces of each :class:`ShardedTensor` leaf (which must
    agree)."""
    counts = {len(leaf.pieces) for leaf in tree_leaves
              if isinstance(leaf, ShardedTensor)}
    if len(counts) > 1:
        raise ValueError(f"leaves replicated over different position "
                         f"counts {sorted(counts)}")
    return counts.pop() if counts else 0


def to_host(x: Any) -> torch.Tensor:
    """A device value (plain, sharded or placed) as one host tensor."""
    if isinstance(x, (ShardedTensor, PlacedTensor)):
        return x.gather()
    return as_tensor(x).cpu()


def host_pieces(t: torch.Tensor, k: int) -> List[Piece]:
    """A host leaf split for a K-position mesh: dim 0 into K even row blocks
    where it divides, else the whole leaf replicated on every position."""
    shape = tuple(t.shape)
    if shape and shape[0] % k == 0:
        rows = shape[0] // k
        inner = t[:1].numel() if shape[0] else 0
        return [Piece(s, s * rows * inner, (s + 1) * rows * inner,
                      t[s * rows:(s + 1) * rows]) for s in range(k)]
    return [Piece(s, 0, t.numel(), t) for s in range(k)]


def unpack(buffers: Dict[str, List[torch.Tensor]],
           layout: ArenaLayout) -> Any:
    """acc_attach over per-shard device buffers (``buffers[b][s]`` holds
    shard ``s`` of bucket ``b``): every leaf a :class:`ShardedTensor` whose
    pieces are views of the shard buffers it overlaps."""
    ranges = shard_ranges(layout)
    leaves = []
    for slot in layout.slots:
        pieces = [Piece(sl.shard, sl.lo - slot.offset, sl.hi - slot.offset,
                        buffers[slot.bucket][sl.shard][
                            sl.local_lo:sl.local_lo + sl.size])
                  for sl in slot_slices(slot, ranges[slot.bucket])]
        leaves.append(ShardedTensor(slot.shape, slot.dtype, pieces))
    return layout.treedef.unflatten(leaves)
