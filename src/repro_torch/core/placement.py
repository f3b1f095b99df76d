"""Placements: a tensor laid out in per-dim blocks over a named mesh, the
port's counterpart of a ``jax.Array`` under a ``NamedSharding``.

A :class:`Placement` is a :class:`~repro_torch.core.collectives.NamedMesh`
and a spec with one entry a tensor dim (``None``, a mesh axis name, or a
tuple of them, as ``models.pspec.logical_to_spec`` returns).  A dim whose
entry names axes of sizes n1, n2, ... splits into n1 * n2 * ... even
blocks, the first axis major; mesh axes the spec does not name replicate.
Position p (mesh coordinates ``np.unravel_index(p, mesh.sizes)``, the
reference's ``mesh.devices.flat[p]``) holds the block at its index over
each dim's axes, so its block equals the shard that ``addressable_shards``
gives the device at the same mesh coordinates.

A :class:`PlacedTensor` holds one block a position (positions that differ
only on unnamed axes hold equal copies).  :func:`gather_blocks` runs
``core.collectives.all_gather`` over a spec's axes, giving each position
the whole value or, with ``keep`` axes, its block along those axes only
(its rows of a batch); :func:`block_of` cuts a position's block back out
of such a view.
"""
from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import torch

from . import collectives
from .collectives import NamedMesh

Entry = Any     # None | str | tuple of str


def _normalize(entry: Entry) -> Entry:
    if entry is None or entry == ():
        return None
    if isinstance(entry, (list, tuple)):
        return tuple(entry) if len(entry) > 1 else entry[0]
    return entry


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, in order."""
    entry = _normalize(entry)
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Placement:
    """``mesh`` and ``spec`` (one entry a dim; missing trailing entries
    are ``None``): the counterpart of ``NamedSharding(mesh, P(*spec))``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: NamedMesh, spec: Sequence[Entry] = ()):
        self.mesh = mesh
        self.spec = tuple(_normalize(e) for e in spec)
        for e in self.spec:
            mesh.axes(entry_axes(e))        # every name is a mesh axis

    def _entries(self, ndim: int) -> Tuple[Entry, ...]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"rank-{ndim} value has dims")
        return self.spec + (None,) * (ndim - len(self.spec))

    def parts(self, ndim: int) -> Tuple[int, ...]:
        """How many blocks each dim splits into."""
        return tuple(self.mesh.axis_size(entry_axes(e))
                     for e in self._entries(ndim))

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """One block's shape; a dim its parts do not divide raises, as
        ``NamedSharding.shard_shape`` does."""
        out = []
        for d, (n, k) in enumerate(zip(global_shape,
                                       self.parts(len(global_shape)))):
            if int(n) % k:
                raise ValueError(
                    f"spec {self.spec} splits dim {d} of {tuple(global_shape)}"
                    f" into {k} blocks, which does not divide {n}")
            out.append(int(n) // k)
        return tuple(out)

    def block_index(self, position: int, ndim: int) -> Tuple[int, ...]:
        """The position's block coordinate along each dim."""
        return tuple(self.mesh.index(position, entry_axes(e))
                     if e is not None else 0 for e in self._entries(ndim))

    def index(self, position: int, global_shape: Sequence[int]
              ) -> Tuple[slice, ...]:
        """Position ``position``'s block as one slice a dim."""
        shard = self.shard_shape(global_shape)
        return tuple(slice(i * s, (i + 1) * s) for i, s in zip(
            self.block_index(position, len(shard)), shard))

    def nbytes(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        """The bytes one position holds of a value of ``shape``."""
        return math.prod(self.shard_shape(shape)) * \
            torch.empty((), dtype=dtype).element_size()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Placement) and other.mesh is self.mesh \
            and other.spec == self.spec

    def __repr__(self) -> str:
        return f"Placement({dict(self.mesh.shape)}, {self.spec})"


class PlacedTensor:
    """A value of global ``shape`` and ``dtype`` as one block a position
    of ``placement.mesh`` (``blocks[p]`` on ``mesh.positions[p]``, of
    ``placement.shard_shape(shape)``)."""

    __slots__ = ("shape", "dtype", "placement", "blocks")

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 placement: Placement, blocks: Sequence[torch.Tensor]):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.placement = placement
        self.blocks = tuple(blocks)
        if len(self.blocks) != placement.mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a "
                             f"{placement.mesh.size}-position mesh")

    @property
    def mesh(self) -> NamedMesh:
        return self.placement.mesh

    def numel(self) -> int:
        return self.shape.numel()

    def gather(self, device: Any = "cpu") -> torch.Tensor:
        """The whole value on ``device`` (the host by default): one copy
        of each distinct block."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for p, block in enumerate(self.blocks):
            idx = self.placement.index(p, self.shape)
            key = tuple((s.start, s.stop) for s in idx)
            if key in seen:
                continue
            seen.add(key)
            # lint: allow=DC201 -- assembling a placed value's blocks, as the reference's device_get of a sharded array
            out[idx].copy_(block)
        return out

    def __repr__(self) -> str:
        return (f"PlacedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", {self.placement!r})")


def place(tensor: torch.Tensor, placement: Placement) -> PlacedTensor:
    """``tensor`` cut into ``placement``'s blocks, each copied to its
    position's device (its own memory, also where the tensor already lies
    there): the counterpart of ``jax.device_put(x, sharding)``."""
    t = torch.as_tensor(tensor)
    shard = placement.shard_shape(t.shape)
    blocks = []
    for p, dev in enumerate(placement.mesh.positions):
        out = torch.empty(shard, dtype=t.dtype, device=dev)
        # lint: allow=DC201 -- placing a value's blocks on the mesh positions (the reference's device_put to a NamedSharding)
        out.copy_(t[placement.index(p, t.shape)])
        blocks.append(out)
    return PlacedTensor(t.shape, t.dtype, placement, blocks)


def empty_placed(shape: Sequence[int], dtype: torch.dtype,
                 placement: Placement) -> PlacedTensor:
    """Uninitialized blocks of a value of ``shape`` (on meta positions:
    the dry run's arguments, shapes without data)."""
    shard = placement.shard_shape(shape)
    return PlacedTensor(shape, dtype, placement,
                        [torch.empty(shard, dtype=dtype, device=dev)
                         for dev in placement.mesh.positions])


def place_tree(tree: Any, placements: Any) -> Any:
    """Every leaf of ``tree`` under its placement in the matching tree
    ``placements``: a :class:`PlacedTensor` already there is kept, a shape
    without data (``ShapeDtype``) becomes :func:`empty_placed` blocks, and
    a tensor is cut by :func:`place`."""
    from .treepath import tree_flatten

    leaves, treedef = tree_flatten(tree)
    pls, pl_def = tree_flatten(placements)
    if pl_def != treedef:
        raise ValueError("placement tree does not match the value tree")
    out = []
    for leaf, pl in zip(leaves, pls):
        if isinstance(leaf, PlacedTensor):
            if leaf.placement != pl:
                raise ValueError(f"a leaf placed as {leaf.placement!r}, "
                                 f"expected {pl!r}")
            out.append(leaf)
        elif isinstance(leaf, torch.Tensor) or not hasattr(leaf, "dtype"):
            out.append(place(leaf, pl))
        else:
            out.append(empty_placed(leaf.shape, leaf.dtype, pl))
    return treedef.unflatten(out)


def _gathered_axes(entry: Entry, keep: Sequence[str]) -> Tuple[str, ...]:
    axes = entry_axes(entry)
    gather = tuple(a for a in axes if a not in keep)
    if gather and len(gather) != len(axes):
        raise ValueError(f"spec entry {entry!r} mixes kept axes {tuple(keep)}"
                         f" with gathered ones")
    return gather


def gather_blocks(x: PlacedTensor, keep: Sequence[str] = ()
                  ) -> List[torch.Tensor]:
    """Each position's view of ``x`` gathered over every mesh axis of its
    spec that is not in ``keep`` (one ``collectives.all_gather`` a dim):
    with ``keep=()`` the whole value on every position, with the batch
    axes kept each position's rows at full extent."""
    mesh = x.placement.mesh
    cur = list(x.blocks)
    for d, entry in enumerate(x.placement._entries(len(x.shape))):
        axes = _gathered_axes(entry, keep)
        if axes:
            cur = collectives.all_gather(cur, mesh, axes, axis=d)
    return cur


def block_of(local: torch.Tensor, placement: Placement, position: int,
             keep: Sequence[str] = ()) -> torch.Tensor:
    """Position ``position``'s block cut out of its view ``local`` (as
    :func:`gather_blocks` gives it): a view along every dim whose axes are
    not kept."""
    out = local
    for d, entry in enumerate(placement._entries(local.dim())):
        axes = _gathered_axes(entry, keep)
        if axes:
            n = placement.mesh.axis_size(axes)
            size = local.shape[d] // n
            out = out.narrow(d, placement.mesh.index(position, axes) * size,
                             size)
    return out


def position_bytes(leaves: Sequence[Tuple[Sequence[int], torch.dtype,
                                         Placement]]) -> int:
    """The bytes one position holds of these (shape, dtype, placement)
    leaves, from the placements alone (no data).  Blocks are even, so
    every position holds the same; the mesh holds ``mesh.size`` times
    it."""
    return sum(pl.nbytes(shape, dtype) for shape, dtype, pl in leaves)


__all__ = ["Placement", "PlacedTensor", "place", "empty_placed", "place_tree",
           "entry_axes", "gather_blocks", "block_of", "position_bytes"]
