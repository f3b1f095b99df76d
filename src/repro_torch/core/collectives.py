"""Collectives over a named mesh, single-controller: the port's stand-in for
``jax.lax.psum`` / ``pmax`` / ``pmean`` / ``psum_scatter`` / ``all_gather``
/ ``all_to_all`` inside ``shard_map``.

The reference has no such module: its collectives are XLA primitives that
one controller emits for every device of a ``jax.sharding.Mesh``.  Here
one Python controller drives every position of a :class:`NamedMesh` (K
``torch.device`` positions laid out on named axes), and a collective takes
a list of K per-position tensors, indexed by flat position, and returns
K.  No process group and no library collective is involved: a piece that
changes position moves with ``.to(device, non_blocking=True, copy=True)``
on the current stream (a device-local copy when two positions share a
card, a peer copy between cards), and a piece that stays is not copied.

Over an axis (or a tuple of axes) the positions split into groups that
differ only in their coordinates on those axes; each group runs the
collective among its members, ordered row-major over the axes as JAX
orders them.

  * Sums run **in position order** in the tensor's dtype, on the position
    that owns the result: ``((x0 + x1) + x2) + x3``.  So a reduce-scatter
    followed by an all-gather gives the same bits as an all-reduce, and
    the arena's gradient collective the same bits as the per-tensor one.
  * Every collective is plain torch ops (slicing, ``.to``, ``+``,
    ``torch.maximum``, ``torch.cat``), so autograd flows through it;
    ``all_to_all``'s gradient is the inverse ``all_to_all``, exact.
  * ``psum_scatter``, ``all_gather`` and ``all_to_all`` are tiled, as the
    reference calls them: the split dimension divides by the group size;
    ``all_to_allv`` takes explicit pieces, which may be uneven (a
    tensor-parallel decode's kv exchange, ``models/lm.py``).
  * On meta positions (the dry run's: shapes without data) a reduction's
    or an all-gather's result is computed once and every position gets
    that tensor; a reduce-scatter's or an all-to-all's is computed for
    every position, and only position 0's is booked by the dry run's
    memory counter (``repro_torch._counting.unbooked``).  The call is
    counted as on a device.

:data:`STATS` counts calls and bytes per kind, the port's counterpart of
the reference's emitted collectives (``jax.make_jaxpr``'s ``psum``
count); bytes are one position's operand.  Each call is also a
``torch.profiler`` range named ``collective.<kind>``, so a profiled step
reads the device time of the collectives' copies and adds.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _counting

Axes = Union[str, Sequence[str]]


class NamedMesh:
    """K positions on named axes, row-major (the last axis fastest, as
    ``jax.make_mesh`` lays out devices).  ``shape`` maps each axis name to
    its size (``jax.sharding.Mesh.shape``); ``devices`` is the positions'
    grid as a numpy object array (``Mesh.devices``); ``positions`` the
    flat tuple of ``torch.device``s, repeats allowed."""

    def __init__(self, positions: Sequence[torch.device],
                 sizes: Sequence[int], axis_names: Sequence[str]):
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != len(axis_names):
            raise ValueError(f"mesh shape {sizes} does not name its axes "
                             f"{tuple(axis_names)}")
        if len(positions) != int(np.prod(sizes)):
            raise ValueError(f"a mesh of shape {sizes} needs "
                             f"{int(np.prod(sizes))} positions, got "
                             f"{len(positions)}")
        self.positions = tuple(positions)
        self.axis_names = tuple(axis_names)
        self.sizes = sizes
        grid = np.empty(len(self.positions), dtype=object)
        grid[:] = list(self.positions)
        self.devices = grid.reshape(sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.positions)

    def axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of this mesh's axis names."""
        out = (axes,) if isinstance(axes, str) else tuple(axes or ())
        for a in out:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not one of the mesh's "
                                 f"{self.axis_names}")
        return out

    def axis_size(self, axes: Axes) -> int:
        shape = self.shape
        return int(np.prod([shape[a] for a in self.axes(axes)]))

    def coords(self, position: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(position, self.sizes))

    def index(self, position: int, axes: Axes) -> int:
        """The position's index within its group over ``axes``."""
        c = dict(zip(self.axis_names, self.coords(position)))
        shape = self.shape
        i = 0
        for a in self.axes(axes):
            i = i * shape[a] + c[a]
        return i

    def groups(self, axes: Axes) -> List[List[int]]:
        """The flat positions in groups that differ only on ``axes``, each
        ordered by :meth:`index`."""
        names = self.axes(axes)
        out: Dict[Tuple[int, ...], List[int]] = {}
        for p in range(self.size):
            c = self.coords(p)
            key = tuple(v for a, v in zip(self.axis_names, c)
                        if a not in names)
            out.setdefault(key, []).append(p)
        for members in out.values():
            members.sort(key=lambda p: self.index(p, names))
        return list(out.values())

    def __repr__(self) -> str:
        return (f"NamedMesh({dict(self.shape)}, "
                f"{[str(d) for d in self.positions]})")


@dataclasses.dataclass
class CollectiveStats:
    """Calls and bytes (one position's operand) per collective kind."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def add(self, kind: str, t: Optional[torch.Tensor] = None,
            nbytes: Optional[int] = None) -> None:
        """One call of ``kind`` on operand ``t`` (or of ``nbytes``)."""
        if nbytes is None:
            nbytes = t.numel() * t.element_size()
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes

    def snapshot(self) -> Dict[str, int]:
        return dict(self.calls)


STATS = CollectiveStats()


def _send(t: torch.Tensor, mesh: NamedMesh, src: int, dst: int
          ) -> torch.Tensor:
    """``t`` (held by position ``src``) as position ``dst`` receives it."""
    if src == dst:
        return t
    # lint: allow=DC201 -- a collective's piece between mesh positions on the current stream, not a host transfer
    return t.to(mesh.positions[dst], non_blocking=True, copy=True)


def _check(xs: Sequence[torch.Tensor], mesh: NamedMesh, kind: str) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{kind} takes one tensor per mesh position "
                         f"({mesh.size}), got {len(xs)}")
    STATS.add(kind, xs[0])


def _on_meta(xs: Sequence[torch.Tensor]) -> bool:
    """Whether every position holds a meta tensor (the dry run's
    positions): a result, a shape without data, is then computed once for
    the whole call, and every member of every group gets that tensor."""
    return all(x.device.type == "meta" for x in xs)


def _booked(meta: bool, first: bool):
    """On meta, position 0's result (``first``) is booked and the others'
    are not: one position's memory, as the dry run counts it."""
    return _counting.unbooked() if meta and not first \
        else contextlib.nullcontext()


def _reduce(xs, mesh, axes, kind, op) -> List[torch.Tensor]:
    _check(xs, mesh, kind)
    out: List[torch.Tensor] = list(xs)
    with torch.profiler.record_function(f"collective.{kind}"):
        groups = mesh.groups(axes)
        if _on_meta(xs) and len(groups[0]) > 1:
            acc = op(xs[0], xs[0])
            return [acc] * mesh.size
        for g in groups:
            if len(g) == 1:
                continue
            acc = xs[g[0]]
            for p in g[1:]:
                acc = op(acc, _send(xs[p], mesh, p, g[0]))
            for p in g:
                out[p] = _send(acc, mesh, g[0], p)
    return out


def psum(xs: Sequence[torch.Tensor], mesh: NamedMesh, axes: Axes
         ) -> List[torch.Tensor]:
    """All-reduce (sum) over ``axes``: every member gets the group's sum,
    taken in position order on the group's first member."""
    return _reduce(xs, mesh, axes, "psum", torch.add)


def pmax(xs: Sequence[torch.Tensor], mesh: NamedMesh, axes: Axes
         ) -> List[torch.Tensor]:
    """All-reduce (elementwise max) over ``axes``."""
    return _reduce(xs, mesh, axes, "pmax", torch.maximum)


def pmean(xs: Sequence[torch.Tensor], mesh: NamedMesh, axes: Axes
          ) -> List[torch.Tensor]:
    """All-reduce (mean) over ``axes``: the sum over the group size, as
    ``jax.lax.pmean`` computes it."""
    n = mesh.axis_size(axes)
    return [s / n for s in _reduce(xs, mesh, axes, "pmean", torch.add)]


def _chunks(t: torch.Tensor, n: int, dim: int, kind: str
            ) -> Tuple[torch.Tensor, ...]:
    if t.shape[dim] % n:
        raise ValueError(f"{kind}: dimension {dim} of size {t.shape[dim]} "
                         f"does not split into {n} tiles")
    return torch.chunk(t, n, dim=dim)


def psum_scatter(xs: Sequence[torch.Tensor], mesh: NamedMesh, axes: Axes
                 ) -> List[torch.Tensor]:
    """Reduce-scatter over ``axes`` along dim 0 (tiled): member i gets the
    sum of every member's i-th tile, taken in position order on member
    i."""
    _check(xs, mesh, "psum_scatter")
    out: List[torch.Tensor] = list(xs)
    meta = _on_meta(xs)
    with torch.profiler.record_function("collective.psum_scatter"):
        for g in mesh.groups(axes):
            tiles = [_chunks(xs[p], len(g), 0, "psum_scatter") for p in g]
            for i, dst in enumerate(g):
                with _booked(meta, dst == 0):
                    acc = _send(tiles[0][i], mesh, g[0], dst)
                    for j, src in enumerate(g[1:], 1):
                        acc = acc + _send(tiles[j][i], mesh, src, dst)
                out[dst] = acc
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: NamedMesh, axes: Axes,
               axis: int = 0) -> List[torch.Tensor]:
    """All-gather over ``axes`` along dim ``axis`` (tiled, as
    ``jax.lax.all_gather(..., axis=axis, tiled=True)``): every member gets
    the members' tensors concatenated in group order."""
    _check(xs, mesh, "all_gather")
    out: List[torch.Tensor] = list(xs)
    with torch.profiler.record_function("collective.all_gather"):
        groups = mesh.groups(axes)
        if _on_meta(xs):
            return [torch.cat([xs[src] for src in groups[0]], dim=axis)] \
                * mesh.size
        for g in groups:
            for dst in g:
                out[dst] = torch.cat([_send(xs[src], mesh, src, dst)
                                      for src in g], dim=axis)
    return out


def all_to_all(xs: Sequence[torch.Tensor], mesh: NamedMesh, axes: Axes,
               split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """All-to-all over ``axes`` (tiled): member j's ``split_axis`` splits
    into one tile a member; member i gets every member's i-th tile,
    concatenated along ``concat_axis`` in group order.  With the axes
    swapped it is its own inverse."""
    _check(xs, mesh, "all_to_all")
    out: List[torch.Tensor] = list(xs)
    meta = _on_meta(xs)
    with torch.profiler.record_function("collective.all_to_all"):
        for g in mesh.groups(axes):
            tiles = [_chunks(xs[p], len(g), split_axis, "all_to_all")
                     for p in g]
            for i, dst in enumerate(g):
                with _booked(meta, dst == 0):
                    out[dst] = torch.cat(
                        [_send(tiles[j][i], mesh, src, dst)
                         for j, src in enumerate(g)], dim=concat_axis)
    return out


def all_to_allv(pieces: Sequence[Sequence[torch.Tensor]], mesh: NamedMesh,
                axes: Axes, axis: int) -> List[torch.Tensor]:
    """All-to-all of explicit pieces over ``axes``: ``pieces[p][i]`` is
    position p's piece for the i-th member of its group (uneven pieces
    allowed, as MPI's ``Alltoallv``); member i gets every member's i-th
    piece concatenated along ``axis`` in group order.  Counted as an
    ``all_to_all`` whose operand is position 0's pieces."""
    if len(pieces) != mesh.size:
        raise ValueError(f"all_to_allv takes one piece list per mesh "
                         f"position ({mesh.size}), got {len(pieces)}")
    STATS.add("all_to_all", nbytes=sum(t.numel() * t.element_size()
                                       for t in pieces[0]))
    out: List[torch.Tensor] = [None] * mesh.size
    meta = _on_meta([t for ps in pieces for t in ps])
    with torch.profiler.record_function("collective.all_to_all"):
        for g in mesh.groups(axes):
            for i, dst in enumerate(g):
                with _booked(meta, dst == 0):
                    out[dst] = torch.cat(
                        [_send(pieces[src][i], mesh, src, dst)
                         for src in g], dim=axis)
    return out


KINDS = ("psum", "pmax", "pmean", "psum_scatter", "all_gather", "all_to_all")
__all__ = ["NamedMesh", "CollectiveStats", "STATS", "KINDS", "psum", "pmax",
           "pmean", "psum_scatter", "all_gather", "all_to_all",
           "all_to_allv"]
