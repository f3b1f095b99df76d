"""ChainRef — the ``pointerchain`` directive for trees of tensors.

Counterpart of ``repro/core/chainref.py`` (``declare`` / ``extract`` /
``insert`` / ``region`` / ``chain_call`` / ``chain_jit`` and the per-shard
``resolve_shards``).  The effective address of a chain is its flat leaf
index against the tree's :class:`~repro_torch.core.treepath.TreeDef`,
resolved once so the hot path never walks the nested containers again; in
a sharded arena, its per-device sub-ranges (:class:`ShardSlice`).

  paper                                      | here
  -------------------------------------------+------------------------------
  #pragma pointerchain declare(a->b->c{T})   | refs = declare(tree, "a.b.c")
  #pragma pointerchain region begin/end      | with region(tree, refs) as r: ...
  condensed version                          | chain_call(fn, tree, paths)
  scalar write-back (§3.3)                   | region(...) write-back on exit
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

from .treepath import (TreeDef, TreePath, tree_flatten, tree_flatten_with_path,
                       tree_leaves, tree_structure)

# cache: treedef -> {path string -> flat leaf index}
_INDEX_CACHE: dict[TreeDef, dict[str, int]] = {}


def _path_index_table(treedef: TreeDef) -> dict[str, int]:
    table = _INDEX_CACHE.get(treedef)
    if table is None:
        skeleton = treedef.unflatten(list(range(treedef.num_leaves)))
        table = {str(TreePath(steps)): i
                 for steps, i in tree_flatten_with_path(skeleton)}
        _INDEX_CACHE[treedef] = table
    return table


@dataclasses.dataclass(frozen=True)
class ChainRef:
    """A declared pointer chain plus its resolved effective address."""

    path: TreePath
    flat_index: int
    qualifier: Optional[str] = None  # "restrict" / "restrictconst" — doc-only hint

    def __str__(self) -> str:
        q = f"{{{self.qualifier}}}" if self.qualifier else ""
        return f"{self.path}{q}@{self.flat_index}"


def declare(tree: Any, *paths: Union[str, TreePath],
            qualifier: Optional[str] = None) -> tuple[ChainRef, ...]:
    """``#pragma pointerchain declare(...)``.

    Resolves every chain to its flat leaf index once.  A path that names an
    interior node expands to every leaf chain below it, in leaf order (the
    paper's selective deep copy over a struct-valued field).
    """
    table = _path_index_table(tree_flatten(tree)[1])
    refs: list[ChainRef] = []
    for p in paths:
        tp = TreePath.parse(p)
        key = str(tp)
        if key in table:
            refs.append(ChainRef(tp, table[key], qualifier))
            continue
        prefix, prefix_idx = key + ".", key + "["
        sub = [ChainRef(TreePath.parse(k), i, qualifier)
               for k, i in table.items()
               if k.startswith(prefix) or k.startswith(prefix_idx)]
        if not sub:
            raise KeyError(f"pointer chain {key!r} does not resolve to any leaf; "
                           f"known chains: {sorted(table)[:8]}...")
        refs.extend(sorted(sub, key=lambda r: r.flat_index))
    return tuple(refs)


def extract(tree: Any, refs: Sequence[ChainRef]) -> list[Any]:
    """Dereference every declared chain ONCE (the extraction process, §3)."""
    leaves = tree_leaves(tree)
    return [leaves[r.flat_index] for r in refs]


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One device's piece of a declared chain inside a sharded arena:
    ``lo`` / ``hi`` are bucket-global element offsets, ``local_lo`` the
    offset inside the shard's own sub-buffer (the per-device effective
    address, resolved once like ``flat_index``)."""

    shard: int
    bucket: str
    lo: int
    hi: int
    local_lo: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


def slot_slices(slot: Any, ranges: Sequence[tuple]) -> tuple[ShardSlice, ...]:
    """A slot's extent intersected with each shard range of its bucket, in
    shard order (empty for a zero-size slot)."""
    out = []
    for shard, (lo, hi) in enumerate(ranges):
        a = max(slot.offset, lo)
        b = min(slot.offset + slot.size, hi)
        if a < b:
            out.append(ShardSlice(shard, slot.bucket, a, b, a - lo))
    return tuple(out)


def resolve_shards(ref: ChainRef, layout: Any,
                   num_shards: Optional[int] = None) -> tuple[ShardSlice, ...]:
    """Resolve a declared chain to the per-device sub-ranges of its arena
    bucket.  A leaf inside one shard resolves to one slice (its transfer
    touches one device); a leaf that straddles a shard boundary to several."""
    from .arena import shard_ranges

    slot = layout.slots[ref.flat_index]
    return slot_slices(slot, shard_ranges(layout, num_shards)[slot.bucket])


def insert(tree: Any, refs: Sequence[ChainRef], values: Sequence[Any]) -> Any:
    """Write extracted values back through their chains (paper §3.3)."""
    leaves, treedef = tree_flatten(tree)
    for r, v in zip(refs, values):
        leaves[r.flat_index] = v
    return treedef.unflatten(leaves)


class Region:
    """``#pragma pointerchain region begin`` … ``end``: a mutable view over
    the extracted leaves, written back through their chains on exit."""

    def __init__(self, tree: Any, refs: Sequence[ChainRef]):
        self._tree = tree
        self._refs = tuple(refs)
        self.values: list[Any] = []
        self.result: Any = tree

    def __enter__(self) -> "Region":
        self.values = extract(self._tree, self._refs)
        return self

    def __getitem__(self, i: int) -> Any:
        return self.values[i]

    def __setitem__(self, i: int, v: Any) -> None:
        self.values[i] = v

    def __len__(self) -> int:
        return len(self.values)

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.result = insert(self._tree, self._refs, self.values)


def region(tree: Any, refs: Sequence[ChainRef]) -> Region:
    return Region(tree, refs)


# -- condensed version ------------------------------------------------------
#
# The reference compiles the region with ``jax.jit`` (over ONLY the extracted
# leaves, which shrinks its jaxpr).  That compiles plain XLA, which is plain
# PyTorch here: the region runs eagerly, and there is no jaxpr to shrink.
# ``jit`` and ``donate`` are accepted so the signatures stay the reference's.

def chain_call(fn: Callable, tree: Any, paths: Sequence[Union[str, TreePath]],
               *args, jit: bool = False, donate: bool = False,
               **kwargs) -> Any:
    """Condensed ``pointerchain region begin declare(...)`` (§3.2): runs
    ``fn(*extracted_leaves, *args, **kwargs)`` and writes the returned
    leaves back through their chains (``None`` leaves the tree as it was)."""
    del jit, donate
    refs = declare(tree, *paths)
    out = fn(*extract(tree, refs), *args, **kwargs)
    if out is None:
        return tree
    if not isinstance(out, (list, tuple)):
        out = (out,)
    if len(out) != len(refs):
        raise ValueError(f"region returned {len(out)} leaves for "
                         f"{len(refs)} chains")
    return insert(tree, refs, list(out))


def chain_jit(fn: Callable, paths: Sequence[Union[str, TreePath]],
              donate: bool = False) -> Callable:
    """``fn(leaves...) -> leaves...`` as a reusable pointerchain region:
    returns ``g(tree, *extra) -> new_tree``, which caches the ChainRefs per
    treedef, so a repeat call does no path resolution."""
    del donate
    ref_cache: dict[TreeDef, tuple[ChainRef, ...]] = {}

    def run(tree: Any, *extra, **kw) -> Any:
        treedef = tree_structure(tree)
        refs = ref_cache.get(treedef)
        if refs is None:
            refs = ref_cache[treedef] = declare(tree, *paths)
        out = fn(*extract(tree, refs), *extra, **kw)
        if not isinstance(out, (list, tuple)):
            out = (out,)
        return insert(tree, refs, list(out))

    return run
