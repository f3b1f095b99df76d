"""TreePath — the pytree analogue of a C pointer chain, plus the port's own
tree flattener.

Counterpart of ``repro/core/treepath.py``.  The JAX package enumerates
leaves with ``jax.tree_util``; the port needs the SAME leaf order, because
every arena offset, flat chain index and tile map derives from it.
``torch.utils._pytree`` does not give it (dicts keep insertion order and
``None`` is a leaf there), so this module flattens by JAX's rules:

  * dict   — children in sorted key order;
  * list / tuple — children in order;
  * ``None`` — an empty subtree (no leaf);
  * anything else (a tensor, a 0-d tensor for a header scalar, a
    ``LazyLeaf``) — one leaf.

A bare leaf at the root has the empty path ``TreePath(())``, whose string
is ``""`` — the reference's behaviour, kept as it is.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator, List, Sequence, Tuple, Union

Step = Union[str, int]

_STEP_RE = re.compile(r"([^.\[\]]+)|\[(-?\d+)\]")


def _parse(path: str) -> Tuple[Step, ...]:
    steps: list[Step] = []
    for name, idx in _STEP_RE.findall(path):
        if name:
            steps.append(name)
        else:
            steps.append(int(idx))
    if not steps:
        raise ValueError(f"empty tree path: {path!r}")
    return tuple(steps)


@dataclasses.dataclass(frozen=True)
class TreePath:
    """A chain of container accesses leading to a tree node.

    ``TreePath.parse("params.layers[3].attn.wq")`` mirrors the paper's
    pointer chain; :meth:`resolve` is the dereference loop, :meth:`set`
    rebuilds the spine without mutating the input tree.
    """

    steps: Tuple[Step, ...]

    @staticmethod
    def parse(path: Union[str, "TreePath", Sequence[Step]]) -> "TreePath":
        if isinstance(path, TreePath):
            return path
        if isinstance(path, str):
            return TreePath(_parse(path))
        return TreePath(tuple(path))

    def child(self, step: Step) -> "TreePath":
        return TreePath(self.steps + (step,))

    @property
    def parent(self) -> "TreePath":
        return TreePath(self.steps[:-1])

    @property
    def depth(self) -> int:
        """Chain length — the paper's ``k`` (number of dereferences)."""
        return len(self.steps)

    def resolve(self, tree: Any) -> Any:
        """Walk the chain and return the node it points at."""
        node = tree
        for step in self.steps:
            node = _step_into(node, step, self)
        return node

    def exists(self, tree: Any) -> bool:
        try:
            self.resolve(tree)
            return True
        except (KeyError, IndexError, AttributeError, TypeError):
            return False

    def set(self, tree: Any, value: Any) -> Any:
        """Return a copy of ``tree`` with the pointed-at node replaced."""
        return _set(tree, self.steps, value, self)

    def update(self, tree: Any, fn) -> Any:
        return self.set(tree, fn(self.resolve(tree)))

    def __str__(self) -> str:
        out: list[str] = []
        for step in self.steps:
            if isinstance(step, int):
                out.append(f"[{step}]")
            else:
                out.append(("." if out else "") + step)
        return "".join(out)

    def __iter__(self) -> Iterator[Step]:
        return iter(self.steps)


def _step_into(node: Any, step: Step, path: "TreePath") -> Any:
    if isinstance(step, int):
        if isinstance(node, (list, tuple, dict)):
            return node[step]
        raise TypeError(f"cannot index {type(node).__name__} with [{step}] in {path}")
    if isinstance(node, dict):
        if step in node:
            return node[step]
        raise KeyError(f"key {step!r} not found while resolving {path}")
    if dataclasses.is_dataclass(node) or hasattr(node, step):
        return getattr(node, step)
    raise TypeError(f"cannot access field {step!r} on {type(node).__name__} in {path}")


def _set(node: Any, steps: Tuple[Step, ...], value: Any, path: "TreePath") -> Any:
    if not steps:
        return value
    step, rest = steps[0], steps[1:]
    new_child = _set(_step_into(node, step, path), rest, value, path)
    if isinstance(node, dict):
        out = dict(node)
        out[step] = new_child
        return out
    if isinstance(node, (list, tuple)):
        out_l = list(node)
        out_l[step] = new_child  # type: ignore[index]
        return out_l if isinstance(node, list) else tuple(out_l)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{str(step): new_child})
    raise TypeError(f"cannot functionally update {type(node).__name__} in {path}")


# -- flattening (JAX's leaf order) -------------------------------------------

_LEAF = "*"


class TreeDef:
    """The container structure of a tree, without its leaves.  Hashable and
    comparable, so it keys the layout, entry and chain-index caches."""

    __slots__ = ("spec", "num_leaves", "_hash")

    def __init__(self, spec: Any, num_leaves: int):
        self.spec = spec
        self.num_leaves = num_leaves
        self._hash = hash(spec)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, TreeDef) and self._hash == other._hash \
            and self.spec == other.spec

    def __repr__(self) -> str:
        return f"TreeDef(num_leaves={self.num_leaves})"

    def unflatten(self, leaves: Sequence[Any]) -> Any:
        it = iter(leaves)
        out = _build(self.spec, it)
        if next(it, _LEAF) is not _LEAF:
            raise ValueError("too many leaves for this treedef")
        return out


def _walk(node: Any, leaves: list, paths: Any, prefix: Tuple[Step, ...]) -> Any:
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], leaves, paths, prefix + (k,))
                                    for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, tuple(_walk(c, leaves, paths, prefix + (i,))
                            for i, c in enumerate(node)))
    if node is None:
        return ("none",)
    leaves.append(node)
    if paths is not None:
        paths.append(prefix)
    return _LEAF


def _build(spec: Any, it: Iterator[Any]) -> Any:
    if spec is _LEAF:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("too few leaves for this treedef") from None
    kind = spec[0]
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(spec[1], spec[2])}
    if kind == "list":
        return [_build(c, it) for c in spec[1]]
    if kind == "tuple":
        return tuple(_build(c, it) for c in spec[1])
    return None


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: list = []
    spec = _walk(tree, leaves, None, ())
    return leaves, TreeDef(spec, len(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_structure(tree: Any) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    return treedef.unflatten(leaves)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([fn(leaf) for leaf in leaves])


def tree_flatten_with_path(tree: Any) -> List[Tuple[Tuple[Step, ...], Any]]:
    leaves: list = []
    paths: list = []
    _walk(tree, leaves, paths, ())
    return list(zip(paths, leaves))


# -- enumeration -------------------------------------------------------------

def leaf_paths(tree: Any) -> list[TreePath]:
    """All pointer chains ending at a leaf of ``tree``."""
    return [TreePath(steps) for steps, _ in tree_flatten_with_path(tree)]


def leaf_items(tree: Any) -> list[tuple[TreePath, Any]]:
    return [(TreePath(steps), leaf) for steps, leaf in tree_flatten_with_path(tree)]


def max_chain_depth(tree: Any) -> int:
    """The paper's ``k`` for an arbitrary state tree."""
    return max((p.depth for p in leaf_paths(tree)), default=0)
