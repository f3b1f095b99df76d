"""Full / selective deep-copy operations over trees of tensors (paper §2).

Counterpart of ``repro/core/deepcopy.py``: the per-leaf oracle the schemes
are held against — one plain copy per leaf, none of the engine's staging,
batching or delta machinery.  Both copies take an optional
:class:`~repro_torch.core.schemes.TransferLedger` and an optional
``sharding`` (a mesh size K: each leaf placed over a K-position mesh as a
:class:`~repro_torch.core.sharded.ShardedTensor`, dim 0 split K ways where
it divides and replicated otherwise, the reference's ``_policy_target``
rule); ``full_deepcopy`` also places each leaf by a path-scoped policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from .arena import as_tensor
from .chainref import declare, extract, insert
from .policy import TransferPolicy
from .schemes import TransferLedger
from .sharded import (MeshLike, ShardedTensor, host_pieces, resolve_mesh,
                      resolve_one)
from .treepath import (TreePath, leaf_paths, tree_flatten, tree_leaves,
                       tree_map)


def _nbytes(x: Any) -> int:
    t = as_tensor(x)
    return t.numel() * t.element_size()


def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    # always a real copy, also when device is the CPU
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _copy_to(leaf: Any, device: MeshLike, ledger: Optional[TransferLedger],
             k: int = 1, index: Optional[int] = None) -> Any:
    """One leaf placed on ``device`` (``@devN``: ``index``), or over the
    K-position mesh it names when ``k > 1``; one ledger record a leaf."""
    t = as_tensor(leaf)
    if ledger is not None:
        ledger.record_h2d(_nbytes(t))
    if k == 1:
        return _copy(t, resolve_one(device, index))
    mesh = resolve_mesh(device, k)
    return ShardedTensor(t.shape, t.dtype,
                         [p._replace(tensor=_copy(p.tensor, mesh[p.position]))
                          for p in host_pieces(t, k)])


def full_deepcopy(tree: Any, device: MeshLike = None,
                  ledger: Optional[TransferLedger] = None,
                  policy: Any = None, sharding: Optional[int] = None) -> Any:
    """Replicate the whole structure on the device (full deep copy), or with
    ``sharding=K`` over the K-position mesh ``device`` names.

    ``policy`` (a :class:`~repro_torch.core.policy.TransferPolicy` or policy
    string) places each leaf on its region's target, one plain copy per
    leaf (per position): the card (``cuda:N`` for an ``@devN`` rule), the
    mesh of an ``@dpK`` rule.  This is the value oracle a compiled
    program's pass is held against.  With a policy, ``device`` may only be
    ``"cpu"``, which puts every leaf (every position) on the CPU (the
    port's opt-in for running without a card); any other device, or
    ``sharding``, raises, as the reference's placement arguments do."""
    if policy is None:
        k = sharding or 1
        return tree_map(lambda leaf: _copy_to(leaf, device, ledger, k), tree)
    if sharding is not None or (
            device is not None and torch.device(device).type != "cpu"):
        raise ValueError("policy placement is exclusive with the device / "
                         "sharding arguments (only device='cpu' is accepted)")
    policy = TransferPolicy.parse(policy)
    leaves, treedef = tree_flatten(tree)
    out = []
    for path, leaf in zip(leaf_paths(tree), leaves):
        spec = policy.match(path).spec
        out.append(_copy_to(leaf, device, ledger, spec.num_shards,
                            spec.device))
    return treedef.unflatten(out)


def selective_deepcopy(tree: Any, paths: Sequence[Union[str, TreePath]],
                       device: MeshLike = None,
                       ledger: Optional[TransferLedger] = None,
                       sharding: Optional[int] = None) -> Any:
    """Move only the declared chains (over a K-position mesh with
    ``sharding=K``); everything else stays put (paper §2)."""
    refs = declare(tree, *paths)
    moved = [_copy_to(leaf, device, ledger, sharding or 1)
             for leaf in extract(tree, refs)]
    return insert(tree, refs, moved)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a leaf, without its data."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def host_skeleton(tree: Any) -> Any:
    """Shape/dtype skeleton of a tree — the structure replicated in both
    spaces (§2) without allocating any data."""
    return tree_map(lambda l: ShapeDtype(tuple(as_tensor(l).shape),
                                         as_tensor(l).dtype), tree)


def tree_bytes(tree: Any) -> int:
    return sum(_nbytes(l) for l in tree_leaves(tree))
