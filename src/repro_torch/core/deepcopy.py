"""Full / selective deep-copy operations over trees of tensors (paper §2).

Counterpart of ``repro/core/deepcopy.py``: the per-leaf oracle the schemes
are held against — one plain copy per leaf, none of the engine's staging,
batching or delta machinery.  Both copies take an optional
:class:`~repro_torch.core.schemes.TransferLedger`; ``full_deepcopy`` also
places each leaf by a path-scoped policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from .._device import DeviceLike, resolve_device
from .arena import as_tensor
from .chainref import declare, extract, insert
from .policy import TransferPolicy
from .schemes import TransferLedger
from .treepath import (TreePath, leaf_paths, tree_flatten, tree_leaves,
                       tree_map)


def _nbytes(x: Any) -> int:
    t = as_tensor(x)
    return t.numel() * t.element_size()


def _copy_to(leaf: Any, device: torch.device,
             ledger: Optional[TransferLedger]) -> torch.Tensor:
    t = as_tensor(leaf)
    if ledger is not None:
        ledger.record_h2d(_nbytes(t))
    # always a real copy, also when device is the CPU
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def full_deepcopy(tree: Any, device: DeviceLike = None,
                  ledger: Optional[TransferLedger] = None,
                  policy: Any = None) -> Any:
    """Replicate the whole structure on the device (full deep copy).

    ``policy`` (a :class:`~repro_torch.core.policy.TransferPolicy` or policy
    string) places each leaf on its region's target, one plain copy per
    leaf: the card (``cuda:N`` for an ``@devN`` rule).  This is the value
    oracle a compiled program's pass is held against.  With a policy,
    ``device`` may only be ``"cpu"``, which puts every leaf on the CPU (the
    port's opt-in for running without a card); any other device raises, as
    the reference's placement arguments do."""
    if policy is None:
        dev = resolve_device(device)
        return tree_map(lambda leaf: _copy_to(leaf, dev, ledger), tree)
    if device is not None and torch.device(device).type != "cpu":
        raise ValueError("policy placement is exclusive with the device "
                         "argument (only device='cpu' is accepted)")
    policy = TransferPolicy.parse(policy)
    leaves, treedef = tree_flatten(tree)
    out = [_copy_to(leaf, resolve_device(device,
                                         policy.match(path).spec.device),
                    ledger)
           for path, leaf in zip(leaf_paths(tree), leaves)]
    return treedef.unflatten(out)


def selective_deepcopy(tree: Any, paths: Sequence[Union[str, TreePath]],
                       device: DeviceLike = None,
                       ledger: Optional[TransferLedger] = None) -> Any:
    """Move only the declared chains; everything else stays put (paper §2)."""
    dev = resolve_device(device)
    refs = declare(tree, *paths)
    moved = [_copy_to(leaf, dev, ledger) for leaf in extract(tree, refs)]
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
