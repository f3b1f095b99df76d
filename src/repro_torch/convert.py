"""Carry trees between the JAX package's host form and the port's.

The reference registry builds nested containers of numpy arrays and numpy
scalars, with bf16 leaves as ``ml_dtypes.bfloat16`` arrays.  The port's
host trees hold torch CPU tensors (0-d tensors for scalars).  Both
functions keep the containers and the sorted dict key order; bf16 is
carried bit for bit through its 16-bit pattern.  This module imports
neither JAX nor ``ml_dtypes``: it reads only a dtype's name and itemsize.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import DeviceLike, resolve_device


def _leaf_to_torch(x: Any) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # resolved by name: the caller's process has registered bfloat16
        return t.view(torch.int16).numpy().copy().view(np.dtype("bfloat16"))
    return t.numpy().copy()


def _convert(tree: Any, leaf_fn) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(tree[k], leaf_fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_convert(c, leaf_fn) for c in tree]
    if isinstance(tree, tuple):
        return tuple(_convert(c, leaf_fn) for c in tree)
    if tree is None:
        return None
    return leaf_fn(tree)


def from_reference_tree(tree: Any) -> Any:
    """A reference (numpy) host tree as the port's (torch CPU) host tree."""
    return _convert(tree, _leaf_to_torch)


def to_reference_tree(tree: Any) -> Any:
    """A port host tree as numpy arrays (bf16 as the registered numpy
    ``bfloat16`` dtype, which the reference's process provides)."""
    return _convert(tree, lambda t: _leaf_to_numpy(torch.as_tensor(t)))


def params_from_reference(tree: Any, device: DeviceLike = None) -> Any:
    """The reference's parameter tree as numpy arrays (``jax.device_get``)
    as the port's tree on ``device`` (the card unless ``"cpu"``): the same
    paths, and the same values, bf16 bit for bit."""
    dev = resolve_device(device)
    return _convert(from_reference_tree(tree), lambda t: t.to(dev))


def train_state_from_reference(state: Any, device: DeviceLike = None) -> Any:
    """The reference's train state ``{"params", "opt", "step"}`` (numpy
    leaves, ``jax.device_get``) as the port's on ``device`` (the card
    unless ``"cpu"``): every leaf bit for bit, the step a 0-d tensor."""
    return params_from_reference(state, device)


def train_state_to_reference(state: Any) -> Any:
    """The port's train state as the reference's host tree (numpy arrays;
    0-d arrays for the step and the optimizer's count)."""
    return to_reference_tree(state)
