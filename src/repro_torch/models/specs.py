"""Parameter specs: one declaration site for shape, logical axes and init.

The port's counterpart of ``repro/models/specs.py``.  Models build a tree
of :class:`ParamSpec`; :func:`init_params` materializes it on a device from
an explicit ``torch.Generator``, :func:`abstract_params` gives its shapes
and dtypes and :func:`param_axes` its logical axes (the values are not ``jax.random``'s: tests
carry the reference's weights across with
:func:`repro_torch.convert.params_from_reference` instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..core.deepcopy import ShapeDtype
from ..core.treepath import tree_leaves, tree_map

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def torch_dtype(name: Any) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a ``torch.dtype``."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones
    scale: Optional[float] = None   # default: 1/sqrt(fan_in)
    dtype: Optional[torch.dtype] = None   # None -> model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec rank mismatch: {self.shape} vs {self.axes}")


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def _materialize(spec: ParamSpec, generator: torch.Generator,
                 param_dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    dtype = spec.dtype or param_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(1, spec.shape[-1])
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=device)
    return (draw * scale).to(dtype)


def init_params(spec_tree: Any, generator: torch.Generator,
                param_dtype: Any = torch.float32,
                device: DeviceLike = None) -> Any:
    """Materialize every spec on ``device`` (the card unless ``"cpu"``),
    drawing the normal inits from ``generator`` in leaf order.  The
    generator must live on that device."""
    dev = resolve_device(device)
    dtype = torch_dtype(param_dtype)
    return tree_map(lambda s: _materialize(s, generator, dtype, dev),
                    spec_tree)


def abstract_params(spec_tree: Any, param_dtype: Any = torch.float32) -> Any:
    """Every spec as a :class:`~repro_torch.core.deepcopy.ShapeDtype` (its
    shape and dtype, no data: the dry run's arguments)."""
    dtype = torch_dtype(param_dtype)
    return tree_map(lambda s: ShapeDtype(tuple(s.shape), s.dtype or dtype),
                    spec_tree)


def param_axes(spec_tree: Any) -> Any:
    """Every spec's logical axes: a tree of tuples, the sharding rules'
    input."""
    return tree_map(lambda s: tuple(s.axes), spec_tree)


def param_count(spec_tree: Any) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(spec_tree)))
