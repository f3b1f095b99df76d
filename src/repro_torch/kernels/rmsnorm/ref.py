"""Plain PyTorch version of the fused RMSNorm.

Counterpart of ``repro/kernels/rmsnorm/ref.py``: the mean of squares over
the last dim and the products in f32 (in ``promote_types(dtype,
float32)``: float64 stays float64), cast back to the input type.  The CPU
path of :func:`~repro_torch.kernels.rmsnorm.kernel.rmsnorm` runs it;
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from .. import compute_dtype


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    ct = compute_dtype(x.dtype)
    xf = x.to(ct)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(ct)).to(x.dtype)
