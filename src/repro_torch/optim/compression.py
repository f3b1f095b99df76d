"""Gradient compression: int8 quantization with error feedback.

The port's copy of ``repro/optim/compression.py``: gradients are quantized
to int8 with a per-chunk float32 scale (4x fewer collective bytes), and
the quantization residual is carried in an error-feedback buffer so the
compression is unbiased over time.  Applied on the arena representation
(one contiguous buffer per dtype).  ``torch.round``, like ``jnp.round``,
rounds half to even, so the payloads equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

CHUNK = 2048  # elements per quantization scale


def _pad_to(x: torch.Tensor, m: int) -> torch.Tensor:
    pad = (-x.shape[0]) % m
    return F.pad(x, (0, pad)) if pad else x


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x: 1-D float -> (int8 values, per-chunk scales, original length)."""
    n = x.shape[0]
    xp = _pad_to(x.to(torch.float32), CHUNK).reshape(-1, CHUNK)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0], n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    xq = q.to(torch.float32).reshape(-1, CHUNK) * scale[:, None]
    return xq.reshape(-1)[:n]


def compress_with_feedback(grad_flat: torch.Tensor, error: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 payload, scales, new error buffer).

    new_error = (grad + error) - dequant(quant(grad + error))
    """
    corrected = grad_flat.to(torch.float32) + error
    q, scale, n = quantize_int8(corrected)
    approx = dequantize_int8(q, scale, n)
    return q, scale, corrected - approx


def init_error_buffers(arena_buffers: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((v.shape[0],), dtype=torch.float32,
                           device=v.device)
            for k, v in arena_buffers.items() if v.is_floating_point()}
