"""The model-layout adapter of the blocked attention.

Counterpart of ``repro/kernels/flash_attention/ops.py::mha``: q (B, S, H,
hd), k/v (B, S, KV, hd) -> (B, S, H, hd).  The reference transposes to
(B, H, S, hd) and pads S to its (8, 128) blocks; here the transposes are
views (the kernel reads through strides and masks its own ragged edges),
so nothing is copied or padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, kv_len: Optional[torch.Tensor] = None,
        q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd); ``kv_len``
    and ``q_offset`` as :func:`~.kernel.flash_attention` takes them."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, kv_len=kv_len,
                          q_offset=q_offset)
    return out.transpose(1, 2)
