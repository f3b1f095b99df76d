"""The model-layout adapter of the decode attention.

Counterpart of ``repro/kernels/decode_attention/ops.py::decode_mha``: q
(B, 1, H, hd) against one layer of the cache, (B, S, KV, hd).  The
reference transposes the whole cache to (B, KV, S, hd) on every call —
twice the cache's bytes per layer per step; here the transposes are views
and the kernel reads the cache in place through its strides.
"""
from __future__ import annotations

import torch

from .kernel import decode_attention


def decode_mha(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               valid_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, KV, hd); valid_len: (B,) ->
    (B, 1, H, hd)."""
    out = decode_attention(q[:, 0], k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), valid_len)
    return out[:, None]
