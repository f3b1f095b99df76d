"""Plain PyTorch version of the blocked GQA attention.

The semantics of ``repro/kernels/flash_attention/kernel.py`` (not of its
``ref.py``, which masks with -inf and knows no ``kv_len``): f32 scores
(float64 for float64 inputs: the arithmetic is in
``promote_types(dtype, float32)``),
keys at or past ``kv_len[b]`` masked, ``k_pos <= q_offset[b] + i`` for
query row ``i`` when causal, masked scores the finite ``NEG_INF = -1e30``,
and the output ``sum(p v) / max(sum(p), 1e-30)``.  Per-batch lengths are
clamped into [1, Sk] and offsets to >= 0, as the kernel clamps them.  The
CPU path of
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention` runs
it; ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import compute_dtype

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd), k/v: (B, KV, Sk, hd) -> (B, H, Sq, hd).
    ``kv_len`` and ``q_offset``: (B,) tensors, or None for Sk and 0."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = torch.full((B,), Sk, device=dev) if kv_len is None \
        else kv_len.to(dev, torch.long).clamp(1, Sk)
    off = torch.zeros(B, dtype=torch.long, device=dev) if q_offset is None \
        else q_offset.to(dev, torch.long).clamp_min(0)
    ct = compute_dtype(q.dtype)
    qf = q.to(ct).reshape(B, KV, g, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(ct)) * scale
    k_pos = torch.arange(Sk, device=dev)
    valid = (k_pos[None, None, :] < kv_len[:, None, None])          # (B,1,Sk)
    if causal:
        q_pos = off[:, None] + torch.arange(Sq, device=dev)          # (B,Sq)
        valid = valid & (k_pos[None, None, :] <= q_pos[:, :, None])
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(ct))
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def attention_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        q_offset: Optional[torch.Tensor] = None,
                        block_k: int = 64) -> torch.Tensor:
    """The CUDA kernels' numerics, tile by tile: an online softmax over
    ``block_k``-key tiles (running max, sum and accumulator in f32, the
    accumulator rescaled per tile), with P rounded to bf16 before P V when
    the inputs are bf16 (the tensor-core kernel's A operand; the sum takes
    P before rounding) and kept in f32 otherwise (the FMA kernel).  Same
    arguments and masks as :func:`attention_ref`; used by the tests, to
    hold the kernels' algorithm against the plain version and the Pallas
    kernel."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = torch.full((B,), Sk, device=dev) if kv_len is None \
        else kv_len.to(dev, torch.long).clamp(1, Sk)
    off = torch.zeros(B, dtype=torch.long, device=dev) if q_offset is None \
        else q_offset.to(dev, torch.long).clamp_min(0)
    round_p = q.dtype == torch.bfloat16
    ct = compute_dtype(q.dtype)
    qf = q.to(ct).reshape(B, KV, g, Sq, hd)
    q_pos = off[:, None] + torch.arange(Sq, device=dev)              # (B,Sq)
    m = torch.full((B, KV, g, Sq, 1), NEG_INF, dtype=ct, device=dev)
    l = torch.zeros((B, KV, g, Sq, 1), dtype=ct, device=dev)
    acc = torch.zeros((B, KV, g, Sq, hd), dtype=ct, device=dev)
    for k0 in range(0, Sk, block_k):
        kt = k[:, :, k0:k0 + block_k].to(ct)
        vt = v[:, :, k0:k0 + block_k].to(ct)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kt) * scale
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=dev)
        valid = k_pos[None, None, :] < kv_len[:, None, None]         # (B,1,n)
        if causal:
            valid = valid & (k_pos[None, None, :] <= q_pos[:, :, None])
        s = torch.where(valid[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if round_p:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bkgqs,bksd->bkgqd", p, vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, Sq, hd).to(q.dtype)
