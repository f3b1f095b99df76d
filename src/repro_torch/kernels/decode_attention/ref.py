"""Plain PyTorch version of the single-token attention against a cache.

The semantics of ``repro/kernels/decode_attention/kernel.py`` (not of its
``ref.py``, which masks with -inf): f32 scores (float64 for float64
inputs: the arithmetic is in ``promote_types(dtype, float32)``), keys at
or past ``min(valid_len[b], S)`` masked with the finite ``NEG_INF =
-1e30``, output ``sum(p v) / max(sum(p), 1e-30)``.  With ``valid_len[b] == 0`` every score
is -1e30 and every probability 1, and the Pallas kernel divides
``sum(V[:S])`` by the keys of its padded blocks, ``ceil(S / bk) * bk`` with
``bk = min(block_k, S)``; this version does the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import compute_dtype

NEG_INF = -1e30


def empty_denominator(S: int, block_k: int = 512) -> int:
    """What the Pallas kernel divides by when no key is valid."""
    bk = min(block_k, S)
    return -(-S // bk) * bk


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len: torch.Tensor, *, scale: Optional[float] = None,
               block_k: int = 512) -> torch.Tensor:
    """q: (B, H, hd), k/v: (B, KV, S, hd), valid_len: (B,) -> (B, H, hd)."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    ct = compute_dtype(q.dtype)
    s = torch.einsum("bkgd,bksd->bkgs", q.to(ct).reshape(B, KV, g, hd),
                     k.to(ct)) * scale
    # lint: allow=DC201 -- the plain version puts the (B,) lengths beside q (a no-op when there)
    valid = valid_len.to(device=q.device, dtype=torch.long)
    mask = torch.arange(S, device=q.device)[None, :] < valid[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    den = torch.where((valid <= 0)[:, None, None, None],
                      float(empty_denominator(S, block_k)), den)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.to(ct)) / den
    return out.reshape(B, H, hd).to(q.dtype)


def decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     scale: Optional[float] = None, block_k: int = 512,
                     split: int = 256) -> torch.Tensor:
    """The CUDA kernel's split-KV algorithm, in plain PyTorch: the keys
    cut into ``split``-key splits; each split below ``min(valid_len[b],
    S)`` (every split when ``valid_len[b] == 0``, whose keys score the
    finite -1e30) gives an f32 partial (max, sum, accumulator) over its
    keys, keys past its end scoring -inf; the combine rescales the live
    partials to their common max, sums them and divides by the sum, or by
    ``empty_denominator`` for an empty row.  Same arguments as
    :func:`decode_ref`; used by the tests."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    nsplit = -(-S // split)
    pad = nsplit * split - S
    ct = compute_dtype(q.dtype)
    kf = torch.nn.functional.pad(k.to(ct), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(ct), (0, 0, 0, pad))
    s = torch.einsum("bkgd,bksd->bkgs", q.to(ct).reshape(B, KV, g, hd),
                     kf) * scale
    # lint: allow=DC201 -- the plain version puts the (B,) lengths beside q (a no-op when there)
    valid = valid_len.to(device=q.device, dtype=torch.long)
    empty = valid <= 0
    n_keys = torch.where(empty, S, valid.clamp(max=S))                # (B,)
    keys = torch.arange(nsplit * split, device=q.device)
    s = torch.where(empty[:, None, None, None], NEG_INF, s)
    s = torch.where((keys[None, :] < n_keys[:, None])[:, None, None, :], s,
                    -math.inf)
    s = s.reshape(B, KV, g, nsplit, split)
    live = (torch.arange(nsplit, device=q.device)[None, :] * split
            < n_keys[:, None])[:, None, None, :]                    # (B,1,1,n)
    m = torch.where(live, s.amax(dim=-1), 0.0)                       # partials
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgns,bknsd->bkgnd", p,
                       vf.reshape(B, KV, nsplit, split, hd))
    mx = torch.where(live, m, -math.inf).amax(dim=-1, keepdim=True)  # combine
    w = torch.where(live, torch.exp(m - mx), 0.0)
    den = (l * w).sum(dim=-1).clamp_min(1e-30)
    den = torch.where(empty[:, None, None],
                      float(empty_denominator(S, block_k)), den)
    out = (acc * w[..., None]).sum(dim=-2) / den[..., None]
    return out.reshape(B, H, hd).to(q.dtype)
