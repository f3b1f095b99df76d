"""Plain PyTorch version of the SSD chunk kernel.

The math of ``repro/kernels/ssd_scan/ref.py::ssd_chunk_ref`` (and of the
Pallas kernel's ``_ssd_kernel``) over the whole (B, nc, nh) grid at once:

  * ``cum = cumsum(dtA)`` per (b, chunk, head), in f32 (every step here
    is in ``promote_types(x.dtype, float32)``: float64 stays float64);
  * ``y_diag = ((C Bᵀ) ∘ L) (dt·x)`` with ``L = tril(exp(cum_i - cum_j))``;
  * ``state = (dt·x)ᵀ (B ∘ exp(cum_last - cum))``.

It is two batched matmuls plus the masked ``exp``: ``C Bᵀ`` is formed once
per chunk (B and C are shared across heads) and broadcast over the heads,
so the largest temporaries are two (B, nc, nh, Q, Q) f32 tensors (about
1 GB each at B = 1, S = 16384, nh = 64, Q = 256); a three-way einsum would
build a (Q, Q, hd) product per tile instead.  Every op is out of place
after the mask, so autograd differentiates it.  The entries above the
diagonal are set to -inf before the ``exp``, so they are 0 and never
overflow.  The CPU path of
:func:`~repro_torch.kernels.ssd_scan.kernel.ssd_chunks` runs it, and on
the card its gradient is the kernel's backward; ``chip_smoke.py`` holds
the CUDA kernel against it on the card.

:func:`ssd_chunks_split_ref` is a CPU model of the bf16 tensor-core
kernel's arithmetic, for the tests and ``chip_smoke.py`` only (no path
runs it): the products take bf16 operands, so the f32 weighted scores P and
the state operand x·w are each split into ``hi = bf16(v)`` and ``lo =
bf16(v - hi)`` and both products summed, as the kernel does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import compute_dtype


def ssd_chunks_ref(x: torch.Tensor, dt: torch.Tensor, dtA: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, nc, nh, Q, hd), dt/dtA: (B, nc, nh, 1, Q), Bm/Cm: (B, nc, Q,
    N).  Returns y_diag (B, nc, nh, Q, hd) in x's dtype, states (B, nc, nh,
    hd, N) f32 and cum (B, nc, nh, 1, Q) f32 (float64 for a float64 x)."""
    Q = x.shape[3]
    ct = compute_dtype(x.dtype)
    cum = torch.cumsum(dtA[:, :, :, 0].to(ct), dim=-1)             # B,nc,nh,Q
    upper = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    L = (cum[..., :, None] - cum[..., None, :]).masked_fill_(upper,
                                                             float("-inf"))
    Bf, Cf = Bm.to(ct), Cm.to(ct)
    # out of place: autograd keeps exp's output for its backward
    L = torch.exp(L) * (Cf @ Bf.transpose(-1, -2))[:, :, None]    # (C Bᵀ) ∘ L
    dtx = x.to(ct) * dt[:, :, :, 0, :, None].to(ct)             # B,nc,nh,Q,hd
    y = L @ dtx
    del L
    decay = torch.exp(cum[..., -1:] - cum)                         # B,nc,nh,Q
    states = (dtx * decay[..., None]).transpose(-1, -2) @ Bf[:, :, None]
    return y.to(x.dtype), states, cum[:, :, :, None, :]


def _split_bf16(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 v -> (hi, lo), both bf16 values held in v's dtype, hi + lo ~
    v to ~16 significant bits."""
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype)


def ssd_chunks_split_ref(x: torch.Tensor, dt: torch.Tensor,
                         dtA: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, split_p: bool = True,
                         split_xw: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 kernel's arithmetic on :func:`ssd_chunks_ref`'s inputs and
    outputs: scores C Bᵀ in f32 from the inputs as they are; P = (C Bᵀ) ∘
    tril(exp(cum_i - cum_j)) ∘ dt_j and x·w with w = dt·exp(cum_last - cum)
    in f32; y = P_hi x + P_lo x and states = (x·w)_hiᵀ B + (x·w)_loᵀ B.
    ``split_p`` / ``split_xw`` False rounds that operand to one bf16
    instead, the design the kernel does not use (the tests show it fails
    the checks)."""
    Q = x.shape[3]
    ct = compute_dtype(x.dtype)
    cum = torch.cumsum(dtA[:, :, :, 0].to(ct), dim=-1)             # B,nc,nh,Q
    upper = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    P = (cum[..., :, None] - cum[..., None, :]).masked_fill_(upper,
                                                             float("-inf"))
    Bf, Cf = Bm.to(ct), Cm.to(ct)
    P.exp_().mul_((Cf @ Bf.transpose(-1, -2))[:, :, None])
    P.mul_(dt[:, :, :, 0, None, :].to(ct))                        # · dt_j
    xf = x.to(ct)
    if split_p:
        hi, lo = _split_bf16(P)
        y = hi @ xf + lo @ xf
    else:
        y = P.to(torch.bfloat16).to(ct) @ xf
    del P
    w = dt[:, :, :, 0].to(ct) * torch.exp(cum[..., -1:] - cum)    # B,nc,nh,Q
    xw = xf * w[..., None]
    Bh = Bf[:, :, None]
    if split_xw:
        hi, lo = _split_bf16(xw)
        states = hi.transpose(-1, -2) @ Bh + lo.transpose(-1, -2) @ Bh
    else:
        states = xw.to(torch.bfloat16).to(ct).transpose(-1, -2) @ Bh
    return y.to(x.dtype), states, cum[:, :, :, None, :]
