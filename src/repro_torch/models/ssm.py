"""Mamba2 — SSD (state-space duality) blocks: chunked scan and decode step.

The port's counterpart of ``repro/models/ssm.py``, with the same parameter
tree and the same simplifications (one B/C group; the depthwise causal
conv on the x-branch only).  Prefill and any multi-token call run the
chunked scan through :func:`repro_torch.kernels.ssd_scan.ops.
ssd_chunked_kernel`, so on the card every Mamba2 layer launches the
``ssd_chunks`` CUDA kernel once; the reference computes the same scan in
jnp.  The one-token decode step, the causal conv and the gated RMSNorm
stay plain torch, as the reference computes them outside any kernel.

:func:`apply_ssm` computes its new cache out of place and returns it (the
reference's contract), so a decode step that is retried after a fault
starts again from the same ``state`` and ``conv``.  It is two halves:
:func:`mix`, which a tensor-parallel member runs on its share of the
heads, and :func:`gated_out`, whose norm reads the whole d_inner's mean
square; between them a model group sums its members' squares
(``lm._ssm_block_tp``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..kernels import compute_dtype
from ..kernels.ssd_scan.ops import ssd_chunked_kernel
from .specs import ParamSpec, torch_dtype


def ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, w = cfg.ssm_heads, cfg.ssm_conv_width
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, n), ("embed", "ssm_state")),
        "wC": ParamSpec((d, n), ("embed", "ssm_state")),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads")),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "conv_w": ParamSpec((w, di), ("conv", "ssm_inner"), scale=0.5),
        "conv_b": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "out_norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv. x: (B, S, di), w: (W, di), cache: (B, W-1,
    di).  The reference's sum of W shifted products, in its order."""
    W = w.shape[0]
    if cache is not None:
        ext = torch.cat([cache.to(x.dtype), x], dim=1)       # (B, W-1+S, di)
        new_cache = ext[:, -(W - 1):]
    else:
        ext = F.pad(x, (0, 0, W - 1, 0))
        new_cache = None
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + ext[:, i:i + S] * w[i].to(x.dtype)
    out = out + b.to(x.dtype)
    return F.silu(out), new_cache


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  x: (B, nh, hd), dt: (B, nh), Bm/Cm: (B,
    N), state: (B, nh, hd, N) -> (y (B, nh, hd), new_state), out of
    place."""
    dA = torch.exp(dt * A[None, :])                              # (B, nh)
    dtx = x.float() * dt.float()[..., None]                      # (B, nh, hd)
    upd = dtx[..., None] * Bm.float()[:, None, None, :]          # (B,nh,hd,N)
    new_state = torch.addcmul(upd, state, dA[:, :, None, None])
    y = (new_state @ Cm.float()[:, None, :, None])[..., 0]       # (B, nh, hd)
    return y.to(x.dtype), new_state


def apply_ssm(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, *,
              cache: Optional[Dict[str, Any]] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """The full Mamba2 mixer. x: (B, S, D).  cache: {"state": (B, nh, hd,
    N) f32, "conv": (B, W-1, di)}; with a cache, S == 1 takes the recurrent
    step and a longer call the chunked scan from the cached state.  It is
    :func:`mix`, then :func:`gated_out` on the mean square of the whole
    d_inner."""
    y, new_cache = mix(cfg, p, x, cache=cache)
    yf = y.to(compute_dtype(y.dtype))
    return gated_out(p, y, yf.square().mean(-1, keepdim=True)), new_cache


def mix(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, *,
        cache: Optional[Dict[str, Any]] = None,
        heads: Tuple[int, int] = (0, 1)
        ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """The mixer up to its gated RMSNorm: the projections, the causal
    conv, the chunked scan (or the one-token step) and the gate; returns
    (y (B, S, di), the new cache or None).  ``heads`` = (index, count) is
    a tensor-parallel member's share: ``p`` holds its block of the head
    leaves (``wdt``, ``dt_bias``, ``A_log``, ``D``) and of the channel
    leaves (``wz``, ``wx``, ``conv_*``, ``out_norm``, ``wo``), its heads'
    channels, and it runs ``ssm_heads / count`` heads on ``d_inner /
    count`` channels (``wB`` / ``wC`` whole)."""
    B, S, _ = x.shape
    count = heads[1]
    nh, hd = cfg.ssm_heads // count, cfg.ssm_head_dim

    z = x @ p["wz"].to(x.dtype)
    xi = x @ p["wx"].to(x.dtype)
    dt = F.softplus(x.float() @ p["wdt"].float() + p["dt_bias"].float())
    Bm = x @ p["wB"].to(x.dtype)
    Cm = x @ p["wC"].to(x.dtype)
    A = -torch.exp(p["A_log"].float())

    conv_cache = cache.get("conv") if cache else None
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_cache)
    xh = xi.reshape(B, S, nh, hd)

    if cache is not None and S == 1:
        y, new_state = ssd_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                cache["state"])
        y = y[:, None]                                           # (B,1,nh,hd)
    else:
        init = cache["state"] if cache is not None else None
        # pad the sequence to a chunk multiple; the pad goes on dt AFTER the
        # softplus, so padded steps carry dt = 0 and the state passes
        # through unchanged (exp(0 * A) = 1, update dt * B x = 0)
        pad = (-S) % min(cfg.ssm_chunk, S) if S > 1 else 0
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        y, new_state = ssd_chunked_kernel(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                          init)
        if pad:
            y = y[:, :S]
            xh = xh[:, :S]

    y = y + xh * p["D"].float()[None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, nh * hd)
    new_cache = None
    if cache is not None:
        new_cache = {"state": new_state, "conv": new_conv}
    return y * F.silu(z), new_cache


def gated_out(p: Dict[str, Any], y: torch.Tensor, ms: torch.Tensor
              ) -> torch.Tensor:
    """The gated RMSNorm (mamba2 style, inline as in the reference) of
    :func:`mix`'s ``y`` given the mean square ``ms`` (B, S, 1) f32 of the
    whole d_inner, then the out projection; a tensor-parallel member's
    ``y`` and ``p`` are its channels, and its output a partial sum."""
    yf = y.to(compute_dtype(y.dtype))
    y = (yf * torch.rsqrt(ms + 1e-6)
         * p["out_norm"].to(yf.dtype)).to(y.dtype)
    return y @ p["wo"].to(y.dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: Any = torch.float32,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                            dtype=torch_dtype(dtype), device=dev),
    }
