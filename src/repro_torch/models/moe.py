"""Mixture-of-Experts layer: top-k router and capacity-bucketed dispatch.

The port's counterpart of ``repro/models/moe.py`` on one device.  Expert
weights are stacked on a leading expert axis: the paper's Dense scenario
(an array of structures, fanout q = ``num_experts``) as real model state,
and top-k routing is selective deep copy over that array.

Per token the router takes a softmax over f32 logits and the top k of it,
and renormalises the k gates (``+ 1e-9``).  Each (token, choice) gets its
rank within its expert by a stable sort on the expert id; a rank at or
past the capacity C (:func:`capacity`) is dropped.  The kept rows go to an
(E, C, D) buffer, the experts run as three batched products (SwiGLU), and
each token sums its kept rows weighted by its gates.  The aux loss is
Switch's: E · Σ_e mean(probs)_e · share of tokens whose first choice is e.

Nothing here reads a device value on the host: counts are a
``scatter_add_``, not ``bincount`` (which reads its maximum back), and C
comes from the token count alone.  Each (expert, slot) receives at most
one kept row, so the dispatch is a plain index write, never an
accumulation; dropped rows go to one spare row past the buffer, which is
thrown away.  The products are ``torch.bmm``: the reference computes them
as einsums outside any kernel.

Divergence by design: ``torch.topk``'s order on exactly equal
probabilities is not specified on CUDA, where ``jax.lax.top_k`` prefers
the lower index.  The expert-parallel path of the reference
(``apply_moe_sharded``, ``shard_map``) is not ported: it needs more than
one device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .specs import ParamSpec


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, f), ("expert", "expert_embed", "expert_mlp")),
        "w_up": ParamSpec((e, d, f), ("expert", "expert_embed", "expert_mlp")),
        "w_down": ParamSpec((e, f, d), ("expert", "expert_mlp", "expert_embed")),
    }


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert for ``num_tokens`` tokens: capacity factor · k ·
    tokens / E, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.moe_capacity_factor * cfg.experts_per_token * num_tokens
            / max(1, cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def apply_moe_sharded(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                      mesh: Any, ep_axes: Any, tp_axes: Any):
    raise NotImplementedError(
        "expert-parallel MoE (the reference's shard_map path) is not yet "
        "ported to the PyTorch package: it needs more than one device")


def apply_moe(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D), {"moe_aux_loss": f32 scalar}."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * S
    C = capacity(cfg, N)
    xt = x.reshape(N, D)
    dev = x.device

    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)           # (N, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # Switch load-balance loss: the first choice's share per expert
    first = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, expert_ids[:, 0], torch.ones(N, dtype=torch.float32, device=dev))
    aux_loss = E * torch.sum(probs.mean(dim=0) * (first / N))

    # rank of each (token, choice) within its expert: stable sort by
    # expert, position in the sorted run, scattered back
    flat_expert = expert_ids.reshape(-1)                            # (N*K,)
    NK = flat_expert.shape[0]
    sorted_idx = torch.argsort(flat_expert, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_expert, torch.ones(NK, dtype=torch.long, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(NK, device=dev) - starts[flat_expert[sorted_idx]]
    pos = torch.empty_like(pos_sorted).scatter_(0, sorted_idx, pos_sorted)
    keep = pos < C

    # dispatch: kept rows to their (expert, slot), dropped rows to the
    # spare row E * C
    slot = torch.where(keep, flat_expert * C + pos,
                       torch.full_like(pos, E * C))
    src = xt.repeat_interleave(K, dim=0)                            # (N*K, D)
    buf = torch.zeros(E * C + 1, D, dtype=x.dtype, device=dev)
    buf.index_copy_(0, slot, src)
    buf = buf[:E * C].view(E, C, D)

    g = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype)))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    out_buf = torch.bmm(g * u, p["w_down"].to(x.dtype)).view(E * C, D)

    # combine: each token's kept rows, weighted by its gates
    gathered = out_buf[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered, 0)
    combined = (gathered.view(N, K, D)
                * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    return combined.view(B, S, D), {"moe_aux_loss": aux_loss}
