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
the lower index.

Expert parallelism (:func:`apply_moe_sharded`) runs the reference's
``shard_map`` body on every position of a named mesh, one controller
driving them (``core/collectives.py``); :func:`apply_moe` takes it under
an active :mod:`pspec` context whose ``expert`` rule divides the experts
and the batch (``_sharded_config``, as the reference's).

:func:`apply_moe` is :func:`route` (the router, the aux loss and each
row's slot of the (E, C, D) buffer) then :func:`share` (the dispatch,
the experts and the combine).  A tensor-parallel member of a model group
(``lm._attn_block_tp``, ``models/tp.py``) routes its replicated input
with :func:`route` and runs :func:`share` on its block of every expert's
d_ff, the input and the gates entering the region (the input as (B, S,
D), before the dispatch copies each row K times): its output is its
partial sum, which the group sums.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import collectives
from ..core.collectives import NamedMesh
from . import pspec
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


def _route_and_rank(cfg: ModelConfig, router_w: torch.Tensor,
                    xt: torch.Tensor):
    """Top-k routing of N tokens and each (token, choice)'s rank within
    its expert: (flat_expert (N*K,), pos (N*K,), gate_vals (N, K), aux)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    N = xt.shape[0]
    dev = xt.device
    logits = xt.to(torch.float32) @ router_w.to(torch.float32)
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
    return flat_expert, pos, gate_vals, aux_loss


def _slots(cfg: ModelConfig, flat_expert, pos, C: int) -> torch.Tensor:
    """Each (token, choice)'s row of the (E, C, D) buffer: its (expert,
    rank) where the rank is below C, else E * C (dropped)."""
    E = cfg.num_experts
    return torch.where(pos < C, flat_expert * C + pos,
                       torch.full_like(pos, E * C))


def _dispatch(cfg: ModelConfig, xt: torch.Tensor, slot, C: int):
    """Each token's row, once a choice, to its slot of an (E, C, D)
    buffer; dropped rows go to a spare row past it, thrown away."""
    E, K = cfg.num_experts, cfg.experts_per_token
    src = xt.repeat_interleave(K, dim=0)                            # (N*K, D)
    buf = torch.zeros(E * C + 1, xt.shape[1], dtype=xt.dtype,
                      device=xt.device)
    buf.index_copy_(0, slot, src)
    return buf[:E * C].view(E, C, -1)


def _experts(buf, w_gate, w_up, w_down):
    """The per-expert SwiGLU as three batched products."""
    g = F.silu(torch.bmm(buf, w_gate.to(buf.dtype)))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    return torch.bmm(g * u, w_down.to(buf.dtype))


def _combine(cfg: ModelConfig, out_buf, slot, gate_vals, N: int):
    """Each token's kept rows of the (E, C, D) buffer, weighted by its
    gates."""
    E, K = cfg.num_experts, cfg.experts_per_token
    D = out_buf.shape[-1]
    C = out_buf.shape[1]
    keep = slot < E * C
    gathered = out_buf.reshape(E * C, D)[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered, 0)
    return (gathered.view(N, K, D)
            * gate_vals[..., None].to(out_buf.dtype)).sum(dim=1)


def _tile(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def apply_moe_sharded(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                      mesh: NamedMesh, ep_axes: Any, tp_axes: Any
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert parallelism over ``ep_axes`` (and per-expert tensor
    parallelism over ``tp_axes``) of ``mesh``, single-controller: the
    reference's ``shard_map`` body run on every position with the
    collectives of :mod:`repro_torch.core.collectives`.

    Each position holds its ep slice of the batch and of the experts (and
    its tp slice of d_ff), moved there from the global tensors.  Per
    position: route and rank its tokens with the local capacity
    ``capacity(cfg, N_l)``, scatter them into an (E, C_l, D) buffer,
    ``all_to_all`` it to (E_l, n_ep * C_l, D), run the local experts (a
    ``psum`` over the tp axes when d_ff is split), ``all_to_all`` back,
    gather and combine.  The output is the positions' slices (those at tp
    index 0) concatenated on x's device; the aux loss is the ``pmean`` of
    the local aux losses over the ep axes (not the global one), position
    0's.  Autograd flows through every step to x and the weights."""
    ep = mesh.axes(ep_axes)
    tp = mesh.axes(tp_axes) if tp_axes else ()
    E, K = cfg.num_experts, cfg.experts_per_token
    B, S, D = x.shape
    n_ep = mesh.axis_size(ep)
    n_tp = mesh.axis_size(tp) if tp else 1
    if E % n_ep or B % n_ep:
        raise ValueError(f"{E} experts and a batch of {B} must split over "
                         f"{n_ep} expert-parallel positions")
    B_l = B // n_ep
    N_l = B_l * S
    C_l = capacity(cfg, N_l)
    auxs, bufs, local, routes = [], [], [], []
    for pos, dev in enumerate(mesh.positions):
        e = mesh.index(pos, ep)
        t = mesh.index(pos, tp) if tp else 0
        xt = _tile(x, 0, n_ep, e).to(dev).reshape(N_l, D)
        ws = (_tile(_tile(p["w_gate"], 0, n_ep, e), 2, n_tp, t).to(dev),
              _tile(_tile(p["w_up"], 0, n_ep, e), 2, n_tp, t).to(dev),
              _tile(_tile(p["w_down"], 0, n_ep, e), 1, n_tp, t).to(dev))
        flat_expert, rank, gate_vals, aux = _route_and_rank(
            cfg, p["router"].to(dev), xt)
        slot = _slots(cfg, flat_expert, rank, C_l)
        buf = _dispatch(cfg, xt, slot, C_l)
        bufs.append(buf)
        local.append(ws)
        routes.append((slot, gate_vals))
        auxs.append(aux)
    # dispatch: split E into the ep members' expert slices, concatenate
    # the slots by source member -> (E_l, n_ep * C_l, D)
    bufs = collectives.all_to_all(bufs, mesh, ep, split_axis=0,
                                  concat_axis=1)
    obs = [_experts(b, *ws) for b, ws in zip(bufs, local)]
    if tp:
        obs = collectives.psum(obs, mesh, tp)   # the partial d_ff sums
    obs = collectives.all_to_all(obs, mesh, ep, split_axis=1,
                                 concat_axis=0)                # (E, C_l, D)
    outs = [_combine(cfg, ob, slot, gates, N_l)
            for ob, (slot, gates) in zip(obs, routes)]
    aux = collectives.pmean(auxs, mesh, ep)
    rest = [a for a in mesh.axis_names if a not in ep]
    owners = sorted((pos for pos in range(mesh.size)
                     if not rest or mesh.index(pos, rest) == 0),
                    key=lambda pos: mesh.index(pos, ep))
    out = torch.cat([outs[pos].to(x.device) for pos in owners], dim=0)
    return out.view(B, S, D), {"moe_aux_loss": aux[0]}


def _sharded_config(cfg: ModelConfig, x: torch.Tensor):
    """The expert-parallel path's (mesh, ep axes, tp axes) when a
    :mod:`pspec` context with an ``expert`` rule is active and the experts
    and the batch divide over the ep axes (tp None where d_ff does not
    divide over it); else None."""
    rules = pspec.active_rules()
    if rules is None:
        return None
    mesh = pspec.active_mesh()
    ep = rules.get("expert")
    if not ep:
        return None
    ep = ep if isinstance(ep, tuple) else (ep,)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_ep = 1
    for ax in ep:
        n_ep *= sizes[ax]
    if cfg.num_experts % n_ep or x.shape[0] % n_ep:
        return None
    tp = rules.get("expert_mlp")
    if tp:
        tp = tp if isinstance(tp, tuple) else (tp,)
        n_tp = 1
        for ax in tp:
            n_tp *= sizes[ax]
        if cfg.d_ff % n_tp:
            tp = None
    return mesh, ep, tp


class Routing(NamedTuple):
    """One layer's routing of x (B, S, D): x itself (the rows the experts
    take), each (token, choice)'s slot of the (E, C, D) buffer (E * C
    where dropped), the renormalised gates (N, K) and the aux loss."""

    x: torch.Tensor
    slot: torch.Tensor
    gates: torch.Tensor
    aux: torch.Tensor


def route(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor) -> Routing:
    """Top-k routing of x's B·S tokens with the router ``p["router"]``,
    the aux loss, and each kept (token, choice)'s slot of the experts'
    buffer (capacity from the token count)."""
    B, S, D = x.shape
    flat_expert, pos, gate_vals, aux_loss = _route_and_rank(
        cfg, p["router"], x.reshape(B * S, D))
    slot = _slots(cfg, flat_expert, pos, capacity(cfg, B * S))
    return Routing(x, slot, gate_vals, aux_loss)


def share(cfg: ModelConfig, p: Dict[str, Any], r: Routing) -> torch.Tensor:
    """``r.x``'s rows dispatched to their slots, the experts on them,
    and the rows combined with ``r.gates``: (B, S, D).  On a
    tensor-parallel member's blocks of ``w_gate`` / ``w_up`` / ``w_down``
    (its d_ff of every expert), its partial sum."""
    B, S, D = r.x.shape
    N = B * S
    buf = _dispatch(cfg, r.x.reshape(N, D), r.slot, capacity(cfg, N))
    out_buf = _experts(buf, p["w_gate"], p["w_up"], p["w_down"])
    return _combine(cfg, out_buf, r.slot, r.gates, N).view(B, S, D)


def apply_moe(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D), {"moe_aux_loss": f32 scalar}.  Under a
    :mod:`pspec` context with an ``expert`` rule whose shapes divide, the
    expert-parallel :func:`apply_moe_sharded`."""
    sharded = _sharded_config(cfg, x)
    if sharded is not None:
        return apply_moe_sharded(cfg, p, x, *sharded)
    r = route(cfg, p, x)
    return share(cfg, p, r), {"moe_aux_loss": r.aux}
