"""Decoder-only language models, families ``dense``, ``moe``, ``vlm``,
``ssm`` and ``hybrid``.

The port's counterpart of ``repro/models/lm.py``:

  dense   — [norm, GQA attn, norm, (Swi)GLU MLP] x L   (llama, granite,
            qwen, starcoder2)
  moe     — the MLP replaced by the top-k expert layer, with a dense MLP
            beside it where ``moe_dense_residual``   (moonshot, arctic)
  vlm     — the dense stack, with precomputed patch embeddings projected
            by ``vision_proj`` and prepended to the text   (phi-3-vision)
  ssm     — [norm, Mamba2 SSD] x L                         (mamba2)
  hybrid  — the Mamba2 stack plus one weight-SHARED attention block that
            runs before every ``attn_every``-th Mamba2 layer      (zamba2)

The same parameter tree paths (layers stacked on a leading axis under
``blocks``, the hybrid's ``shared_attn``) and the same cache layouts
(``(L, B, S_max, KV, hd)`` KV, ``(L, B, nh, hd, N)`` SSM states, ``(L, B,
W-1, di)`` conv tails, the hybrid's ``(napps, B, S_max, KV, hd)`` KV), so
the transfer ledgers of a serve state equal the reference's.  The layer
stack is a Python loop over the stacked axis where the reference scans.
``forward``'s aux loss is the MoE layers' load-balance losses summed (zero
for the other families).  With ``patches`` (B, P, d_model), a vlm forward
prepends their projection and returns logits over the text positions
only.  The encoder-decoder family is ``encdec.py``.

``loss_fn`` is the reference's cross-entropy (f32 ``log_softmax`` and
gather, labels below 0 masked, ``+ 0.01 * aux``), for every family: on
the card rmsnorm, flash and ``ssd_chunks`` are autograd Functions (the
kernel forward, the plain version's gradient backward).
``cfg.remat`` wraps every block (each attention block, each Mamba2
block and each application of the hybrid's shared block) in
``torch.utils.checkpoint`` when autograd records it (a param or the
input requires grad; a serving forward does not) (:func:`_remat`):
``full`` recomputes the whole block in the backward, ``dots`` saves the
matmul outputs (``aten.mm``, ``aten.addmm``: the dots without batch
dimensions that the reference's ``dots_with_no_batch_dims_saveable``
keeps) and recomputes the rest, the kernels included.

``loss_fn(..., group=)`` runs a model of any family here tensor-parallel
over a model group of a mesh, its members in lock step
(:func:`_forward_tp`, ``models/tp.py``; an encoder-decoder config goes
to ``encdec.loss_fn(group=)``): the production-mesh train step's path.
:func:`serve_tp` is prefill and decode the same way, each member on its
blocks of the cache: placed serving's path (``runtime/placed.py``).

``prefill`` and ``decode_step`` write the KV caches they are given in
place (see :func:`~repro_torch.models.layers.multihead_attention`; a
write at a fixed position repeats identically), and return new ``state``
and ``conv`` tensors, computed out of place, with a new ``pos``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt_lib

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..core.deepcopy import ShapeDtype
from ..core.treepath import tree_leaves, tree_map
from ..kernels import compute_dtype
from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from . import tp as TP
from .specs import (ParamSpec, abstract_params, init_params, param_axes,
                    torch_dtype)

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
ATTN_STACKS = ("dense", "moe", "vlm")   # the families of _run_attn_stack


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.is_encdec \
            or cfg.frontend not in ("none", "vision"):
        raise ValueError(
            f"lm.py does not build family {cfg.family!r} (frontend "
            f"{cfg.frontend!r}); it builds {FAMILIES}, and encdec.py the "
            f"encoder-decoder")


# ---------------------------------------------------------------------------
# parameter spec trees
# ---------------------------------------------------------------------------

def _stack(spec_tree: Any, n: int) -> Any:
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale, s.dtype), spec_tree)


def _attn_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    block = {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
             "ln2": L.norm_specs(cfg)}
    if cfg.family == "moe":
        block["moe"] = MOE.moe_specs(cfg)
        if cfg.moe_dense_residual:
            block["mlp"] = L.mlp_specs(cfg)
    else:
        block["mlp"] = L.mlp_specs(cfg)
    return block


def _ssm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": L.norm_specs(cfg), "ssm": SSM.ssm_specs(cfg)}


def spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    tree = {"embed": L.embed_specs(cfg), "final_norm": L.norm_specs(cfg)}
    if cfg.family in ATTN_STACKS:
        tree["blocks"] = _stack(_attn_block_specs(cfg), cfg.num_layers)
    else:
        tree["blocks"] = _stack(_ssm_block_specs(cfg), cfg.num_layers)
    if cfg.family == "hybrid":
        tree["shared_attn"] = _attn_block_specs(cfg)
    if cfg.frontend == "vision":
        tree["vision_proj"] = {
            "w": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed_out"))}
    return tree


def init(cfg: ModelConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Any:
    return init_params(spec_tree(cfg), generator, cfg.param_dtype, device)


def abstract(cfg: ModelConfig) -> Any:
    """The params' shapes and dtypes, without data."""
    return abstract_params(spec_tree(cfg), cfg.param_dtype)


def axes(cfg: ModelConfig) -> Any:
    """The params' logical axes (tuples), for the sharding rules."""
    return param_axes(spec_tree(cfg))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _n_shared_apps(cfg: ModelConfig) -> int:
    return -(-cfg.num_layers // cfg.attn_every) if cfg.attn_every else 0


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None, abstract_only: bool = False
               ) -> Dict[str, torch.Tensor]:
    """Serve-state tree: the pointer-chain tree the decode step touches;
    with ``abstract_only`` its :class:`ShapeDtype` leaves (no device, no
    data)."""
    _check_family(cfg)
    kv_dtype = torch_dtype(cfg.compute_dtype)
    if abstract_only:
        def zeros(*shape, dtype=kv_dtype):
            return ShapeDtype(tuple(shape), dtype)
    else:
        dev = resolve_device(device)

        def zeros(*shape, dtype=kv_dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

    kvhd = (cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"pos": zeros(batch, dtype=torch.int32)}
    if cfg.family in ATTN_STACKS:
        cache["k"] = zeros(cfg.num_layers, batch, max_seq, *kvhd)
        cache["v"] = zeros(cfg.num_layers, batch, max_seq, *kvhd)
        return cache
    cache["state"] = zeros(cfg.num_layers, batch, cfg.ssm_heads,
                           cfg.ssm_head_dim, cfg.ssm_state,
                           dtype=torch.float32)
    cache["conv"] = zeros(cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                          cfg.d_inner)
    if cfg.family == "hybrid":
        napps = _n_shared_apps(cfg)
        cache["k"] = zeros(napps, batch, max_seq, *kvhd)
        cache["v"] = zeros(napps, batch, max_seq, *kvhd)
    return cache


def kernel_launches(cfg: ModelConfig, prefills: int = 0, steps: int = 0,
                    train_steps: int = 0) -> Dict[str, int]:
    """Launches of each model kernel on the card for ``prefills`` prefill
    requests, ``steps`` decode steps and ``train_steps`` train steps: one
    rmsnorm per block norm plus the final one per forward (none for a
    LayerNorm model: LayerNorm is plain PyTorch); per attention block
    (every layer of a dense, MoE or vlm model, each application of the
    hybrid's shared block) one flash call per prefill and one decode call
    per step; one ssd_chunks call per Mamba2 layer per prefill (a decode
    step takes the recurrence).  The MoE layer and the vision projection
    launch no kernel of their own.  A train step runs one forward per
    micro-batch, and under remat the backward runs every block's forward
    again (its norms, flash and ssd_chunks, not the final norm); the
    backwards launch nothing."""
    _check_family(cfg)
    L = cfg.num_layers
    if cfg.family in ATTN_STACKS:
        attn, norms, ssd = L, 2 * L + 1, 0
    else:
        attn = _n_shared_apps(cfg) if cfg.family == "hybrid" else 0
        norms, ssd = L + 2 * attn + 1, L
    if cfg.norm != "rmsnorm":
        norms = 0
    forwards = train_steps * max(1, cfg.micro_batches)
    redo = forwards if cfg.remat != "none" else 0
    block_norms = norms - 1 if norms else 0
    return {"rmsnorm": norms * (prefills + steps + forwards)
            + block_norms * redo,
            "flash_attention": attn * (prefills + forwards + redo),
            "decode_attention": attn * steps,
            "ssd_chunks": ssd * (prefills + forwards + redo)}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

# the ops whose outputs "dots" remat keeps: matmuls without batch dims
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt_lib.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE)


def _records_grad(*trees) -> bool:
    """Whether autograd would record a call on these arguments."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for tree in trees for t in tree_leaves(tree))


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` when autograd records the call (as is
    otherwise: a forward for serving pays nothing): ``none`` as is,
    ``full`` a checkpoint of the whole call, ``dots`` a selective
    checkpoint that keeps the matmul outputs."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    context_fn = ckpt_lib.noop_context_fn
    if cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt_lib.create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args, **kwargs):
        if not _records_grad(args, kwargs):
            return fn(*args, **kwargs)
        return ckpt_lib.checkpoint(fn, *args, use_reentrant=False,
                                   context_fn=context_fn, **kwargs)
    return wrapped


def _attention(cfg, p, h, **kw):
    """The attention sublayer on the normed input ``h`` (``kw``:
    :func:`layers.multihead_attention`'s)."""
    return L.multihead_attention(cfg, p["attn"], h, **kw)[0]


def _ffn_parts(cfg, p, h, routing=None):
    """The MLP sublayer's terms on the normed input ``h``, ``b_down``
    left out: {"mlp": the MLP (dense, or moe's dense residual), "experts":
    the experts combined}, and the block's MoE aux loss (None for a block
    without experts).  A tensor-parallel member passes its inputs as they
    enter the regions: ``h`` as the MLP's, ``routing`` (:func:`moe.route`
    of its replicated input, with the input to dispatch and the gates as
    they entered) for the experts; each term is then its share of its region where the region
    splits (its blocks of d_ff).  Without ``routing`` the experts are
    :func:`moe.apply_moe` of ``h`` (expert-parallel under an active
    :mod:`pspec` context)."""
    parts, aux = {}, None
    if cfg.family == "moe":
        if routing is None:
            parts["experts"], aux = MOE.apply_moe(cfg, p["moe"], h)
            aux = aux["moe_aux_loss"]
        else:
            parts["experts"], aux = MOE.share(cfg, p["moe"], routing), \
                routing.aux
    if cfg.family != "moe" or cfg.moe_dense_residual:
        parts["mlp"] = L.apply_mlp(cfg, p["mlp"], h, partial=True)
    return parts, aux


def _ffn(cfg, p, h):
    """The MLP sublayer on the normed input ``h``: the MLP, or for moe the
    experts and the dense residual MLP; returns (out, the block's MoE aux
    loss, or None for a block without experts)."""
    parts, aux = _ffn_parts(cfg, p, h)
    out = parts.get("experts")
    if "mlp" in parts:
        mlp = L.mlp_bias(p["mlp"], parts["mlp"])
        out = mlp if out is None else out + mlp
    return out, aux


def _attn_block(cfg, p, x, *, positions, cache, kv_valid_len):
    """One attention block; returns (x, the block's MoE aux loss, or None
    for a block without experts)."""
    x = x + _attention(cfg, p, L.apply_norm(cfg, p["ln1"], x),
                       positions=positions, kv_cache=cache,
                       kv_valid_len=kv_valid_len)
    out, aux = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x))
    return x + out, aux


def _total(terms, start=None):
    """The sum of ``terms`` in order after ``start`` (None: nothing)."""
    for t in terms:
        start = t if start is None else start + t
    return start


def _attention_tp(cfg, group, ps, hs, *, positions, name="attn",
                  causal=True, kv_xs=None, caches=None, kv_split=False,
                  kv_valid_len=None):
    """The attention sublayer ``p[name]`` on the members of a
    tensor-parallel model group in lock step (``models/tp.py``): ``ps``,
    the normed inputs ``hs``, ``positions`` and a cross-attention's
    memory ``kv_xs`` (non-causal, every key valid: ``causal`` is for a
    self-attention) hold one entry a computed member.  Returns each
    member's output: the group's sum of the members' heads where
    ``group.heads``, else each member's whole attention.  The input enters the region (:func:`tp.enter`); so do
    the replicated kv projections (``wk``, ``wv``, ``bk``, ``bv``): a
    member reads only the kv heads its query heads use, so their
    gradients are the group's sum.  A cross-attention's memory does not
    enter here: its caller enters it once for every layer that reads it
    (``encdec._decode_stack_tp``).

    ``caches`` (a self-attention's placed prefill or decode) hold each
    member's {"k", "v"} block of the layer's cache, written in place, and
    ``kv_valid_len`` its valid lengths.  Where ``kv_split`` the blocks
    split the sequence over the group (member r holds rows [r * S_blk,
    (r + 1) * S_blk)): before the attention each member gathers, from
    every member's block, the kv heads its query heads read
    (:func:`_kv_seqs`), else its block is the whole sequence."""
    split = group.heads
    hs = TP.enter(group, hs, split)
    kv = [n for n in ("wk", "wv", "bk", "bv") if n in ps[0][name]]
    shared = [TP.enter(group, [p[name][n] for p in ps], split) for n in kv]
    mine = [dict(p[name], **{n: s[j] for n, s in zip(kv, shared)})
            for j, p in enumerate(ps)]
    none = [None] * len(hs)
    kv_xs = none if kv_xs is None else kv_xs
    seqs, starts = none, [0] * len(hs)
    if caches is not None and kv_split:
        seqs = _kv_seqs(cfg, group, caches)
        starts = [r * caches[0]["k"].shape[1] for r in group.ranks]
    caches = none if caches is None else caches
    kv_valid_len = none if kv_valid_len is None else kv_valid_len
    return TP.leave(group, [
        L.multihead_attention(cfg, a, h, positions=pos, kv_x=m,
                              causal=causal, heads=group.share(split, r),
                              kv_cache=c, kv_valid_len=v, kv_start=s0,
                              kv_seq=seq)[0]
        for r, a, h, pos, m, c, v, s0, seq in zip(
            group.ranks, mine, hs, positions, kv_xs, caches, kv_valid_len,
            starts, seqs)], split)


def _kv_seqs(cfg, group, caches):
    """Each computed member's (k, v) of the whole sequence of the kv heads
    its query heads read (``layers.head_slice``), gathered from the
    members' blocks of the sequence (their ``caches``' "k" and "v",
    (B, S_blk, KV, hd)) by one exchange over the group each
    (``ModelGroup.exchange``): (B, S_blk * size, k1 - k0, hd)."""
    cuts = [L.head_slice(cfg, *group.share(group.heads, j))[2:]
            for j in range(group.size)]
    return list(zip(*(group.exchange([[c[n][:, :, a:b] for a, b in cuts]
                                      for c in caches], axis=1)
                      for n in ("k", "v"))))


def _ffn_tp(cfg, group, ps, xs):
    """The MLP sublayer (``ln2``, then the MLP or for moe the experts and
    the dense residual MLP) with its residual on the members of a
    tensor-parallel model group in lock step: returns each member's (x,
    the block's MoE aux loss or None).  Each member runs its block of
    d_ff where ``group.mlp`` and of every expert's d_ff where
    ``group.experts``, the whole elsewhere.

    A MoE block routes each member's replicated normed input outside any
    region (the router, the gates and the aux loss: the router's weight
    does not enter, as the aux term's gradient is whole on every member),
    then that input (to be dispatched) and the gates enter the experts'
    region and each member runs its d_ff of every expert.  The split terms of
    the sublayer (the experts, the dense residual MLP) leave in one sum;
    a term whose region does not split is added whole after it, and
    ``b_down`` once, to the sum."""
    hs = [L.apply_norm(cfg, p["ln2"], x) for p, x in zip(ps, xs)]
    regions = {"mlp": group.mlp, "experts": group.experts}
    routings = [None] * len(hs)
    if cfg.family == "moe":
        routings = [MOE.route(cfg, p["moe"], h) for p, h in zip(ps, hs)]
        xs_in = TP.enter(group, hs, group.experts)
        gates = TP.enter(group, [r.gates for r in routings], group.experts)
        routings = [r._replace(x=x, gates=g)
                    for r, x, g in zip(routings, xs_in, gates)]
    hs = TP.enter(group, hs, group.mlp)
    terms = [_ffn_parts(cfg, p, h, r)
             for p, h, r in zip(ps, hs, routings)]
    auxs = [aux for _, aux in terms]
    outs = [None] * len(xs)
    if any(regions[k] for k in terms[0][0]):
        outs = TP.leave(group, [_total(v for k, v in t.items() if regions[k])
                                for t, _ in terms])
    outs = [_total((v for k, v in t.items() if not regions[k]), o)
            for (t, _), o in zip(terms, outs)]
    if "mlp" in terms[0][0]:
        outs = [L.mlp_bias(p["mlp"], o) for p, o in zip(ps, outs)]
    return [x + o for x, o in zip(xs, outs)], auxs


def _attn_block_tp(cfg, group, ps, xs, *, positions, caches=None,
                   kv_split=False, kv_valid_len=None):
    """:func:`_attn_block` on the members of a tensor-parallel
    model group in lock step (``models/tp.py``): ``ps``, ``xs`` and
    ``positions`` hold one entry a computed member (so do ``caches`` and
    ``kv_valid_len`` for placed serving: :func:`_attention_tp`).  Returns each
    member's (x, the block's MoE aux loss or None).  The norms and the
    residual stream run on every member's copy, and each sublayer on its
    share (``group.share``) between :func:`tp.enter` and
    :func:`tp.leave`: its block of the heads (:func:`_attention_tp`) or
    of d_ff (:func:`_ffn_tp`) where the region splits (``group.heads``,
    ``group.mlp``, ``group.experts``), the whole where it does not."""
    outs = _attention_tp(cfg, group, ps, [L.apply_norm(cfg, p["ln1"], x)
                                          for p, x in zip(ps, xs)],
                         positions=positions, caches=caches,
                         kv_split=kv_split, kv_valid_len=kv_valid_len)
    return _ffn_tp(cfg, group, ps, [x + o for x, o in zip(xs, outs)])


def _ssm_block(cfg, p, x, *, cache):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, new_cache = SSM.apply_ssm(cfg, p["ssm"], h, cache=cache)
    return x + out, new_cache


def _ssm_block_tp(cfg, group, ps, xs, caches=None):
    """:func:`_ssm_block` on the members of a tensor-parallel
    model group in lock step, as :func:`_attn_block_tp`: ``ps`` and
    ``xs`` one entry a computed member; returns each member's x (with
    ``caches``, each member's {"state", "conv"} of the layer, and each
    member's new cache: ``(xs, new caches)``).  ``ln1``
    and the residual stream run on every member's copy, the mixer on its
    share of the heads (``group.ssm``) between :func:`tp.enter` and
    :func:`tp.leave`: ``wz`` / ``wx`` / ``wdt`` column-parallel, ``wo``
    row-parallel.  ``wB`` and ``wC`` stay whole and enter the region, as
    the kv projections enter the attention: every head reads the one
    ``Bm`` / ``Cm``, so their gradients are the group's sum.  The gated
    RMSNorm's sum of squares over d_inner is the group's sum
    (:func:`tp.total`: its gradient too) divided by the whole
    ``d_inner``.  A member's cache is its heads' ``state`` and their
    channels' ``conv`` tail where the mixer splits, else the whole."""
    split = group.ssm
    hs = TP.enter(group, [L.apply_norm(cfg, p["ln1"], x)
                          for p, x in zip(ps, xs)], split)
    wB = TP.enter(group, [p["ssm"]["wB"] for p in ps], split)
    wC = TP.enter(group, [p["ssm"]["wC"] for p in ps], split)
    mine = [dict(p["ssm"], wB=b, wC=c) for p, b, c in zip(ps, wB, wC)]
    mixed = [SSM.mix(cfg, p, h, cache=c, heads=group.share(split, r))
             for r, p, h, c in zip(group.ranks, mine, hs,
                                   caches or [None] * len(hs))]
    ys = [y for y, _ in mixed]
    sums = TP.total(group, [y.to(compute_dtype(y.dtype)).square().sum(
        -1, keepdim=True) for y in ys], split)
    outs = TP.leave(group, [SSM.gated_out(p, y, s / cfg.d_inner)
                            for p, y, s in zip(mine, ys, sums)], split)
    xs = [x + o for x, o in zip(xs, outs)]
    return xs if caches is None else (xs, [c for _, c in mixed])


def _kv_slot(cache, i):
    return None if cache is None else {"k": cache["k"][i],
                                       "v": cache["v"][i]}


def _run_attn_stack(cfg, params, x, *, positions, cache, kv_valid_len):
    """The attention blocks in order (dense, moe); returns (x, cache, the
    MoE aux losses summed over layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(cfg, functools.partial(_attn_block, cfg))
    for i in range(cfg.num_layers):
        p = tree_map(lambda t: t[i], params["blocks"])
        x, block_aux = block(p, x, positions=positions,
                             cache=_kv_slot(cache, i),
                             kv_valid_len=kv_valid_len)
        if block_aux is not None:
            aux = aux + block_aux
    if cache is None:
        return x, None, aux
    return x, {"k": cache["k"], "v": cache["v"]}, aux


def _run_ssm_stack(cfg, params, x, *, positions, cache, kv_valid_len):
    """The Mamba2 blocks in order; for hybrid, the shared attention block
    runs before layer ``i`` when ``i % attn_every == 0``, on KV slot ``i //
    attn_every``.  Each block (and each shared-block application) is under
    ``cfg.remat``.  The new states and conv tails are stacked out of
    place."""
    hybrid = cfg.family == "hybrid"
    shared = _remat(cfg, functools.partial(_attn_block, cfg))
    block = _remat(cfg, functools.partial(_ssm_block, cfg))
    states, convs = [], []
    for i in range(cfg.num_layers):
        if hybrid and i % cfg.attn_every == 0:
            x, _ = shared(params["shared_attn"], x, positions=positions,
                          cache=_kv_slot(cache, i // cfg.attn_every),
                          kv_valid_len=kv_valid_len)
        p = tree_map(lambda t: t[i], params["blocks"])
        c = None if cache is None else {"state": cache["state"][i],
                                        "conv": cache["conv"][i]}
        x, new_c = block(p, x, cache=c)
        if new_c is not None:
            states.append(new_c["state"])
            convs.append(new_c["conv"])
    if cache is None:
        return x, None
    new_cache = ({"state": torch.stack(states), "conv": torch.stack(convs)}
                 if states else {"state": cache["state"],
                                 "conv": cache["conv"]})
    if hybrid:
        new_cache.update(k=cache["k"], v=cache["v"])
    return x, new_cache


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            patches: Optional[torch.Tensor] = None,
            kv_valid_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """tokens: (B, S) -> logits (B, S, V) f32, new_cache, aux_loss.  A vlm
    model's ``patches`` (B, P, d_model) are projected and prepended; the
    logits cover the S text positions only."""
    _check_family(cfg)
    B, S = tokens.shape
    x = L.embed_tokens(cfg, params["embed"], tokens)
    vision = cfg.frontend == "vision" and patches is not None
    if vision:
        pe = patches.to(x.dtype) @ params["vision_proj"]["w"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.family in ATTN_STACKS:
        x, new_cache, aux = _run_attn_stack(
            cfg, params, x, positions=positions, cache=cache,
            kv_valid_len=kv_valid_len)
    else:
        x, new_cache = _run_ssm_stack(cfg, params, x, positions=positions,
                                      cache=cache, kv_valid_len=kv_valid_len)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if vision:
        x = x[:, patches.shape[1]:]          # logits over text positions only
    logits = L.unembed(cfg, params["embed"], x)
    if new_cache is not None:
        new_cache["pos"] = cache["pos"] + S
    return logits, new_cache, aux


def _embed_tp(cfg: ModelConfig, group, params, tokens, patches=None):
    """Each member's input to the blocks: the vocab-parallel embedding
    (:func:`tp.embed`), a vlm's patches projected (``vision_proj``, whole
    on every member) and prepended."""
    xs = TP.embed(group, [p["embed"]["tok"] for p in params], tokens,
                  L.dtype_of(cfg))
    if cfg.frontend == "vision" and patches is not None:
        xs = [torch.cat([pt.to(x.dtype) @ p["vision_proj"]["w"].to(x.dtype),
                         x], dim=1)
              for p, pt, x in zip(params, patches, xs)]
    return xs


def _stack_tp(cfg: ModelConfig, group, params, xs, *, positions,
              caches=None, kv_split=False, kv_valid_len=None):
    """The blocks in order on the members of a tensor-parallel model
    group in lock step (every entry one a computed member); returns
    (xs, each member's MoE aux loss summed over the layers, each
    member's new {"state", "conv"} stacked, or None without ``caches``
    or Mamba2 layers).  The hybrid's shared block runs before layer ``i``
    when ``i % attn_every == 0``, as in :func:`_run_ssm_stack`, on KV slot
    ``i // attn_every``, each application entering and leaving its
    regions on its own (its leaves' gradients add up over the
    applications).  ``caches``: each member's cache blocks (the
    attention's k / v written in place, :func:`_attention_tp`)."""
    auxs = [torch.zeros((), dtype=torch.float32, device=x.device)
            for x in xs]
    block = _remat(cfg, functools.partial(_attn_block_tp, cfg, group))
    mixer = _remat(cfg, functools.partial(_ssm_block_tp, cfg, group))

    def attn(ps, xs, slot):
        return block(ps, xs, positions=positions, caches=None
                     if caches is None else [_kv_slot(c, slot)
                                             for c in caches],
                     kv_split=kv_split, kv_valid_len=kv_valid_len)

    mixed = [[] for _ in xs]
    for i in range(cfg.num_layers):
        ps = [tree_map(lambda t: t[i], p["blocks"]) for p in params]
        if cfg.family in ATTN_STACKS:
            xs, block_aux = attn(ps, xs, i)
            auxs = [a if b is None else a + b
                    for a, b in zip(auxs, block_aux)]
            continue
        if cfg.family == "hybrid" and i % cfg.attn_every == 0:
            xs, _ = attn([p["shared_attn"] for p in params], xs,
                         i // cfg.attn_every)
        if caches is None:
            xs = mixer(ps, xs)
            continue
        xs, new = mixer(ps, xs, [{"state": c["state"][i],
                                  "conv": c["conv"][i]} for c in caches])
        for m, c in zip(mixed, new):
            m.append(c)
    if not mixed[0]:
        return xs, auxs, None
    return xs, auxs, [{"state": torch.stack([c["state"] for c in m]),
                       "conv": torch.stack([c["conv"] for c in m])}
                      for m in mixed]


def _head_tp(cfg: ModelConfig, group, params, xs, patches=None):
    """The final norm and the head on each member: its f32 logits over
    the text positions, its block of the vocab where ``group.vocab``,
    else whole."""
    xs = [L.apply_norm(cfg, p["final_norm"], x) for p, x in zip(params, xs)]
    if cfg.frontend == "vision" and patches is not None:
        xs = [x[:, pt.shape[1]:] for x, pt in zip(xs, patches)]
    xs = TP.enter(group, xs, group.vocab)
    return [L.unembed(cfg, p["embed"], x) for p, x in zip(params, xs)]


def _forward_tp(cfg: ModelConfig, group, params, tokens, patches=None):
    """:func:`forward` (no cache) on the members of a tensor-parallel
    model group in lock step: ``params`` (each member's blocks of the
    split leaves, the others whole), ``tokens`` and a vlm model's
    ``patches`` one a computed member (:func:`_embed_tp`,
    :func:`_stack_tp`, :func:`_head_tp`).  Returns each member's f32
    logits over the text positions, its block of the vocab where
    ``group.vocab`` (the embedding vocab-parallel too), else whole, and
    its MoE aux loss summed over the layers."""
    xs = _embed_tp(cfg, group, params, tokens, patches)
    positions = [torch.arange(x.shape[1], device=x.device)[None, :]
                 for x in xs]
    xs, auxs, _ = _stack_tp(cfg, group, params, xs, positions=positions)
    return _head_tp(cfg, group, params, xs, patches), auxs


@torch.no_grad()
def serve_tp(cfg: ModelConfig, group, params, tokens, caches, *,
             patches=None, kv_split=False):
    """:func:`prefill` (``tokens`` (B, S), a vlm's ``patches`` first) or
    :func:`decode_step` (``tokens`` (B, 1)) on the members of a
    tensor-parallel model group in lock step, forward only: ``params``
    (each member's blocks of the split leaves, the others whole),
    ``tokens``, ``patches`` and ``caches`` one a computed member.  A
    member's cache holds its rows of the batch and, of each leaf the
    group splits, its block: the k / v sequence's where ``kv_split``
    (else the whole sequence, every member writing the same values), the
    Mamba2 ``state``'s heads and ``conv``'s channels where ``group.ssm``
    (else whole); ``pos`` whole.  The k / v blocks are written in place;
    returns each member's (B, 1, V) last-token logits (its vocab block
    where ``group.vocab``) and its new cache (``state`` / ``conv`` out of
    place, ``pos`` advanced)."""
    xs = _embed_tp(cfg, group, params, tokens, patches)
    S = xs[0].shape[1]
    pos = [c["pos"] for c in caches]
    positions = [torch.arange(S, device=p.device)[None, :] + p[:, None]
                 for p in pos]
    valid = [p + S for p in pos]
    xs, _, mixed = _stack_tp(cfg, group, params, xs, positions=positions,
                             caches=caches, kv_split=kv_split,
                             kv_valid_len=valid)
    logits = _head_tp(cfg, group, params, xs, patches)
    new = []
    for j, c in enumerate(caches):
        out = dict(c, pos=valid[j])
        if mixed is not None:
            out.update(mixed[j])
        new.append(out)
    return [x[:, -1:] for x in logits], new


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """The reference's masked mean NLL (f32 ``log_softmax`` and gather,
    labels below 0 masked) and the count of unmasked labels."""
    labels = labels.to(torch.long)
    mask = (labels >= 0).to(torch.float32)
    labels = labels.clamp_min(0)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss, torch.sum(mask)


def loss_fn(cfg: ModelConfig, params, batch, rng=None, group=None):
    """Cross-entropy LM loss.  batch: {"tokens", "labels"} (B, S) integer
    tensors on the params' device, and for a vlm model optionally
    "patches" (B, P, d_model).  Returns (loss + 0.01 * aux, metrics
    {"loss", "aux_loss", "tokens"}).

    With ``group`` (the model's tensor-parallel model group,
    ``models/tp.py``) ``params`` and ``batch`` hold one tree a computed
    member and so does what comes back: each member's copy of the loss
    (the cross-entropy vocab-parallel where ``group.vocab``, the aux loss
    each member's own, from its replicated routing)."""
    if group is not None:
        return _loss_tp(cfg, group, params, batch)
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             patches=batch.get("patches"))
    loss, tokens = cross_entropy(logits, batch["labels"])
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": tokens}


def _loss_tp(cfg: ModelConfig, group, params, batch):
    if cfg.family not in TP.FAMILIES:
        raise ValueError(f"tensor parallelism runs the families "
                         f"{TP.FAMILIES}, not {cfg.family!r}")
    if cfg.is_encdec:
        from . import encdec
        return encdec.loss_fn(cfg, params, batch, group=group)
    patches = [b.get("patches") for b in batch]
    logits, auxs = _forward_tp(cfg, group, params,
                               [b["tokens"] for b in batch],
                               None if patches[0] is None else patches)
    return _tp_losses(group, logits, batch, auxs)


def _tp_losses(group, logits, batch, auxs):
    """Each member's (loss + 0.01 * aux, metrics) from its logits (its
    vocab block where ``group.vocab``), its batch's labels and its aux
    loss."""
    ces = TP.cross_entropy(group, logits, [b["labels"] for b in batch])
    totals, metrics = [], []
    for (loss, tokens), aux in zip(ces, auxs):
        totals.append(loss + 0.01 * aux)
        metrics.append({"loss": loss, "aux_loss": aux, "tokens": tokens})
    return totals, metrics


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], *,
            patches: Optional[torch.Tensor] = None):
    """Fill the KV/SSM caches from a prompt, at any cache position (a vlm
    model's ``patches`` first); returns last-token logits."""
    S = tokens.shape[1] + (patches.shape[1] if patches is not None else 0)
    positions = torch.arange(S, device=tokens.device)[None, :] \
        + cache["pos"][:, None]
    valid = cache["pos"] + S
    logits, new_cache, _ = forward(cfg, params, tokens, positions=positions,
                                   cache=cache, patches=patches,
                                   kv_valid_len=valid)
    new_cache["pos"] = valid
    return logits[:, -1:], new_cache


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor]):
    """One token per sequence against the cache. tokens: (B, 1)."""
    positions = cache["pos"][:, None]
    valid = cache["pos"] + 1
    logits, new_cache, _ = forward(cfg, params, tokens, positions=positions,
                                   cache=cache, kv_valid_len=valid)
    new_cache["pos"] = valid
    return logits, new_cache
