"""Encoder-decoder LM (the seamless-m4t backbone).

The port's counterpart of ``repro/models/encdec.py``.  The audio frontend
is a stub: the caller supplies precomputed frame embeddings (B, S_src,
d_model).  The encoder is a non-causal transformer over the frames; the
decoder a causal one with cross-attention to the encoder's output.  The
same parameter tree paths (``enc_blocks`` and ``dec_blocks`` stacked on a
leading axis) and the same cache layout (``(L, B, S_max, KV, hd)`` KV,
``enc_out`` (B, max(1, S_max / src_ratio), d_model)), so the transfer
ledgers of a serve state equal the reference's.

On the card every attention goes through the hand-written kernels: the
encoder's self-attention and every cross-attention through
``flash_attention`` with ``causal=False`` (a one-token decode step's
cross-attention at Sq = 1), the decoder's self-attention through flash at
a prefill and ``decode_attention`` at a decode step.  LayerNorm, the GeLU
MLP and the tied embedding stay plain PyTorch, as in the decoder-only
models.  Every block runs under ``cfg.remat`` (:func:`lm._remat`) when
autograd records it.

``prefill`` encodes ``frames`` when given and otherwise reads the cache's
``enc_out``, as the reference does; the new cache carries the encoder
output it used.

``loss_fn(..., group=)`` runs the model tensor-parallel over a model
group of a mesh, its members in lock step (:func:`_forward_tp`,
``models/tp.py``): the production-mesh train step's path; :func:`serve_tp`
does so for a placed prefill or decode step (``runtime/placed.py``).
Each member computes its query heads of every self- and
cross-attention, its block of both stacks' d_ff and, where the vocab
splits, its rows of the tied embedding and its block of the logits; the
LayerNorms, the residual streams, ``wk`` / ``wv`` and the encoder memory
are whole on every member.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..core.deepcopy import ShapeDtype
from ..core.treepath import tree_map
from . import layers as L
from . import tp as TP
from .lm import (_attention_tp, _ffn_tp, _kv_slot, _remat, _stack,
                 _tp_losses, cross_entropy)
from .specs import abstract_params, init_params, param_axes, torch_dtype


def _check_family(cfg: ModelConfig) -> None:
    if not cfg.is_encdec:
        raise ValueError(f"encdec.py builds encoder-decoder models "
                         f"(enc_layers > 0), not {cfg.name!r}")


def spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    enc_block = {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
                 "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    dec_block = {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
                 "lnx": L.norm_specs(cfg),
                 "xattn": L.attention_specs(cfg, cross=True),
                 "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    return {
        "embed": L.embed_specs(cfg),
        "enc_blocks": _stack(enc_block, cfg.enc_layers),
        "dec_blocks": _stack(dec_block, cfg.num_layers),
        "enc_norm": L.norm_specs(cfg),
        "final_norm": L.norm_specs(cfg),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Any:
    return init_params(spec_tree(cfg), generator, cfg.param_dtype, device)


def abstract(cfg: ModelConfig) -> Any:
    """The params' shapes and dtypes, without data."""
    return abstract_params(spec_tree(cfg), cfg.param_dtype)


def axes(cfg: ModelConfig) -> Any:
    """The params' logical axes (tuples), for the sharding rules."""
    return param_axes(spec_tree(cfg))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None, abstract_only: bool = False
               ) -> Dict[str, torch.Tensor]:
    """The decoder's KV cache, its positions and the encoder memory; with
    ``abstract_only`` their :class:`ShapeDtype`s (no device, no data)."""
    _check_family(cfg)
    kv_dtype = torch_dtype(cfg.compute_dtype)
    if abstract_only:
        mk = lambda shape, dtype: ShapeDtype(tuple(shape), dtype)
    else:
        dev = resolve_device(device)
        mk = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    kvhd = (cfg.num_kv_heads, cfg.resolved_head_dim)
    src = max(1, max_seq // cfg.src_ratio)
    return {
        "pos": mk((batch,), torch.int32),
        "k": mk((cfg.num_layers, batch, max_seq) + kvhd, kv_dtype),
        "v": mk((cfg.num_layers, batch, max_seq) + kvhd, kv_dtype),
        # encoder memory, filled at prefill, read by cross-attention
        "enc_out": mk((batch, src, cfg.d_model), kv_dtype),
    }


def kernel_launches(cfg: ModelConfig, prefills: int = 0, steps: int = 0,
                    train_steps: int = 0, encodes: int = 0
                    ) -> Dict[str, int]:
    """Launches of each model kernel on the card: ``encodes`` of the
    ``prefills`` prefill requests had frames to encode (one flash per
    encoder layer); a prefill then runs one flash per decoder layer for the
    self-attention and one for the cross-attention, a decode step one
    decode_attention and one flash (the cross-attention at Sq = 1) per
    decoder layer.  A train step's forward (one per micro-batch) encodes
    and decodes, and under remat the backward runs every block's forward
    again.  rmsnorm: two per encoder block, three per decoder block, the
    encoder's and the final norm per forward, where ``cfg.norm`` is
    rmsnorm (seamless' is LayerNorm: none)."""
    _check_family(cfg)
    E, D = cfg.enc_layers, cfg.num_layers
    forwards = train_steps * max(1, cfg.micro_batches)
    redo = forwards if cfg.remat != "none" else 0
    rms = cfg.norm == "rmsnorm"
    enc_norms, dec_norms = (2 * E + 1, 3 * D + 1) if rms else (0, 0)
    return {"rmsnorm": enc_norms * (encodes + forwards)
            + dec_norms * (prefills + steps + forwards)
            + (enc_norms + dec_norms - 2 if rms else 0) * redo,
            "flash_attention": E * (encodes + forwards + redo)
            + 2 * D * (prefills + forwards + redo) + D * steps,
            "decode_attention": D * steps, "ssd_chunks": 0}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _enc_block(cfg, p, x, *, positions):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, _ = L.multihead_attention(cfg, p["attn"], h, positions=positions,
                                   causal=False)
    x = x + out
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h)


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_src, d_model) precomputed frontend embeddings ->
    the encoder memory (B, S_src, d_model) in the compute dtype."""
    x = frames.to(torch_dtype(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    block = _remat(cfg, functools.partial(_enc_block, cfg))
    for i in range(cfg.enc_layers):
        p = tree_map(lambda t: t[i], params["enc_blocks"])
        x = block(p, x, positions=positions)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _dec_block(cfg, p, x, enc_out, *, positions, cache, kv_valid_len):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, _ = L.multihead_attention(cfg, p["attn"], h, positions=positions,
                                   kv_cache=cache, kv_valid_len=kv_valid_len)
    x = x + out
    h = L.apply_norm(cfg, p["lnx"], x)
    out, _ = L.multihead_attention(cfg, p["xattn"], h, positions=positions,
                                   kv_x=enc_out)
    x = x + out
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h)


def _decode_stack(cfg, params, x, enc_out, *, positions, cache,
                  kv_valid_len):
    """The decoder blocks in order, each writing its KV slot in place."""
    block = _remat(cfg, functools.partial(_dec_block, cfg))
    for i in range(cfg.num_layers):
        p = tree_map(lambda t: t[i], params["dec_blocks"])
        x = block(p, x, enc_out, positions=positions,
                  cache=_kv_slot(cache, i), kv_valid_len=kv_valid_len)
    return x


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            frames: torch.Tensor) -> Tuple[torch.Tensor, None, torch.Tensor]:
    """Teacher-forced logits: tokens (B, S) and frames (B, S_src, d_model)
    -> logits (B, S, V) f32, no cache, aux loss 0 (``loss_fn``'s
    forward)."""
    _check_family(cfg)
    enc_out = encode(cfg, params, frames)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _decode_stack(cfg, params, x, enc_out, positions=positions,
                      cache=None, kv_valid_len=None)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return (L.unembed(cfg, params["embed"], x), None,
            torch.zeros((), dtype=torch.float32, device=x.device))


def _enc_block_tp(cfg, group, ps, xs, *, positions):
    """:func:`_enc_block` on the members of a tensor-parallel model group
    in lock step (``models/tp.py``): ``ps``, ``xs`` and ``positions`` one
    entry a computed member; returns each member's x.  The non-causal
    self-attention on the member's query heads and the MLP on its block
    of d_ff, each between :func:`tp.enter` and :func:`tp.leave`
    (``lm._attention_tp``, ``lm._ffn_tp``; ``b_down`` once after the
    sum).  The first block's input, the frames, takes no gradient, but
    its normed input does (``ln1``'s scale and bias read it), so the
    attention's entry sums in the backward in every block, the first's
    too."""
    outs = _attention_tp(cfg, group, ps, [L.apply_norm(cfg, p["ln1"], x)
                                          for p, x in zip(ps, xs)],
                         positions=positions, causal=False)
    xs = [x + o for x, o in zip(xs, outs)]
    return _ffn_tp(cfg, group, ps, xs)[0]


def _encode_tp(cfg, group, params, frames):
    """:func:`encode` on the members of a tensor-parallel model group:
    each member's memory, whole."""
    xs = [f.to(torch_dtype(cfg.compute_dtype)) for f in frames]
    positions = [torch.arange(x.shape[1], device=x.device)[None, :]
                 for x in xs]
    block = _remat(cfg, functools.partial(_enc_block_tp, cfg, group))
    for i in range(cfg.enc_layers):
        ps = [tree_map(lambda t: t[i], p["enc_blocks"]) for p in params]
        xs = block(ps, xs, positions=positions)
    return [L.apply_norm(cfg, p["enc_norm"], x) for p, x in zip(params, xs)]


def _dec_block_tp(cfg, group, ps, xs, enc_outs, *, positions, caches=None,
                  kv_split=False, kv_valid_len=None):
    """:func:`_dec_block` on the members of a tensor-parallel model group
    in lock step: the causal self-attention and the cross-attention on
    the member's query heads, the MLP on its block of d_ff
    (``lm._attention_tp``, ``lm._ffn_tp``).  The cross-attention's keys
    and values are projected from the member's whole copy of the memory
    ``enc_outs``, which has already entered the region
    (:func:`_decode_stack_tp`).  ``caches``, ``kv_split`` and
    ``kv_valid_len`` (placed prefill and decode: each member's {"k", "v"}
    block of the layer's cache and its valid lengths) go to the
    self-attention alone: the cross-attention is uncached, non-causal,
    and every frame is valid."""
    outs = _attention_tp(cfg, group, ps, [L.apply_norm(cfg, p["ln1"], x)
                                          for p, x in zip(ps, xs)],
                         positions=positions, caches=caches,
                         kv_split=kv_split, kv_valid_len=kv_valid_len)
    xs = [x + o for x, o in zip(xs, outs)]
    outs = _attention_tp(cfg, group, ps, [L.apply_norm(cfg, p["lnx"], x)
                                          for p, x in zip(ps, xs)],
                         positions=positions, name="xattn", kv_xs=enc_outs)
    xs = [x + o for x, o in zip(xs, outs)]
    return _ffn_tp(cfg, group, ps, xs)[0]


def _decode_stack_tp(cfg, group, blocks, xs, enc_outs, *, positions,
                     caches=None, kv_split=False, kv_valid_len=None):
    """:func:`_decode_stack` on the members of a tensor-parallel model
    group: ``blocks`` each member's stacked ``dec_blocks``, ``caches``
    (placed serving) each member's cache blocks, layer ``i`` reading its
    slot of them (:func:`_dec_block_tp`).  Each member's cross-attentions
    read only its kv heads' slice of the memory, so its gradient of the
    memory is partial.
    The memory enters the heads' region once here, for every layer: the
    backward sums the members' gradients, each already summed over the
    layers, in one ``psum`` where one a layer would take ``num_layers``.
    Once is exact: the sum is linear, and the memory has no consumer
    outside the split cross-attentions, so nothing else adds a whole
    gradient to it that the group would count T times."""
    enc_outs = TP.enter(group, enc_outs, group.heads)
    block = _remat(cfg, functools.partial(_dec_block_tp, cfg, group))
    for i in range(cfg.num_layers):
        ps = [tree_map(lambda t: t[i], b) for b in blocks]
        xs = block(ps, xs, enc_outs, positions=positions, caches=None
                   if caches is None else [_kv_slot(c, i) for c in caches],
                   kv_split=kv_split, kv_valid_len=kv_valid_len)
    return xs


def _forward_tp(cfg: ModelConfig, group, params, tokens, frames):
    """:func:`forward` on the members of a tensor-parallel model group in
    lock step: ``params`` (each member's blocks of the split leaves, the
    others whole), ``tokens`` and ``frames`` one a computed member.
    Returns each member's f32 logits, its block of the vocab where
    ``group.vocab`` (the embedding vocab-parallel too), else whole."""
    enc_outs = _encode_tp(cfg, group, params, frames)
    xs = TP.embed(group, [p["embed"]["tok"] for p in params], tokens,
                  L.dtype_of(cfg))
    positions = [torch.arange(x.shape[1], device=x.device)[None, :]
                 for x in xs]
    xs = _decode_stack_tp(cfg, group, [p["dec_blocks"] for p in params],
                          xs, enc_outs, positions=positions)
    xs = [L.apply_norm(cfg, p["final_norm"], x) for p, x in zip(params, xs)]
    xs = TP.enter(group, xs, group.vocab)
    return [L.unembed(cfg, p["embed"], x) for p, x in zip(params, xs)]


def loss_fn(cfg: ModelConfig, params, batch, rng=None, group=None):
    """batch: {"frames": (B, S_src, D), "tokens": (B, S), "labels": (B,
    S)}.  Returns (loss, metrics {"loss", "aux_loss" (0), "tokens"}).

    With ``group`` (the model's tensor-parallel model group,
    ``models/tp.py``) ``params`` and ``batch`` hold one tree a computed
    member and so does what comes back: each member's copy of the loss
    (the cross-entropy vocab-parallel where ``group.vocab``)."""
    if group is not None:
        _check_family(cfg)
        logits = _forward_tp(cfg, group, params,
                             [b["tokens"] for b in batch],
                             [b["frames"] for b in batch])
        return _tp_losses(group, logits, batch, [
            torch.zeros((), dtype=torch.float32, device=x.device)
            for x in logits])
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             frames=batch["frames"])
    loss, tokens = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss, "aux_loss": aux, "tokens": tokens}


@torch.no_grad()
def serve_tp(cfg: ModelConfig, group, params, tokens, caches, *,
             frames=None, kv_split=False):
    """:func:`prefill` (``tokens`` (B, S), with or without ``frames``) or
    :func:`decode_step` (``tokens`` (B, 1)) on the members of a
    tensor-parallel model group in lock step, forward only, as
    ``lm.serve_tp``: ``params`` (each member's blocks of the split
    leaves, the others whole), ``tokens``, ``frames`` and ``caches`` one
    a computed member.  The encoder runs where ``frames`` are given
    (:func:`_encode_tp`: each member ends with the whole memory of its
    rows), else each member reads its cache's ``enc_out``, which is
    whole on every member.  A member's cache holds its rows of the batch
    and its block of the k / v sequence where ``kv_split`` (else the
    whole sequence), written in place; returns each member's (B, 1, V)
    last-token logits (its vocab block where ``group.vocab``) and its
    new cache (``pos`` advanced, ``enc_out`` the memory used, in the
    cache's dtype)."""
    _check_family(cfg)
    if frames is None:
        enc_outs = [c["enc_out"] for c in caches]
    else:
        enc_outs = _encode_tp(cfg, group, params, frames)
        for e, c in zip(enc_outs, caches):
            if e.shape != c["enc_out"].shape:
                raise ValueError(f"frames encode to a {tuple(e.shape)} "
                                 f"memory, the cache holds "
                                 f"{tuple(c['enc_out'].shape)}")
    xs = TP.embed(group, [p["embed"]["tok"] for p in params], tokens,
                  L.dtype_of(cfg))
    S = xs[0].shape[1]
    pos = [c["pos"] for c in caches]
    positions = [torch.arange(S, device=p.device)[None, :] + p[:, None]
                 for p in pos]
    valid = [p + S for p in pos]
    xs = _decode_stack_tp(cfg, group, [p["dec_blocks"] for p in params],
                          xs, enc_outs, positions=positions, caches=caches,
                          kv_split=kv_split, kv_valid_len=valid)
    xs = [L.apply_norm(cfg, p["final_norm"], x[:, -1:])
          for p, x in zip(params, xs)]
    xs = TP.enter(group, xs, group.vocab)
    logits = [L.unembed(cfg, p["embed"], x) for p, x in zip(params, xs)]
    return logits, [dict(c, pos=v, enc_out=e.to(c["enc_out"].dtype))
                    for c, v, e in zip(caches, valid, enc_outs)]


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], *,
            frames: Optional[torch.Tensor] = None):
    """Encode ``frames`` (or read the cache's ``enc_out``) and fill the
    decoder's self-attention cache from a prompt at any cache position;
    returns last-token logits and the new cache, whose ``enc_out`` is the
    memory used (in the cache's dtype)."""
    _check_family(cfg)
    S = tokens.shape[1]
    enc_out = (encode(cfg, params, frames) if frames is not None
               else cache["enc_out"])
    positions = torch.arange(S, device=tokens.device)[None, :] \
        + cache["pos"][:, None]
    valid = cache["pos"] + S
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = _decode_stack(cfg, params, x, enc_out, positions=positions,
                      cache=cache, kv_valid_len=valid)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.unembed(cfg, params["embed"], x)
    return logits, {"pos": valid, "k": cache["k"], "v": cache["v"],
                    "enc_out": enc_out.to(cache["enc_out"].dtype)}


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor]):
    """One token per sequence against the cache. tokens: (B, 1)."""
    _check_family(cfg)
    positions = cache["pos"][:, None]
    valid = cache["pos"] + 1
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = _decode_stack(cfg, params, x, cache["enc_out"], positions=positions,
                      cache=cache, kv_valid_len=valid)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    return logits, {"pos": valid, "k": cache["k"], "v": cache["v"],
                    "enc_out": cache["enc_out"]}
