"""Transformer layers, as pure functions over param dicts.

The port's counterpart of ``repro/models/layers.py``, for every path the
models take (the decoder stacks, the hybrid's shared block, the
encoder-decoder's encoder and cross-attention).  Where the reference attends through its blockwise jnp softmax and
normalises in jnp, the port calls the kernels of :mod:`repro_torch.kernels`
— on the card the hand-written CUDA kernels, on the CPU their plain
versions:

  * every RMS norm goes through ``kernels.rmsnorm``;
  * a one-token query against a cache goes through
    ``kernels.decode_attention`` (``valid_len = kv_valid_len``);
  * every other attention goes through ``kernels.flash_attention``, causal,
    with the query rows at ``q_offset = positions[:, 0]`` onwards and
    ``kv_len`` the number of valid keys, both per batch on the device, so
    a multi-token call at any cache position masks as the reference does;
    the encoder's self-attention and every cross-attention (a one-token
    decode step's too, at Sq = 1) go through it non-causal.

``multihead_attention(heads=)`` (a self- or cross-attention; a
self-attention also with its block of a placed cache) and
``apply_mlp(partial=True)`` are a tensor-parallel member's share of the
attention and of the MLP, which ``lm._attention_tp`` / ``lm._ffn_tp``
sum over a model group (``models/tp.py``) before :func:`mlp_bias`.

The matmuls stay ``torch.matmul``: they are products outside any kernel of
the reference.  So do LayerNorm (f32, biased variance, eps 1e-5), the qkv
biases (added before rope) and the non-gated MLP, whose GeLU is the tanh
approximation, ``jax.nn.gelu``'s default: no Pallas kernel of the
reference computes them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.decode_attention.ops import decode_mha
from ..kernels.flash_attention.ops import mha
from ..kernels.rmsnorm.ops import rmsnorm
from .specs import ParamSpec, torch_dtype


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, d: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones"),
                "bias": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def apply_norm(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        y = F.layer_norm(x.to(torch.float32), x.shape[-1:],
                         p["scale"].to(torch.float32),
                         p["bias"].to(torch.float32), eps=1e-5)
        return y.to(x.dtype)
    return rmsnorm(x, p["scale"].to(x.dtype), eps=1e-6)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs        # (...,S,half)
    sin = torch.sin(angles)[..., None, :]                           # (...,S,1,half)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional KV cache)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    """The projections; a cross-attention's (``cross``) are the same
    shapes, its keys and values projected from the encoder memory."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {"wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
         "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
         "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
         "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def _project(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, D) x (D, N, hd) [+ b (N, hd)] -> (B, S, N, hd)."""
    D, n, hd = w.shape
    y = (x @ w.to(x.dtype).reshape(D, n * hd)).unflatten(-1, (n, hd))
    return y if b is None else y + b.to(x.dtype)


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor, start: int = 0) -> None:
    """In place: token s of row b of ``new`` (B, S, KV, hd) goes to
    cache[b, pos[b] + s - start] of the block ``cache`` (B, S_blk, KV,
    hd), which holds the sequence's rows [start, start + S_blk) (the
    whole cache at ``start`` 0); a token outside the block writes
    nothing, as the reference's blend leaves it (past S_max: outside
    every block).  Nothing here reads ``pos`` on the host."""
    B, S = new.shape[:2]
    S_blk = cache.shape[1]
    new = new.to(cache.dtype)
    rows = torch.arange(B, device=cache.device)
    pos = pos.to(torch.long) - start
    if S == 1:
        at = pos.clamp(0, S_blk - 1)
        keep = ((pos >= 0) & (pos < S_blk))[:, None, None]
        cache[rows, at] = torch.where(keep, new[:, 0], cache[rows, at])
        return
    idx = pos[:, None] + torch.arange(S, device=cache.device)       # (B, S)
    inside = (idx >= 0) & (idx < S_blk)
    # every token outside the block is sent to its last row, carrying the
    # value that row ends with, so the colliding writes all agree
    t_last = S_blk - 1 - pos
    covers = (t_last >= 0) & (t_last < S)
    last = torch.where(covers[:, None, None],
                       new[rows, t_last.clamp(0, S - 1)],
                       cache[:, S_blk - 1])
    vals = torch.where(inside[:, :, None, None], new, last[:, None])
    cache[rows[:, None], torch.where(inside, idx, S_blk - 1)] = vals


def _self_qkv(cfg, p, x, positions):
    """Self-attention's q, k (both roped) and v, biases added first."""
    q = rope(_project(x, p["wq"], p.get("bq")), positions, cfg.rope_theta)
    k = rope(_project(x, p["wk"], p.get("bk")), positions, cfg.rope_theta)
    return q, k, _project(x, p["wv"], p.get("bv"))


def head_slice(cfg: ModelConfig, rank: int, count: int
               ) -> Tuple[int, int, int, int]:
    """Member ``rank`` of ``count`` that split the query heads: its query
    heads [h0, h1) and the kv heads [k0, k1) their groups read."""
    h = cfg.num_heads // count
    g = cfg.num_heads // cfg.num_kv_heads
    h0 = rank * h
    return h0, h0 + h, h0 // g, (h0 + h - 1) // g + 1


def _local_qkv(cfg, p, x, positions, heads, kv_x=None):
    """:func:`_self_qkv` for member ``heads = (rank, count)`` of a group
    that splits the heads: ``p``'s ``wq`` / ``bq`` are its block, and the
    replicated ``wk`` / ``wv`` / ``bk`` / ``bv`` are cut to the kv heads
    its query heads read.  With ``kv_x`` the cross-attention's: k and v
    projected from it, no biases on them and no rope on either side, as
    :func:`multihead_attention` projects a whole one.  k and v come back
    with one head a query head where the local heads do not map onto them
    as ``j // (h / kv)``."""
    k0, k1 = head_slice(cfg, *heads)[2:]
    kv = {n: p[n][..., k0:k1, :] for n in ("wk", "wv", "bk", "bv") if n in p}
    if kv_x is None:
        q = rope(_project(x, p["wq"], p.get("bq")), positions,
                 cfg.rope_theta)
        k = rope(_project(x, kv["wk"], kv.get("bk")), positions,
                 cfg.rope_theta)
        v = _project(x, kv["wv"], kv.get("bv"))
    else:
        q = _project(x, p["wq"], p.get("bq"))
        k, v = _project(kv_x, kv["wk"]), _project(kv_x, kv["wv"])
    return (q,) + _for_heads(cfg, heads, k, v)


def _for_heads(cfg: ModelConfig, heads: Tuple[int, int], k: torch.Tensor,
               v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v (B, S, k1 - k0, hd) of the kv heads [k0, k1) that member
    ``heads``'s query heads read (:func:`head_slice`), as the attention
    takes them: with one head a query head where the local heads do not
    map onto them as ``j // (h / kv)``."""
    h0, h1, k0, k1 = head_slice(cfg, *heads)
    g = cfg.num_heads // cfg.num_kv_heads
    h, n = h1 - h0, k1 - k0
    idx = [(h0 + j) // g - k0 for j in range(h)]
    if h % n or idx != [j // (h // n) for j in range(h)]:
        at = torch.tensor(idx, device=k.device)
        k, v = k.index_select(2, at), v.index_select(2, at)
    return k, v


def multihead_attention(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, *,
                        positions: torch.Tensor,
                        kv_cache: Optional[Dict[str, Any]] = None,
                        causal: bool = True,
                        kv_x: Optional[torch.Tensor] = None,
                        kv_valid_len: Optional[torch.Tensor] = None,
                        heads: Optional[Tuple[int, int]] = None,
                        kv_start: int = 0,
                        kv_seq: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """GQA attention.

    x: (B, S, D); positions: broadcastable to (B, S).  ``kv_x`` (B, S_src,
    D) switches to cross-attention: keys and values projected from it (no
    biases, no rope on either side), non-causal, every key valid, no cache.
    ``kv_cache`` {"k": (B, S_max, KV, hd), "v": ...} is written IN PLACE at
    ``positions`` (index writes, where the reference blends a new cache
    with ``where`` over all of S_max); the values equal the reference's.
    The returned cache holds the same tensors.

    ``heads = (rank, count)``: the self- or (with ``kv_x``)
    cross-attention of member ``rank`` of a tensor-parallel group of
    ``count`` (``models/tp.py``): ``p``'s ``wq`` / ``bq`` / ``wo`` are
    its block of the heads, the kv heads its heads read are cut from the
    replicated ones (:func:`head_slice`; a cross-attention's projected
    from the whole ``kv_x``), and the output is its partial sum over its
    heads, which the group sums.  With a ``kv_cache`` (a self-attention's
    placed prefill or decode, ``runtime/placed.py``) the cache is the
    member's block of the sequence, rows [``kv_start``, ``kv_start +
    S_blk``): the member projects k and v for every kv head and writes
    the tokens that fall in its block (:func:`_write_cache`), and attends
    its query heads over the whole sequence of the kv heads they read:
    the block itself where it is the whole sequence, else ``kv_seq``, the
    (k, v) of those heads over the whole sequence gathered from the
    group's blocks before this call, into which the new tokens are
    written too (every member projects the same k and v, so that equals
    gathering after the writes).
    """
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    offset = positions.expand(B, S)[:, 0]       # positions run offset + s

    new_cache = None
    if heads is not None and kv_cache is not None and kv_x is None:
        h = cfg.num_heads // heads[1]
        k0, k1 = head_slice(cfg, *heads)[2:]
        ck, cv = kv_cache["k"], kv_cache["v"]
        S_max = ck.shape[1] if kv_seq is None else kv_seq[0].shape[1]
        if S > S_max:
            raise ValueError(f"{S} tokens do not fit a {S_max}-token cache")
        q, k, v = _self_qkv(cfg, p, x, positions)
        _write_cache(ck, k, offset, kv_start)
        _write_cache(cv, v, offset, kv_start)
        new_cache = {"k": ck, "v": cv}
        if kv_seq is None:
            sk, sv = ck[:, :, k0:k1], cv[:, :, k0:k1]
        else:
            sk, sv = kv_seq
            _write_cache(sk, k[:, :, k0:k1], offset)
            _write_cache(sv, v[:, :, k0:k1], offset)
        sk, sv = _for_heads(cfg, heads, sk, sv)
        valid = kv_valid_len if kv_valid_len is not None else offset + S
        if S == 1:
            ctx = decode_mha(q, sk, sv, valid)
        else:
            ctx = mha(q, sk, sv, causal=causal, kv_len=valid,
                      q_offset=offset)
    elif heads is not None:
        h = cfg.num_heads // heads[1]
        q, k, v = _local_qkv(cfg, p, x, positions, heads, kv_x)
        if kv_x is not None:
            ctx = mha(q, k, v, causal=False, q_offset=offset)
        else:
            ctx = mha(q, k, v, causal=causal, kv_len=kv_valid_len,
                      q_offset=offset)
    elif kv_x is not None:
        q = _project(x, p["wq"], p.get("bq"))
        ctx = mha(q, _project(kv_x, p["wk"]), _project(kv_x, p["wv"]),
                  causal=False, q_offset=offset)
    elif kv_cache is None:
        q, k, v = _self_qkv(cfg, p, x, positions)
        ctx = mha(q, k, v, causal=causal, kv_len=kv_valid_len,
                  q_offset=offset)
    else:
        q, k, v = _self_qkv(cfg, p, x, positions)
        ck, cv = kv_cache["k"], kv_cache["v"]
        if S > ck.shape[1]:
            raise ValueError(f"{S} tokens do not fit a {ck.shape[1]}-token "
                             f"cache")
        _write_cache(ck, k, offset)
        _write_cache(cv, v, offset)
        new_cache = {"k": ck, "v": cv}
        valid = kv_valid_len if kv_valid_len is not None else offset + S
        if S == 1:
            ctx = decode_mha(q, ck, cv, valid)
        else:
            # the whole cache, masked per batch: the causal tile skip stops
            # each query tile at its last position
            ctx = mha(q, ck, cv, causal=causal, kv_len=valid,
                      q_offset=offset)

    out = ctx.reshape(B, S, h * hd) @ p["wo"].to(x.dtype).reshape(h * hd, -1)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        return {"w_gate": ParamSpec((d, f), ("embed", "mlp")),
                "w_up": ParamSpec((d, f), ("embed", "mlp")),
                "w_down": ParamSpec((f, d), ("mlp", "embed"))}
    return {"w_up": ParamSpec((d, f), ("embed", "mlp")),
            "b_up": ParamSpec((f,), ("mlp",), init="zeros"),
            "w_down": ParamSpec((f, d), ("mlp", "embed")),
            "b_down": ParamSpec((d,), ("embed",), init="zeros")}


def apply_mlp(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              partial: bool = False) -> torch.Tensor:
    """The MLP; with ``partial`` a tensor-parallel member's partial sum
    over its block of d_ff (``p``'s ``w_gate`` / ``w_up`` / ``b_up`` /
    ``w_down`` blocks), without ``b_down``, which the group adds once to
    the sum (:func:`mlp_bias`)."""
    if cfg.gated_mlp:
        gate = F.silu(x @ p["w_gate"].to(x.dtype))
        up = x @ p["w_up"].to(x.dtype)
        out = (gate * up) @ p["w_down"].to(x.dtype)
    else:
        h = x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype)
        # jax.nn.gelu's default is the tanh approximation, not the erf form
        h = F.gelu(h, approximate="tanh")
        out = h @ p["w_down"].to(x.dtype)
    return out if partial else mlp_bias(p, out)


def mlp_bias(p: Dict[str, Any], out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the MLP's ``b_down``, where it has one."""
    return out + p["b_down"].to(out.dtype) if "b_down" in p else out


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=0.02)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def embed_tokens(cfg: ModelConfig, p: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.to(torch.long)].to(dtype_of(cfg))


def unembed(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ w.to(x.dtype)).to(torch.float32)
