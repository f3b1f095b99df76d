"""The decoder-only language model, family ``dense``.

The port's counterpart of ``repro/models/lm.py`` for ``[norm, GQA attn,
norm, SwiGLU MLP] x L``: the same parameter tree paths (layers stacked on a
leading axis under ``blocks``) and the same ``(L, B, S_max, KV, hd)`` cache
layout, so the transfer ledgers of a serve state equal the reference's.
The layer stack is a Python loop over the stacked axis where the reference
scans.  The moe, ssm, hybrid and vision families are not yet ported, and
``loss_fn`` waits for training.

``prefill`` and ``decode_step`` write the KV cache they are given in place
(see :func:`~repro_torch.models.layers.multihead_attention`) and return it
with a new ``pos``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..core.treepath import tree_map
from . import layers as L
from .specs import ParamSpec, init_params, torch_dtype


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.frontend != "none" or cfg.is_encdec:
        raise NotImplementedError(
            f"model family {cfg.family!r} (frontend {cfg.frontend!r}) is not "
            f"yet ported to the PyTorch package; only 'dense' is")


# ---------------------------------------------------------------------------
# parameter spec trees
# ---------------------------------------------------------------------------

def _stack(spec_tree: Any, n: int) -> Any:
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale, s.dtype), spec_tree)


def spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    block = {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
             "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    return {"embed": L.embed_specs(cfg), "final_norm": L.norm_specs(cfg),
            "blocks": _stack(block, cfg.num_layers)}


def init(cfg: ModelConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Any:
    return init_params(spec_tree(cfg), generator, cfg.param_dtype, device)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Serve-state tree: the pointer-chain tree the decode step touches."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    kv_dtype = torch_dtype(cfg.compute_dtype)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _attn_block(cfg, p, x, *, positions, cache, kv_valid_len):
    h = L.apply_norm(cfg, p["ln1"], x)
    attn_out, _ = L.multihead_attention(cfg, p["attn"], h, positions=positions,
                                        kv_cache=cache,
                                        kv_valid_len=kv_valid_len)
    x = x + attn_out
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            kv_valid_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """tokens: (B, S) -> logits (B, S, V) f32, new_cache, aux_loss."""
    _check_family(cfg)
    B, S = tokens.shape
    x = L.embed_tokens(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        p = tree_map(lambda t: t[i], blocks)
        layer_cache = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        x = _attn_block(cfg, p, x, positions=positions, cache=layer_cache,
                        kv_valid_len=kv_valid_len)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + S}
    return logits, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor]):
    """Fill the KV cache from a prompt; returns last-token logits."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :] \
        + cache["pos"][:, None]
    valid = cache["pos"] + S
    logits, new_cache, _ = forward(cfg, params, tokens, positions=positions,
                                   cache=cache, kv_valid_len=valid)
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
