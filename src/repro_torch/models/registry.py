"""Model registry: one uniform API over the ported families.

The port's counterpart of ``repro/models/registry.py``.  ``get_model(cfg)``
returns a :class:`ModelApi` whose methods close over the config.  Every id
of the reference's registry is known here; the ids in :data:`PORTED` are
the ones whose configurations and families are ported (dense, moe, ssm
and hybrid), and the vlm ``phi-3-vision-4.2b`` and the encdec
``seamless-m4t-medium`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from ..configs.base import ModelConfig
from . import lm

ARCH_IDS = (
    "seamless-m4t-medium",
    "phi-3-vision-4.2b",
    "arctic-480b",
    "moonshot-v1-16b-a3b",
    "llama3.2-1b",
    "qwen1.5-110b",
    "granite-3-8b",
    "starcoder2-3b",
    "zamba2-2.7b",
    "mamba2-1.3b",
)
PORTED = ("llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b", "starcoder2-3b",
          "granite-3-8b", "qwen1.5-110b", "moonshot-v1-16b-a3b",
          "arctic-480b")


def load_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not yet ported to the PyTorch package; ported: "
            f"{PORTED}")
    module = "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(module).CONFIG


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """``init(generator, device=None)``, ``forward(params, tokens, **kw)``,
    ``prefill(params, tokens, cache)``, ``decode_step(params, tokens,
    cache)``, ``init_cache(batch, max_seq, device=None)``, ``loss_fn(params,
    batch)`` and ``abstract()`` (the params' shapes and dtypes), each
    closed over ``cfg``."""

    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    loss_fn: Callable
    abstract: Callable


def get_model(cfg: ModelConfig) -> ModelApi:
    lm._check_family(cfg)
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: lm.init(cfg, generator, device),
        forward=lambda params, tokens, **kw: lm.forward(cfg, params, tokens,
                                                        **kw),
        prefill=lambda params, tokens, cache: lm.prefill(cfg, params, tokens,
                                                         cache),
        decode_step=lambda params, tokens, cache: lm.decode_step(
            cfg, params, tokens, cache),
        init_cache=lambda b, s, device=None: lm.init_cache(cfg, b, s, device),
        loss_fn=lambda params, batch: lm.loss_fn(cfg, params, batch),
        abstract=lambda: lm.abstract(cfg),
    )


def get(arch_id: str, smoke: bool = False) -> ModelApi:
    cfg = load_config(arch_id)
    if smoke:
        cfg = cfg.smoke()
    return get_model(cfg)
