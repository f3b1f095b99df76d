"""Model registry: one uniform API over the ported families.

The port's counterpart of ``repro/models/registry.py``.  ``get_model(cfg)``
returns a :class:`ModelApi` whose methods close over the config: the
decoder-only families through ``lm.py``, the encoder-decoder through
``encdec.py``.  Every id of the reference's registry is ported.
:meth:`ModelApi.inputs` gives the reference's ``input_specs`` as the
shapes and dtypes of a step's data (``patches`` for the vlm, ``frames``
for the encdec); :meth:`ModelApi.input_specs`, ``input_axes``,
``abstract_cache`` and ``cache_axes`` give the reference's stand-ins and
logical axes, which the placements and the dry run read.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import InputShape, ModelConfig
from ..core.deepcopy import ShapeDtype
from . import encdec, lm
from .specs import torch_dtype

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


def load_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    module = "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(module).CONFIG


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """``init(generator, device=None)``, ``forward(params, tokens, **kw)``,
    ``prefill(params, tokens, cache, **kw)`` (``patches=`` for the vlm,
    ``frames=`` for the encdec), ``decode_step(params, tokens, cache)``,
    ``init_cache(batch, max_seq, device=None, abstract_only=False)``,
    ``loss_fn(params, batch)``, ``abstract()`` (the params' shapes and
    dtypes) and ``axes()`` (their logical axes), each closed over
    ``cfg``."""

    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    loss_fn: Callable
    abstract: Callable
    axes: Callable

    def inputs(self, shape: InputShape) -> Dict[str, Tuple[tuple,
                                                           torch.dtype]]:
        """The (shape, dtype) of each data input of a step at ``shape``,
        the reference's ``input_specs``: tokens and labels for a train
        step, with the vlm's patches (the text shortened by them) and the
        encdec's frames (B, max(1, S / src_ratio), d_model); tokens (and
        patches or frames) for a prefill; one token for a decode step."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        cdt = torch_dtype(cfg.compute_dtype)
        frames = ((B, max(1, S // cfg.src_ratio), cfg.d_model), cdt)
        patches = ((B, cfg.frontend_tokens, cfg.d_model), cdt)
        vision = cfg.frontend == "vision"
        text = S - cfg.frontend_tokens if vision else S
        tok = ((B, text), torch.int32)
        if shape.mode == "train":
            out = {"tokens": tok, "labels": tok}
        elif shape.mode == "prefill":
            out = {"tokens": tok}
        elif shape.mode == "decode":
            return {"tokens": ((B, 1), torch.int32)}
        else:
            raise ValueError(f"unknown mode {shape.mode}")
        if cfg.is_encdec:
            out["frames"] = frames
        elif vision:
            out["patches"] = patches
        return out

    def input_specs(self, shape: InputShape) -> Dict[str, ShapeDtype]:
        """:meth:`inputs` as :class:`ShapeDtype`s (the reference's
        ``input_specs``)."""
        return {k: ShapeDtype(tuple(sh), dt)
                for k, (sh, dt) in self.inputs(shape).items()}

    def input_axes(self, shape: InputShape) -> Dict[str, Tuple]:
        """The inputs' logical axes: the batch dim, the rest unnamed."""
        return {k: ("batch",) + (None,) * (len(v.shape) - 1)
                for k, v in self.input_specs(shape).items()}

    def abstract_cache(self, shape: InputShape) -> Dict[str, ShapeDtype]:
        """The serve cache at ``shape`` (batch, max_seq = seq_len) as
        :class:`ShapeDtype`s."""
        return self.init_cache(shape.global_batch, shape.seq_len,
                               abstract_only=True)

    def cache_axes(self, shape: InputShape) -> Dict[str, Tuple]:
        """The cache leaves' logical axes, as the reference names them."""
        out: Dict[str, Tuple] = {}
        for k, v in self.abstract_cache(shape).items():
            if k in ("k", "v"):
                out[k] = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            elif k == "state":
                out[k] = ("layers", "batch", "ssm_heads", None, "ssm_state")
            elif k == "conv":
                out[k] = ("layers", "batch", None, "ssm_inner")
            elif k == "enc_out":
                out[k] = ("batch", None, None)
            elif k == "pos":
                out[k] = ("batch",)
            else:
                out[k] = (None,) * len(v.shape)
        return out


def _module(cfg: ModelConfig):
    return encdec if cfg.is_encdec else lm


def spec_tree(cfg: ModelConfig):
    """The model's parameter spec tree, from the module that builds it."""
    return _module(cfg).spec_tree(cfg)


def kernel_launches(cfg: ModelConfig, *args, **kwargs) -> Dict[str, int]:
    """``lm.kernel_launches`` or ``encdec.kernel_launches``, by family."""
    return _module(cfg).kernel_launches(cfg, *args, **kwargs)


def get_model(cfg: ModelConfig) -> ModelApi:
    m = _module(cfg)
    m._check_family(cfg)
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: m.init(cfg, generator, device),
        forward=lambda params, tokens, **kw: m.forward(cfg, params, tokens,
                                                       **kw),
        prefill=lambda params, tokens, cache, **kw: m.prefill(
            cfg, params, tokens, cache, **kw),
        decode_step=lambda params, tokens, cache: m.decode_step(
            cfg, params, tokens, cache),
        init_cache=lambda b, s, device=None, abstract_only=False:
            m.init_cache(cfg, b, s, device, abstract_only),
        loss_fn=lambda params, batch, **kw: m.loss_fn(cfg, params, batch,
                                                   **kw),
        abstract=lambda: m.abstract(cfg),
        axes=lambda: m.axes(cfg),
    )


def get(arch_id: str, smoke: bool = False) -> ModelApi:
    cfg = load_config(arch_id)
    if smoke:
        cfg = cfg.smoke()
    return get_model(cfg)
