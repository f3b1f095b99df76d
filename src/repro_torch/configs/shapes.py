"""The assigned input-shape grid (same 4 shapes for every LM arch).

  train_4k     seq 4096,    global batch 256  -> train_step
  prefill_32k  seq 32768,   global batch 32   -> prefill (serve)
  decode_32k   seq 32768,   global batch 128  -> serve_step: 1 new token,
                                                 KV cache of seq_len
  long_500k    seq 524288,  global batch 1    -> long-context decode; only
                                                 for sub-quadratic families

The port's copy of ``repro/configs/shapes.py``, with the same cells.
"""
from __future__ import annotations

from .base import InputShape

TRAIN_4K = InputShape("train_4k", seq_len=4096, global_batch=256, mode="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32768, global_batch=32, mode="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32768, global_batch=128, mode="decode")
LONG_500K = InputShape("long_500k", seq_len=524288, global_batch=1, mode="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg) -> dict[str, InputShape]:
    """The runnable shape cells for an architecture (skips documented in
    DESIGN.md §4.2: long_500k requires a sub-quadratic family)."""
    out = dict(SHAPES)
    if not cfg.supports_long_context:
        out.pop("long_500k")
    return out


def skip_reason(cfg, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention architecture: 512k-token decode needs "
                "sub-quadratic attention (DESIGN.md §4.2)")
    return None
