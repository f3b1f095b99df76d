"""seamless-m4t-medium [audio] — enc-dec multimodal backbone.

12L encoder + 12L decoder, d_model=1024, 16H (GQA kv=16), d_ff=4096,
vocab=256206.  [arXiv:2308.11596; hf].  The speech frontend is a stub:
input_specs() supplies precomputed frame embeddings (B, S/4, 1024).

The port's copy of ``repro/configs/seamless_m4t_medium.py``, with the same
values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder layers
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    src_ratio=4,
    tie_embeddings=True,
    norm="layernorm",
    gated_mlp=False,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="arXiv:2308.11596; hf",
)
