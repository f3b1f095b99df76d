"""starcoder2-3b [dense] — 30L, d_model=3072, 24H (GQA kv=2), d_ff=12288,
vocab=49152, RoPE, LayerNorm + non-gated GeLU MLP.  [arXiv:2402.19173; hf]

The port's copy of ``repro/configs/starcoder2_3b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    norm="layernorm",
    gated_mlp=False,
    qkv_bias=True,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="arXiv:2402.19173; hf",
)
