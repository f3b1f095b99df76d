"""zamba2-2.7b [hybrid] — 54 Mamba2 blocks + weight-shared attention block.

d_model=2560, shared attn 32H (kv=32), d_ff=10240, vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf].  The shared block is applied every 6 Mamba2 layers
(9 applications, one KV cache slot each).

The port's copy of ``repro/configs/zamba2_2_7b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="arXiv:2411.15242; hf",
)
