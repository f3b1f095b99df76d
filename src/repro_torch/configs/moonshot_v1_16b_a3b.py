"""moonshot-v1-16b-a3b [moe] — Moonlight 16B (3B active): 64 experts top-6.

48L, d_model=2048, 16H (GQA kv=16), expert d_ff=1408, vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B; hf]

The port's copy of ``repro/configs/moonshot_v1_16b_a3b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
