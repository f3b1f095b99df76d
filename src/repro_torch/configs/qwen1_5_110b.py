"""qwen1.5-110b [dense] — 80L, d_model=8192, 64H (GQA kv=8), d_ff=49152,
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

The port's copy of ``repro/configs/qwen1_5_110b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    remat="full",
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    inference_embed_fsdp=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
