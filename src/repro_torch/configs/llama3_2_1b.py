"""llama3.2-1b [dense] — 16L, d_model=2048, 32H (GQA kv=8), d_ff=8192,
vocab=128256, tied embeddings.  [hf:meta-llama/Llama-3.2-1B; unverified]

The port's copy of ``repro/configs/llama3_2_1b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
