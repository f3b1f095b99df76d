"""granite-3-8b [dense] — 40L, d_model=4096, 32H (GQA kv=8), d_ff=12800,
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base; hf]

The port's copy of ``repro/configs/granite_3_8b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
