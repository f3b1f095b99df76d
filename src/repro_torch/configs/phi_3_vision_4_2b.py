"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stub).

32L, d_model=3072, 32H (GQA kv=32), d_ff=8192, vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf].  Patch embeddings arrive
precomputed (the vision frontend is a stub); a learned projection adapts
them into the text stream.

The port's copy of ``repro/configs/phi_3_vision_4_2b.py``, with the same
values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    frontend_tokens=576,      # one 336px CLIP tile
    rope_theta=10000.0,
    optimizer="adamw",
    decode_rules=(("kv_seq", ("model",)),),
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
