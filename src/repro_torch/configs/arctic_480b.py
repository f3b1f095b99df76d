"""arctic-480b [moe] — Snowflake Arctic: dense residual + 128-expert top-2.

35L, d_model=7168, 56H (GQA kv=8), expert d_ff=4864, vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf].  Optimizer is Adafactor (factored
second moment).

The port's copy of ``repro/configs/arctic_480b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    optimizer="adafactor",
    remat="full",
    decode_rules=(("kv_seq", ("model",)),),
    inference_embed_fsdp=True,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
