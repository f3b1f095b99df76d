"""mamba2-1.3b [ssm] — 48L pure Mamba2 SSD, attention-free.

d_model=2048, ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]

The port's copy of ``repro/configs/mamba2_1_3b.py``, with the same values.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                 # no MLP: the SSD mixer is the whole block
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    optimizer="adamw",
    source="arXiv:2405.21060; unverified",
)
