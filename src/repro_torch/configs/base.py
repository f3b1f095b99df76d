"""ModelConfig — the one config type every architecture instantiates.

The port's own copy of ``repro/configs/base.py``, field for field and with
the same ``smoke()`` reduction, less ``use_pallas``: the port picks a
kernel by the device of the tensor it is given (the card launches the
hand-written kernel, the CPU runs its plain version), so there is no switch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | encdec | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_dense_residual: bool = False

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # attention details
    qkv_bias: bool = False
    gated_mlp: bool = True               # False -> LayerNorm+GeLU
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # enc-dec
    enc_layers: int = 0
    src_ratio: int = 4

    # hybrid (zamba2)
    attn_every: int = 0

    # modality frontend stubs: precomputed embeddings
    frontend: str = "none"               # none | audio | vision
    frontend_tokens: int = 0

    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"                  # none | dots | full
    optimizer: str = "adamw"             # adamw | adafactor
    micro_batches: int = 1

    # the reference's sharding-rule overrides, kept as data
    rules: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = ()
    decode_rules: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = ()
    inference_embed_fsdp: bool = False

    # documentation
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        # the family as well: a layer-free copy (the dry run's probe
        # check) keeps its encoder-decoder structure
        return self.enc_layers > 0 or self.family == "encdec"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic families (DESIGN.md §4.2)."""
        return self.family in ("ssm", "hybrid")

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=96,
            vocab_size=257,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
            micro_batches=1,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # train | prefill | decode

    def smoke(self) -> "InputShape":
        return InputShape(self.name + "-smoke", seq_len=32, global_batch=2,
                          mode=self.mode)
