"""The model's entry point to the fused RMSNorm (``x: (..., D)``), as
``repro/kernels/rmsnorm/ops.py`` is for the reference."""
from .kernel import rmsnorm

__all__ = ["rmsnorm"]
