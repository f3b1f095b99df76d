"""rmsnorm: kernel.py (the CUDA RMSNorm and its wrapper), ops.py (the
entry point the model calls), ref.py (the plain PyTorch version)."""
from . import kernel, ops, ref  # noqa
