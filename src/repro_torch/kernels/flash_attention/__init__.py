"""flash_attention: kernel.py (the CUDA blocked attention and its wrapper),
ops.py (the model-layout adapter), ref.py (the plain PyTorch version)."""
from . import kernel, ops, ref  # noqa
