"""ssd_scan: kernel.py (the CUDA SSD chunk kernel and its wrapper), ops.py
(the chunked scan the model calls), ref.py (the plain PyTorch version)."""
from . import kernel, ops, ref  # noqa
