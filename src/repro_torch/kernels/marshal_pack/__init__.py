"""marshal_pack: kernel.py (the CUDA tile gather and its wrapper), ops.py
(tree pack/unpack through it), ref.py (the plain PyTorch version)."""
from . import kernel, ops, ref  # noqa
