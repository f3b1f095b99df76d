"""Models of the port: the dense decoder (``lm.py``, family ``dense``)
built from ``layers.py`` over ``specs.py``, behind ``registry.py``.  The
model kernels (RMSNorm, flash and decode attention) are the hand-written
CUDA kernels of :mod:`repro_torch.kernels` on the card and their plain
versions on the CPU."""
from .registry import ARCH_IDS, ModelApi, get, get_model, load_config

__all__ = ["ARCH_IDS", "ModelApi", "get", "get_model", "load_config"]
