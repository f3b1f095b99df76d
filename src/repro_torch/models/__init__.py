"""Models of the port: the decoder (``lm.py``, families ``dense``, ``ssm``
and ``hybrid``) built from ``layers.py`` and ``ssm.py`` over ``specs.py``,
behind ``registry.py``.  The model kernels (RMSNorm, flash and decode
attention, the SSD chunk) are the hand-written CUDA kernels of
:mod:`repro_torch.kernels` on the card and their plain versions on the
CPU."""
from .registry import ARCH_IDS, ModelApi, get, get_model, load_config

__all__ = ["ARCH_IDS", "ModelApi", "get", "get_model", "load_config"]
