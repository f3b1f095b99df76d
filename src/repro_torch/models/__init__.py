"""Models of the port: the decoder-only families (``lm.py``: dense, moe,
vlm, ssm and hybrid) and the encoder-decoder (``encdec.py``), built from
``layers.py``, ``moe.py`` and ``ssm.py`` over ``specs.py``, behind
``registry.py``.  The model kernels (RMSNorm, flash and decode attention,
the SSD chunk) are the hand-written CUDA kernels of
:mod:`repro_torch.kernels` on the card and their plain versions on the
CPU."""
from .registry import ARCH_IDS, ModelApi, get, get_model, load_config

__all__ = ["ARCH_IDS", "ModelApi", "get", "get_model", "load_config"]
