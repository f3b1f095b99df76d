"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names and is held against it by ``tests/test_torch_*.py``.  It
imports torch, numpy and the standard library only — never JAX, never
``repro``.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch._device`).  Ported so far: the
Algorithm-2 main path on one device (``core``, ``scenarios``), policy
programs and their static analysis, eight models behind the
continuous-batching ``runtime.Server``, training of the dense family
(``optim``, ``data``, ``checkpoint``, ``runtime.train`` and ``loop``,
``launch.train``), and every TPU kernel of ``repro`` as a hand-written
CUDA kernel (``kernels``).
"""
from ._device import NoCudaDeviceError, resolve_device

__all__ = ["NoCudaDeviceError", "resolve_device"]
