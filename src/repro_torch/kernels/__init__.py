"""Hand-written CUDA kernels for Hopper, one subpackage per TPU kernel of
``repro.kernels`` ported so far.  Each holds ``kernel.py`` (the wrapper,
which launches the kernel for a CUDA tensor and runs the plain version for
a CPU tensor), ``ref.py`` (the plain PyTorch version), ``ops.py`` (the
entry points) and ``csrc/`` (the CUDA source).  Kernels are built at first
use (:mod:`repro_torch.kernels._build`), never at import."""

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a plain version computes in: ``torch.promote_types(dtype,
    torch.float32)`` for a floating ``dtype`` (float64 stays float64,
    bfloat16 and float16 widen to float32), found without dispatching an
    op: ``torch.promote_types`` dispatches ``aten.promote_types``, which
    the dry run's op counter would count."""
    return torch.float64 if dtype == torch.float64 else torch.float32
