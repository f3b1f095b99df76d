"""Hand-written CUDA kernels for Hopper, one subpackage per TPU kernel of
``repro.kernels`` ported so far.  Each holds ``kernel.py`` (the wrapper,
which launches the kernel for a CUDA tensor and runs the plain version for
a CPU tensor), ``ref.py`` (the plain PyTorch version), ``ops.py`` (the
entry points) and ``csrc/`` (the CUDA source).  Kernels are built at first
use (:mod:`repro_torch.kernels._build`), never at import."""
