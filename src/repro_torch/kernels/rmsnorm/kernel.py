"""rmsnorm — the fused RMSNorm as a hand-written CUDA kernel.

Replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm`` (a Pallas kernel for
the TPU): ``x * rsqrt(mean(x^2, -1) + eps) * scale`` with f32 inside and the
result cast back.  On the H100 it is bound by memory: each row is read and
written once, ``(2 * rows * D + D) * itemsize`` bytes at the card's
bandwidth.  The kernel (``csrc/rmsnorm.cu``) runs one block per row with
16-byte loads and a warp-shuffle reduction; see the source for the design.

:func:`rmsnorm` launches the kernel for a CUDA tensor (or raises) and runs
the plain version (:func:`~.ref.rmsnorm_ref`) only for a CPU or a
meta tensor (meta: the dry run's counting).
``rmsnorm.launches`` counts the kernel's launches.

On the card the call is a ``torch.autograd.Function``: the forward is the
kernel, the backward is plain PyTorch — the gradient of the plain version,
recomputed from the saved x and scale in f32 and cast to their dtypes.
The reference has no backward kernel either (XLA differentiates its jnp
path).  The backward launches nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 256


_FN = None


def _entry_point():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).rmsnorm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


class _RMSNorm(torch.autograd.Function):
    """The kernel forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, grad):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xf = x.detach().float().requires_grad_()
            sf = scale.detach().float().requires_grad_()
            y = ref.rmsnorm_ref(xf, sf, ctx.eps)
            dx, ds = torch.autograd.grad(y, (xf, sf), grad.float())
        return dx.to(x.dtype), ds.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), scale: (D,) -> RMSNorm(x) * scale, in x's dtype;
    differentiable in x and scale on either device."""
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale must be ({D},), got {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    if x.device.type in ("cpu", "meta"):
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA (or the CPU), got {x.device}")
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and a scale "
                         f"of the same dtype, got {x.dtype} / {scale.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, float(eps))
    return _launch(x, scale, float(eps))


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors."""
    D = x.shape[-1]
    xm = x.contiguous()
    w = scale.contiguous()
    rows = xm.numel() // D if D else 0
    out = torch.empty_like(xm)
    if rows == 0 or D == 0:
        return out          # a grid of 0 blocks is a launch error
    if rows >= 2 ** 31:
        raise ValueError("rmsnorm takes fewer than 2^31 rows")
    item = xm.element_size()
    vec = int(D * item % 16 == 0 and xm.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    words = D * item // 16 if vec else D
    threads = max(32, min(_MAX_THREADS, -(-words // 32) * 32))
    err = _build.launch(_entry_point(), x.device, xm.data_ptr(), w.data_ptr(),
                        out.data_ptr(), rows, D, float(eps), _DTYPES[x.dtype],
                        vec, threads)
    if err:
        raise RuntimeError(f"rmsnorm launch failed with CUDA error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
