"""rmsnorm — the fused RMSNorm as a hand-written CUDA kernel.

Replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm`` (a Pallas kernel for
the TPU): ``x * rsqrt(mean(x^2, -1) + eps) * scale`` with f32 inside and the
result cast back.  On the H100 it is bound by memory: each row is read and
written once, ``(2 * rows * D + D) * itemsize`` bytes at the card's
bandwidth.  The kernel (``csrc/rmsnorm.cu``) makes one pass with the row
in registers, a CTA a row on a persistent grid (a strided block a row for
rows that are not 16-byte aligned), and keeps the reduction order of the
one-block-a-row kernel it replaced, so its results are that kernel's bit
for bit; :func:`_plan` picks the path and the launch shape (see the
source for the design).

:func:`rmsnorm` launches the kernel for a CUDA tensor (or raises) and runs
the plain version (:func:`~.ref.rmsnorm_ref`) only for a CPU or a meta
tensor.  ``rmsnorm.launches`` counts the kernel's launches.  On meta (the
dry run's counting, ``repro_torch._counting``) the plain version is
recorded and counted as it always was, and what is booked as memory is the
card's: the contiguous copies the kernel reads (none when its inputs are),
its output and, when autograd records the call, the Function's backward.

On the card the call is a ``torch.autograd.Function``: the forward is the
kernel, the backward is plain PyTorch — the gradient of the plain version,
recomputed from the saved x and scale in f32 and cast to their dtypes.
The reference has no backward kernel either (XLA differentiates its jnp
path).  The backward launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from ... import _counting
from .. import _build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"row": 0, "strided": 1}
H100_SMS = 132
MAX_THREADS = 256                 # the reduction's threads: the old kernel's
FOLDS = (1, 2)                    # its threads a thread: the source's instances
WORDS = (1, 2, 4, 8)              # 16-byte words a reduction thread: likewise
MAX_THREAD_WORDS = 8              # F x W, the row and the scale in registers
FEW_ROWS = 256                    # up to here: F = 1, the most threads a row
MANY_ROWS = 2048                  # above: F = 2, also for rows of W > 1
WARPS_PER_SM = 64                 # the persistent grid's aim


class Plan(NamedTuple):
    """One launch: the source's path, F (the reduction's threads a thread)
    and W (16-byte words a reduction thread: at most; 0 on the strided
    path), threads a CTA and CTAs."""
    path: str
    fold: int
    words: int
    threads: int
    grid: int


def _plan(rows: int, D: int, itemsize: int, aligned: bool,
          sms: int = H100_SMS) -> Plan:
    """The launch for ``rows`` rows of ``D`` elements of ``itemsize``
    bytes; ``aligned``: x, the scale and y start on 16-byte boundaries.

    The reduction is the old kernel's, of ``V = min(256, 32 * ceil(n /
    32))`` threads (n the row's 16-byte words, or its elements on the
    strided path), each summing every V-th of them.  Aligned rows whose
    ``W = ceil(words / V)`` fits go a CTA a row: ``V / F`` threads, each
    playing F of the V, F x W words in registers (at most 8).  Up to
    :data:`FEW_ROWS` rows F = 1 (the most threads a row: one row's latency
    is the whole time).  Above, F = 2 where a thread would hold one word
    (two words in flight a thread, not one), and for every row width above
    :data:`MANY_ROWS` rows; rows of W > 1 keep F = 1 up to there, as a
    thread already holds two words (``PERF.md`` says how these were
    chosen).  The grid stops at about :data:`WARPS_PER_SM`
    warps an SM, the CTAs looping over the rest.  Other rows (not 16-byte
    aligned, or longer) go the old way, a block of V threads a row over a
    strided loop."""
    if rows < 1 or D < 1:
        raise ValueError(f"rmsnorm plans at least one row of one element, "
                         f"got {rows} x {D}")
    row_bytes = D * itemsize
    vec = aligned and row_bytes % 16 == 0
    n = row_bytes // 16 if vec else D
    V = _threads(n)
    need = -(-n // V)
    if vec and need <= MAX_THREAD_WORDS:
        W = next(w for w in WORDS if w >= need)
        fold = 1
        if rows > FEW_ROWS and (W == 1 or rows > MANY_ROWS) and \
                V % 64 == 0 and 2 * W <= MAX_THREAD_WORDS:
            fold = 2
        t = V // fold
        return Plan("row", fold, W, t,
                    min(rows, sms * max(1, WARPS_PER_SM // (t // 32))))
    return Plan("strided", 1, 0, V, rows)


def _threads(n: int) -> int:
    """The one-block-a-row kernel's threads for a row of ``n`` 16-byte
    words (or elements, unaligned): 32 a word, at most 256."""
    return max(32, min(MAX_THREADS, -(-n // 32) * 32))


_FN = None


def _library():
    return _build.load(SOURCE)


def _entry_point():
    global _FN
    if _FN is None:
        fn = _library().rmsnorm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def empty_launch(device: torch.device) -> None:
    """One empty kernel from the same library, through the same ctypes
    path: the launch floor rmsnorm's times are read against.  Not counted
    in ``rmsnorm.launches``."""
    fn = _library().rmsnorm_empty
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = _build.launch(fn, device)
    if err:
        raise RuntimeError(f"empty launch failed with CUDA error {err}")


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
        return _backward(x, scale, ctx.eps, grad) + (None,)


def _backward(x, scale, eps, grad):
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        sf = scale.detach().float().requires_grad_()
        y = ref.rmsnorm_ref(xf, sf, eps)
        dx, ds = torch.autograd.grad(y, (xf, sf), grad.float())
    return dx.to(x.dtype), ds.to(scale.dtype)


def _on_meta(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """The dry run's call: the plain version, counted, unbooked; booked,
    what :func:`_launch` allocates (the contiguous copies it reads beside
    its output, then the output) and, when the backward reaches the
    output, the Function's backward."""
    with _counting.unbooked():
        out = ref.rmsnorm_ref(x, scale, eps)
    with _counting.memory_only():
        read = x.contiguous(), scale.contiguous()
    _counting.book(out)
    del read
    ins = [_counting.meta_of(t) for t in (x, scale)]
    grad = out.shape, None, out.dtype

    def card_backward():
        s = _counting.standin
        return _backward(s(ins[0]), s(ins[1]), eps, s(grad))
    _counting.on_backward([out], card_backward)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), scale: (D,) -> RMSNorm(x) * scale, in x's dtype;
    differentiable in x and scale on either device."""
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale must be ({D},), got {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type == "meta":
        return _on_meta(x, scale, float(eps))
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA (or the CPU), got {x.device}")
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and a scale "
                         f"of the same dtype, got {x.dtype} / {scale.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, float(eps))
    return _launch(x, scale, float(eps))


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float,
            strided: bool = False) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors; ``strided``
    forces the strided path, the one-block-a-row kernel that the row path
    keeps the reduction order of (its results are the row path's bit for
    bit; the card's tests and ``chip_smoke.py`` compare and time the
    two)."""
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
    aligned = (xm.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    vec = int(aligned and D * item % 16 == 0)
    plan = Plan("strided", 1, 0, _threads(D * item // 16 if vec else D),
                rows) if strided else _plan(rows, D, item, aligned,
                                            _sm_count(index))
    err = _build.launch(_entry_point(), x.device, xm.data_ptr(), w.data_ptr(),
                        out.data_ptr(), rows, D, float(eps), _DTYPES[x.dtype],
                        _PATHS[plan.path], vec, plan.fold, plan.words,
                        plan.threads, plan.grid)
    if err:
        raise RuntimeError(f"rmsnorm launch failed with CUDA error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
