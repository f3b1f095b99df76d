"""ssd_chunks — the Mamba2 SSD intra-chunk term as a hand-written CUDA
kernel.

Replaces ``repro/kernels/ssd_scan/kernel.py::ssd_chunks`` (a Pallas kernel
for the TPU): for every (batch, chunk, head) tile, ``cum = cumsum(dtA)``,
``y_diag = ((C Bᵀ) ∘ tril(exp(cum_i - cum_j))) (dt·x)`` and the chunk state
``(dt·x)ᵀ (B ∘ exp(cum_last - cum))``, with B and C shared across heads.
Its bound on the H100 is bytes at every shape the models run (about 85
operations a byte at mamba2's widths, under the card's ~295).  For bf16
(``csrc/ssd_chunks.cu``, one launch) every product runs on the tensor cores
(``wgmma``): a block per (b, chunk, 64-row query tile, group of G heads)
forms each key tile's scores C Bᵀ once for its G heads (G = 4 up to head
dim 64, 2 above) and adds P x per head with P split into two bf16 parts, and
a block per (b, chunk, head group, 128 columns of N; 64 above head dim 64)
forms the chunk states from x·w split the same way; float32 keeps f32 FMA
kernels on the CUDA cores.  See the source for the design.

:func:`ssd_chunks` launches the kernel for CUDA tensors (or raises) and
runs the plain version (:func:`~.ref.ssd_chunks_ref`) only for CPU or meta
tensors.  ``ssd_chunks.launches`` counts the wrapper's launches (one per
call, whichever of the source's kernels it runs).  On meta (the dry run's
counting, ``repro_torch._counting``) the plain version is recorded and
counted as it always was, and what is booked as memory is the card's: the
three outputs the kernel writes and, when autograd records the call, the
Function's backward.

On the card, when autograd records the call, it is a
``torch.autograd.Function``: the forward is the kernel, the backward is
plain PyTorch — the gradient of :func:`~.ref.ssd_chunks_ref`, recomputed
in f32 from the saved inputs and cast to their dtypes, for whichever of
y_diag, states and cum received a gradient.  The reference has no backward
kernel either (XLA differentiates its jnp scan).  The backward launches
nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ... import _counting
from .. import _build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunks.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_Q, MAX_HD, MAX_N = 1024, 128, 256

_FN = None


def _entry_point():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).ssd_chunks
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def ssd_chunks(x: torch.Tensor, dt: torch.Tensor, dtA: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, nc, nh, Q, hd), dt/dtA: (B, nc, nh, 1, Q), Bm/Cm: (B, nc, Q,
    N), in any strides with the last dim of x, Bm and Cm contiguous.
    Returns y_diag (B, nc, nh, Q, hd) in x's dtype (on the card a view of a
    contiguous (B, nc, Q, nh, hd) tensor, the model's layout), states (B,
    nc, nh, hd, N) f32 and cum (B, nc, nh, 1, Q) f32."""
    if x.dim() != 5 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"want x (B, nc, nh, Q, hd) and Bm, Cm (B, nc, Q, "
                         f"N), got {tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, nc, nh, Q, hd = x.shape
    N = Bm.shape[-1]
    if Bm.shape[:3] != (B, nc, Q) or dt.shape != (B, nc, nh, 1, Q) \
            or dtA.shape != dt.shape:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, dtA "
                         f"{tuple(dtA.shape)} and Bm {tuple(Bm.shape)} do not "
                         f"form one chunked scan")
    if not all(t.device == x.device for t in (dt, dtA, Bm, Cm)):
        raise ValueError("x, dt, dtA, Bm and Cm must be on one device")
    if x.device.type == "cpu":
        return ref.ssd_chunks_ref(x, dt, dtA, Bm, Cm)
    if x.device.type == "meta":
        return _on_meta(x, dt, dtA, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunks runs on CUDA (or the CPU), got "
                         f"{x.device}")
    if x.dtype not in _DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise ValueError(f"ssd_chunks takes float32 or bfloat16 x, Bm, Cm of "
                         f"one dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or dtA.dtype != torch.float32:
        raise ValueError(f"ssd_chunks takes float32 dt and dtA, got "
                         f"{dt.dtype}, {dtA.dtype}")
    if not (1 <= Q <= MAX_Q and 1 <= hd <= MAX_HD and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_chunks takes Q <= {MAX_Q}, hd <= {MAX_HD} and "
                         f"N <= {MAX_N}, got Q {Q}, hd {hd}, N {N}")
    if x.stride(4) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1:
        raise ValueError("the last dim of x, Bm and Cm must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, dtA, Bm, Cm)):
        y, states, cum = _SSDChunks.apply(x, dt, dtA, Bm, Cm)
    else:
        y, states, cum = _launch(x, dt, dtA, Bm, Cm)
    return y.transpose(2, 3), states, cum


class _SSDChunks(torch.autograd.Function):
    """The kernel forward, the plain version's gradient backward.  The
    forward returns y_diag's contiguous (B, nc, Q, nh, hd) base (the caller
    takes the (B, nc, nh, Q, hd) view), so no view crosses the Function.
    All three outputs carry gradient in the model (``cum`` through the
    inter-chunk decay and ``exp(cum)`` of the off-diagonal term); a
    gradient autograd does not deliver arrives as None."""

    @staticmethod
    def forward(ctx, x, dt, dtA, Bm, Cm):
        ctx.save_for_backward(x, dt, dtA, Bm, Cm)
        ctx.set_materialize_grads(False)
        return _launch(x, dt, dtA, Bm, Cm)

    @staticmethod
    def backward(ctx, gy, gstates, gcum):
        return _backward(ctx.saved_tensors, gy, gstates, gcum)


def _backward(ins, gy, gstates, gcum):
    """The gradients of the five saved inputs ``ins`` from the outputs'
    (None where none arrived; ``gy`` of the (B, nc, Q, nh, hd) base): the
    plain version recomputed in f32 and differentiated."""
    outs, grads = [], []
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in ins]
        y, states, cum = ref.ssd_chunks_ref(*leaves)
        for out, g in ((y, None if gy is None else gy.transpose(2, 3)),
                       (states, gstates), (cum, gcum)):
            if g is not None:
                outs.append(out)
                grads.append(g.float())
        if not outs:
            return (None,) * 5
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip(got, ins))


def _on_meta(x, dt, dtA, Bm, Cm):
    """The dry run's call: the plain version, counted, unbooked; its
    three outputs booked (the kernel's, as many bytes); the Function's
    backward booked when the backward reaches them (a gradient for each
    output)."""
    with _counting.unbooked():
        outs = ref.ssd_chunks_ref(x, dt, dtA, Bm, Cm)
    _counting.book(*outs)
    ins = [_counting.meta_of(t) for t in (x, dt, dtA, Bm, Cm)]
    B, nc, nh, Q, hd = x.shape
    grads = [((B, nc, Q, nh, hd), None, x.dtype)] + \
        [(t.shape, None, t.dtype) for t in outs[1:]]

    def card_backward():
        s = _counting.standin
        return _backward([s(m) for m in ins], *(s(m) for m in grads))
    _counting.on_backward(outs, card_backward)
    return outs


def _launch(x, dt, dtA, Bm, Cm):
    """One launch of the kernel on checked CUDA tensors; returns y_diag's
    contiguous (B, nc, Q, nh, hd) base, states and cum."""
    B, nc, nh, Q, hd = x.shape
    N = Bm.shape[-1]
    dev = x.device
    base = torch.empty((B, nc, Q, nh, hd), dtype=x.dtype, device=dev)
    y = base.transpose(2, 3)
    states = torch.empty((B, nc, nh, hd, N), dtype=torch.float32, device=dev)
    cum = torch.empty((B, nc, nh, 1, Q), dtype=torch.float32, device=dev)
    if B == 0 or nc == 0 or nh == 0:
        return base, states, cum   # a grid of 0 blocks is a launch error

    def s4(t):
        return t.stride(0), t.stride(1), t.stride(2), t.stride(-1)

    strides = (*s4(x.transpose(3, 4)), *s4(dt), *s4(dtA),
               *Bm.stride()[:3], *Cm.stride()[:3], *s4(y.transpose(3, 4)))
    # 16-byte rows: the bf16 kernel stages them with cp.async, else element
    # by element (a choice by layout, made here, never on failure)
    vec = (hd % 8 == 0 and N % 8 == 0
           and all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm, y))
           and all(v % 8 == 0 for v in (*strides[:4], *strides[12:])))
    err = _build.launch(
        _entry_point(), dev, x.data_ptr(), dt.data_ptr(), dtA.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
        cum.data_ptr(), B, nc, nh, Q, hd, N,
        (ctypes.c_longlong * len(strides))(*strides), _DTYPES[x.dtype],
        int(vec))
    if err:
        raise RuntimeError(f"ssd_chunks launch failed with CUDA error {err}")
    ssd_chunks.launches += 1
    return base, states, cum


ssd_chunks.launches = 0
