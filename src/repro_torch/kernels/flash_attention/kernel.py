"""flash_attention — blocked causal GQA attention as a hand-written CUDA
kernel.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention`` (a
Pallas kernel for the TPU): per (b, h), an f32 online softmax over k tiles,
keys at or past ``kv_len[b]`` masked, ``k_pos <= q_offset[b] + i`` for
query row ``i`` when causal, the KV head ``h // (H / KV)``.  The query
offset is what the model's attention needs at a nonzero cache position
(the reference masks with the real positions).  At the serving shapes its
bound is the products, ``4 * B * H * Sq * Sk * hd`` operations (half
under causal masking) at the tensor cores' rate.

``csrc/flash_attention.cu`` holds two kernels, chosen by dtype.  bf16, what
serving runs, goes to the tensor cores: one block of two warpgroups per
(b, h, 128 query rows), Q K^T and P V as ``wgmma`` with f32 accumulation,
P kept in registers as the A operand, K/V tiles of 64 keys through a
three- or four-stage ``cp.async`` ring, masks only on the diagonal and
``kv_len`` tiles.  It needs 16-byte aligned q, k, v with row, head and
batch strides a multiple of 8 elements (the model's tensors always are)
and raises ``ValueError`` otherwise.  float32, what the card tests and the smoke
models' logits checks run, keeps the f32 FMA kernel: tensor cores in f32
are TF32.  See the source for both designs.

:func:`flash_attention` launches the kernel for CUDA tensors (or raises)
and runs the plain version (:func:`~.ref.attention_ref`) only for CPU or
meta tensors.  ``flash_attention.launches`` counts the kernel's launches.
On meta (the dry run's counting, ``repro_torch._counting``) the plain
version is recorded and counted as it always was, and what is booked as
memory is the card's: the output the kernel writes and, when autograd
records the call, the Function's backward (below).

On the card the call is a ``torch.autograd.Function``: the forward is the
kernel, the backward is plain PyTorch — the gradient of
:func:`~.ref.attention_ref` (einsums, no library attention call),
recomputed from the saved q, k and v in f32 and cast to their dtype.  The
reference has no backward kernel either (XLA differentiates its jnp
path).  The backward launches nothing.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from ... import _counting
from .. import _build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 96, 128)


_FN = None


def _entry_point():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _per_batch(t: Optional[torch.Tensor], B: int, device: torch.device,
               what: str) -> Optional[torch.Tensor]:
    """A (B,) int32 tensor on ``device`` (converted if it is another
    integer type), or None."""
    if t is None:
        return None
    if not isinstance(t, torch.Tensor) or t.shape != (B,) \
            or t.device != device or t.is_floating_point():
        got = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
               if isinstance(t, torch.Tensor) else repr(t))
        raise ValueError(f"{what} must be a ({B},) integer tensor on "
                         f"{device}, got {got}")
    return t.to(torch.int32).contiguous()


class _Flash(torch.autograd.Function):
    """The kernel forward, the plain version's gradient backward.  The
    output is the contiguous (B, Sq, H, hd) tensor (the caller takes the
    (B, H, Sq, hd) view), so no view crosses the Function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len, q_offset):
        ctx.save_for_backward(q, k, v, kv_len, q_offset)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, causal, scale, kv_len, q_offset)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_len, q_offset = ctx.saved_tensors
        return _backward(q, k, v, kv_len, q_offset, ctx.causal, ctx.scale,
                         grad.transpose(1, 2)) + (None,) * 4


def _backward(q, k, v, kv_len, q_offset, causal, scale, grad):
    """The gradients of q, k and v from the saved inputs and ``grad``,
    the output's gradient in (B, H, Sq, hd): the plain version recomputed
    in f32 and differentiated."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_()
                      for t in (q, k, v))
        out = ref.attention_ref(qf, kf, vf, causal=causal, scale=scale,
                                kv_len=kv_len, q_offset=q_offset)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), grad.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _on_meta(q, k, v, causal, scale, kv_len, q_offset) -> torch.Tensor:
    """The dry run's call: the plain version, counted, unbooked; its
    output booked (the kernel's (B, Sq, H, hd) output, as many bytes);
    the Function's backward booked when the backward reaches it."""
    with _counting.unbooked():
        out = ref.attention_ref(q, k, v, causal=causal, scale=scale,
                                kv_len=kv_len, q_offset=q_offset)
    _counting.book(out)
    B, H, Sq, hd = q.shape
    ins = [_counting.meta_of(t) for t in (q, k, v)]
    lens = [None if t is None else _counting.meta_of(t)
            for t in (kv_len, q_offset)]
    grad = (B, Sq, H, hd), None, q.dtype

    def card_backward():
        s = _counting.standin
        return _backward(*(s(m) for m in ins),
                         *(None if m is None else s(m) for m in lens),
                         causal, scale, s(grad).transpose(1, 2))
    _counting.on_backward([out], card_backward)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd), k/v: (B, KV, Sk, hd) with H % KV == 0, in any
    strides with the head dim contiguous.  Keys at or past ``kv_len[b]``
    are masked (a (B,) integer tensor on q's device, clamped into [1, Sk];
    default: every key valid).  Row ``i`` of batch ``b`` sits at position
    ``q_offset[b] + i`` for the causal mask (a (B,) integer tensor on q's
    device, clamped to >= 0; default 0).  The clamps keep key 0 valid for
    every row, which the kernel's causal tile skip needs; they are applied
    on the device, so nothing here waits for it.  Returns (B, H, Sq, hd):
    on the card a view of a contiguous (B, Sq, H, hd) tensor, the model's
    layout."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"form a GQA attention")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    kv_len = _per_batch(kv_len, B, q.device, "kv_len")
    q_offset = _per_batch(q_offset, B, q.device, "q_offset")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale,
                                 kv_len=kv_len, q_offset=q_offset)
    if q.device.type == "meta":
        return _on_meta(q, k, v, causal, scale, kv_len, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA (or the CPU), got "
                         f"{q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(
                s % 8 == 0 for s, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1)
            for t in (q, k, v)):
        raise ValueError("the bf16 kernel copies 16-byte rows: q, k and v "
                         "need 16-byte aligned data and batch, head and row "
                         "strides that are multiples of 8 elements")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, float(scale), kv_len,
                            q_offset).transpose(1, 2)
    return _launch(q, k, v, causal, float(scale), kv_len,
                   q_offset).transpose(1, 2)


def _launch(q, k, v, causal, scale, kv_len, q_offset) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors; returns the
    contiguous (B, Sq, H, hd) output."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    base = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    out = base.transpose(1, 2)
    if B == 0 or Sq == 0:
        return base         # a grid of 0 blocks is a launch error
    err = _build.launch(
        _entry_point(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), 0 if q_offset is None else q_offset.data_ptr(),
        0 if kv_len is None else kv_len.data_ptr(), B, H, KV, Sq, Sk, hd,
        int(causal), float(scale), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], _DTYPES[q.dtype])
    if err:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return base


flash_attention.launches = 0
