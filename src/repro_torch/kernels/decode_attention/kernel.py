"""decode_attention — one query token against a KV cache, as a
hand-written CUDA kernel.

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention`` (a
Pallas kernel for the TPU): for each (b, h) an f32 online softmax over the
keys below ``valid_len[b]``.  On the H100 it is bound by memory: every
valid K and V row is read once, ``B * KV * valid * hd * 2 * itemsize``
bytes at the card's bandwidth.  The kernel (``csrc/decode_attention.cu``)
runs one block per (b, KV head) that serves all H/KV query heads of the
group, reads the cache through its strides and stops at the valid prefix;
see the source for the design.

:func:`decode_attention` launches the kernel for CUDA tensors (or raises)
and runs the plain version (:func:`~.ref.decode_ref`) only for CPU
tensors.  ``decode_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_FN = None


def _entry_point():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     block_k: int = 512) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, KV, S, hd) in any strides with the head dim
    contiguous; valid_len: (B,) integers -> (B, H, hd).  ``block_k`` is
    the Pallas kernel's key block, which sets the value of a row with
    ``valid_len == 0`` (see :mod:`.ref`)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, hd) and k, v (B, KV, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV or S == 0
            or valid_len.shape != (B,)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"valid_len {tuple(valid_len.shape)} do not form a "
                         f"GQA decode attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if not (q.device == k.device == v.device == valid_len.device):
        raise ValueError("q, k, v and valid_len must be on one device")
    if q.device.type == "cpu":
        return ref.decode_ref(q, k, v, valid_len, scale=scale,
                              block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA (or the CPU), got "
                         f"{q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode_attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    valid = valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out          # a grid of 0 blocks is a launch error
    item = k.element_size()
    vec = int(hd * item % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s * item % 16 == 0
                                       for s in t.stride()[:3])
        for t in (k, v)))
    err = _build.launch(
        _entry_point(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), out.data_ptr(), B, H, KV, S, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1), out.stride(0), out.stride(1),
        float(scale), float(ref.empty_denominator(S, block_k)),
        _DTYPES[q.dtype], vec)
    if err:
        raise RuntimeError(f"decode_attention launch failed with CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
