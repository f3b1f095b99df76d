"""decode_attention — one query token against a KV cache, as a
hand-written CUDA kernel.

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention`` (a
Pallas kernel for the TPU): for each (b, h) an f32 online softmax over the
keys below ``valid_len[b]``.  On the H100 it is bound by memory: every
valid K and V row is read once, ``B * KV * valid * hd * 2 * itemsize``
bytes at the card's bandwidth, and what keeps a kernel from that is too
little parallelism.  ``csrc/decode_attention.cu`` is split-KV
flash-decoding: a first kernel runs one block per (split of
:func:`split_keys` keys, b, KV head), serving all H/KV query heads of the
group from 16-byte loads of the cache read in place through its strides,
and writes an f32 partial (max, sum, accumulator) per (b, h, split) into
scratch this wrapper allocates; a second kernel combines the live splits.
The split and the number of splits come from the cache's capacity S,
not from its valid lengths, so nothing is read back from the card;
blocks past ``valid_len[b]`` return at once.  See the source for the
design.

:func:`decode_attention` launches the kernels for CUDA tensors (or raises)
and runs the plain version (:func:`~.ref.decode_ref`) only for CPU or meta
tensors.  ``decode_attention.launches`` counts the wrapper's launches (one
per call, for the two kernels).  On meta (the dry run's counting,
``repro_torch._counting``) the plain version is recorded and counted as it
always was, and what is booked as memory is the card's: the int32 copy of
``valid_len`` (none when it is one), the output and the splits' scratch.
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
SPLITS = (64, 128, 256, 512)   # the keys a first-pass block may take


def split_keys(S: int) -> int:
    """Keys per block of the first pass, from the cache's capacity alone
    (never from ``valid_len``, which lives on the card): the largest of
    :data:`SPLITS` at most S / 16, so a full row is spread over about 16
    blocks: 128 at the serve phases' 2048 rows, 512 at 8192.
    ``scripts/torch_decode_splits.py`` times every split at
    ``chip_smoke.py``'s decode shapes (PERF.md)."""
    split = SPLITS[0]
    for s in SPLITS[1:]:
        if 16 * s <= S:
            split = s
    return split


def scratch_like(q: torch.Tensor, S: int) -> torch.Tensor:
    """The first pass's f32 partials for q (B, H, hd) over a cache of
    capacity S: (max, sum, accumulator) a (b, h, split of
    :func:`split_keys` keys)."""
    B, H, hd = q.shape
    nsplit = -(-S // split_keys(S))
    return torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32,
                       device=q.device)


_FN = None


def _entry_point():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
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
    if q.device.type == "meta":
        with _counting.unbooked():
            out = ref.decode_ref(q, k, v, valid_len, scale=scale,
                                 block_k=block_k)
        with _counting.memory_only():     # what the launch holds beside it
            held = valid_len.to(torch.int32).contiguous(), \
                scratch_like(q, S)
        _counting.book(out)
        del held
        return out
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA (or the CPU), got "
                         f"{q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode_attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    valid = valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out          # a grid of 0 blocks is a launch error
    split = split_keys(S)
    scratch = scratch_like(q, S)
    item = k.element_size()
    vec = int(all(                        # every hd above is 16-byte rows
        t.data_ptr() % 16 == 0 and all(s * item % 16 == 0
                                       for s in t.stride()[:3])
        for t in (k, v)))
    err = _build.launch(
        _entry_point(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, KV, S,
        hd, split,
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
