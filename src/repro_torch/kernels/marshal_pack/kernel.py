"""marshal_pack — the paper's deep-copy hot spot as a hand-written CUDA kernel.

Replaces ``repro/kernels/marshal_pack/kernel.py::gather_tiles`` (a Pallas
kernel for the TPU): ``dst_tile[i] = src_tile[tile_map[i]]`` over tiles of
8 x 128 = 1024 elements.  The same kernel packs (gather by the map)
and unpacks (gather by the inverse map).

On the H100 it is pure data movement: every packed byte is read once and
written once, so its bound is 2 bytes moved per byte packed at the card's
memory bandwidth (plus 4 bytes of map per tile).  The kernel
(``csrc/gather_tiles.cu``) moves each tile, whatever its element type, as
one TMA bulk copy into shared memory and one back out, on a persistent grid
of ``BLOCKS_PER_SM`` one-warp blocks per SM, each keeping a ring of tiles in
flight; see the source for the design.  It is built with ``nvcc`` at first
use and bound with ``ctypes`` (:mod:`repro_torch.kernels._build`).

:func:`gather_tiles` launches the kernel for a CUDA tensor (or raises) and
runs the plain version (:func:`~.ref.pack_ref`) only for a CPU or a meta
tensor.  ``gather_tiles.launches`` counts the kernel's launches.  On meta
(the dry run's counting, ``repro_torch._counting``) the plain version is
recorded and counted as it always was, and what is booked as memory is the
card's: the output the kernel writes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import _counting
from .. import _build
from . import ref

# 8 rows x 128 lanes: the reference's tile, kept so tile maps are the same
LANE = 128
SUBLANE = 8
TILE = SUBLANE * LANE  # 1024 elements

SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_tiles.cu"

_ITEMSIZES = (2, 4)
BLOCKS_PER_SM = 4           # persistent blocks per SM, each 8 tiles in flight

_SMS = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _entry_point():
    fn = _build.load(SOURCE).gather_tiles
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: without argtypes ctypes
        # would pass a Python int as a 32-bit int and cut the pointer
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_tiles(src: torch.Tensor, tile_map: torch.Tensor) -> torch.Tensor:
    """dst_tile[i] = src_tile[tile_map[i]].

    src: (n_src_tiles * SUBLANE, LANE), contiguous, a 2- or 4-byte dtype;
    tile_map: (n_dst_tiles,) int32 on the same device, every entry in
    [0, n_src_tiles).  Returns (n_dst_tiles * SUBLANE, LANE).
    """
    if src.dim() != 2 or src.shape[1] != LANE or src.shape[0] % SUBLANE:
        raise ValueError(f"src must be (n_tiles*{SUBLANE}, {LANE}), "
                         f"got {tuple(src.shape)}")
    if tile_map.dim() != 1 or tile_map.dtype != torch.int32:
        raise ValueError(f"tile_map must be 1-D int32, got "
                         f"{tuple(tile_map.shape)} {tile_map.dtype}")
    if src.element_size() not in _ITEMSIZES:
        raise ValueError(f"gather_tiles moves 2- or 4-byte elements, "
                         f"got {src.dtype}")
    if tile_map.device != src.device:
        raise ValueError(f"tile_map on {tile_map.device}, src on {src.device}")
    if not (src.is_contiguous() and tile_map.is_contiguous()):
        raise ValueError("src and tile_map must be contiguous")
    n_src = src.shape[0] // SUBLANE
    n_dst = tile_map.shape[0]
    if src.device.type == "cpu":
        return ref.pack_ref(src.reshape(-1), tile_map, TILE).reshape(-1, LANE)
    if src.device.type == "meta":
        with _counting.unbooked():
            out = ref.pack_ref(src.reshape(-1), tile_map,
                               TILE).reshape(-1, LANE)
        _counting.book(out)
        return out
    if src.device.type != "cuda":
        raise ValueError(f"gather_tiles runs on CUDA (or the CPU), "
                         f"got {src.device}")
    out = torch.empty((n_dst * SUBLANE, LANE), dtype=src.dtype,
                      device=src.device)
    if n_dst == 0:
        return out          # a grid of 0 blocks is a launch error
    if src.data_ptr() % 16 or n_dst >= 2 ** 31:
        raise ValueError("src must be 16-byte aligned and the map shorter "
                         "than 2^31 tiles")
    fn = _entry_point()
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), out.data_ptr(), tile_map.data_ptr(),
                 n_src, n_dst, TILE * src.element_size(),
                 BLOCKS_PER_SM * _sm_count(src.device),
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather_tiles launch failed with CUDA error {err}")
    gather_tiles.launches += 1
    return out


gather_tiles.launches = 0
