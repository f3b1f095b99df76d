"""Plain PyTorch version of the marshal_pack tile gather.

Counterpart of ``repro/kernels/marshal_pack/ref.py``: given a flat source
pool and a per-tile source-index map, ``dst[i*T:(i+1)*T] =
src[map[i]*T:(map[i]+1)*T]`` (and the inverse scatter for unpack).  The
CPU path of :func:`~repro_torch.kernels.marshal_pack.kernel.gather_tiles`
runs it; ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def pack_ref(src: torch.Tensor, tile_map: torch.Tensor, tile: int) -> torch.Tensor:
    """src: (n_src_tiles*tile,), tile_map: (n_dst_tiles,) int32."""
    blocks = src.reshape(src.numel() // tile, tile)
    return blocks[tile_map.long()].reshape(-1)


def unpack_ref(dst: torch.Tensor, tile_map: torch.Tensor, tile: int,
               n_src_tiles: int) -> torch.Tensor:
    """Scatter packed tiles back to their source positions."""
    out = torch.zeros((n_src_tiles, tile), dtype=dst.dtype, device=dst.device)
    out[tile_map.long()] = dst.reshape(dst.numel() // tile, tile)
    return out.reshape(-1)
