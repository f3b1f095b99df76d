"""Arena pack/unpack for trees through the tile-gather kernel.

Counterpart of ``repro/kernels/marshal_pack/ops.py``: Algorithm 1 done on
the device.  Leaves are padded to TILE elements and concatenated in leaf
order (the source pool); the tile maps come from the arena plan of the
tree at TILE alignment (the requestList), so the packed buffer has the
arena engine's slot order.  Pack and unpack are one kernel launch each —
the reference's ``unpack_tree`` ran its kernel in interpret mode; here both
directions launch the CUDA kernel.

The maps are built and checked on the host once per (layout, device) and
cached beside the layout.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ...core import arena as arena_lib
from ...core import engine as engine_lib
from ...core.arena import as_tensor
from ...core.treepath import tree_flatten
from . import kernel as K

TILE = K.TILE


def _pad_len(n: int) -> int:
    return -(-n // TILE) * TILE


def check_tile_map(tile_map: np.ndarray, n_src: int) -> None:
    """Every entry of a host-side map must name a source tile."""
    if tile_map.size and (int(tile_map.min()) < 0
                          or int(tile_map.max()) >= n_src):
        raise ValueError(f"tile map entries must lie in [0, {n_src})")


def build_tile_maps(shapes, layout: "arena_lib.ArenaLayout" = None
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """For a list of leaf shapes: (pack_map, unpack_map, n_tiles).

    Source pool: leaves concatenated in leaf order, each padded to a TILE
    multiple.  Packed layout: tiles in ARENA order (sorted by bucket, then
    offset) when a ``layout`` is given.  pack_map[i] is the source tile of
    packed tile i; unpack_map is the inverse permutation.
    """
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    tiles_per = [_pad_len(s) // TILE for s in sizes]
    n_tiles = sum(tiles_per)
    src_start = np.concatenate([[0], np.cumsum(tiles_per)]).astype(np.int64)
    if layout is not None:
        if len(layout.slots) != len(shapes):
            raise ValueError("layout does not match leaf shapes")
        order = sorted(range(len(shapes)),
                       key=lambda i: (layout.slots[i].bucket,
                                      layout.slots[i].offset))
    else:
        order = range(len(shapes))
    pack_map = np.concatenate(
        [np.arange(src_start[i], src_start[i] + tiles_per[i])
         for i in order]).astype(np.int32) if n_tiles else \
        np.zeros((0,), np.int32)
    unpack_map = np.argsort(pack_map).astype(np.int32)
    check_tile_map(pack_map, n_tiles)
    return pack_map, unpack_map, n_tiles


def flatten_to_pool(leaves, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Copy leaves (each padded to TILE) into a zeroed source pool on
    ``device``."""
    sizes = [as_tensor(l).numel() for l in leaves]
    pool = torch.zeros(sum(_pad_len(n) for n in sizes), dtype=dtype,
                       device=device)
    off = 0
    for leaf, n in zip(leaves, sizes):
        pool[off:off + n].copy_(as_tensor(leaf).reshape(-1))
        off += _pad_len(n)
    return pool


def pool_to_leaves(pool: torch.Tensor, shapes, dtype: torch.dtype):
    """Every leaf as a view of the pool."""
    out = []
    off = 0
    for s in shapes:
        n = int(np.prod(s)) if s else 1
        out.append(pool[off:off + n].view(s).to(dtype))
        off += _pad_len(n)
    return out


def pack_pool(pool: torch.Tensor, tile_map: torch.Tensor) -> torch.Tensor:
    """One kernel launch: gather source tiles into the packed arena."""
    return K.gather_tiles(pool.view(-1, K.LANE), tile_map).view(-1)


# layout -> {device: (pack_map, unpack_map)} on that device
_MAPS: "weakref.WeakKeyDictionary[arena_lib.ArenaLayout, Dict]" = \
    weakref.WeakKeyDictionary()


def _device_maps(layout, shapes, device: torch.device):
    per_device = _MAPS.setdefault(layout, {})
    maps = per_device.get(device)
    if maps is None:
        pack_map, unpack_map, _ = build_tile_maps(shapes, layout=layout)
        maps = per_device[device] = (torch.from_numpy(pack_map).to(device),
                                     torch.from_numpy(unpack_map).to(device))
    return maps


def pack_tree(tree: Any, *, device: DeviceLike = None,
              session: "engine_lib.TransferSession" = None
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Marshal a single-dtype tree into one contiguous buffer on ``device``
    (the CUDA card unless ``device="cpu"``).  Returns ``(packed, meta)``;
    :func:`unpack_tree` inverts it."""
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    tensors = [as_tensor(l) for l in leaves]
    dtype = tensors[0].dtype
    shapes = [tuple(t.shape) for t in tensors]
    layout = (session or engine_lib.get_session()).cached_plan(
        tree, align_elems=TILE)
    pack_map, unpack_map = _device_maps(layout, shapes, dev)
    pool = flatten_to_pool(tensors, dtype, dev)
    packed = pack_pool(pool, pack_map)
    meta = {"treedef": treedef, "shapes": shapes, "dtype": dtype,
            "layout": layout, "unpack_map": unpack_map}
    return packed, meta


def unpack_tree(packed: torch.Tensor, meta: Dict[str, Any]) -> Any:
    """Gather the packed arena back into leaf order (one kernel launch) and
    rebuild the tree as views of the result."""
    pool = pack_pool(packed, meta["unpack_map"])
    return meta["treedef"].unflatten(
        pool_to_leaves(pool, meta["shapes"], meta["dtype"]))
