"""The marshal_pack tile gather of the port held against the JAX package.

On the CPU the wrapper runs its plain version, which must equal the JAX
``ref.py`` and the Pallas kernel in interpret mode bit for bit (f32, bf16,
int32 at 1, 4 and 17 tiles).  The tile maps and the packed buffer of
``pack_tree`` must equal the reference's.  The CUDA kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.kernels.marshal_pack import kernel as r_kernel
from repro.kernels.marshal_pack import ops as r_ops
from repro.kernels.marshal_pack import ref as r_ref

from repro_torch.convert import from_reference_tree, to_reference_tree
from repro_torch.core import TransferSession, plan, tree_leaves
from repro_torch.kernels.marshal_pack import kernel as K
from repro_torch.kernels.marshal_pack import ops
from repro_torch.kernels.marshal_pack import ref

TILE = K.SUBLANE * K.LANE
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(f"u{a.dtype.itemsize}")


def _inputs(n_tiles, dtype, seed):
    rng = np.random.default_rng(seed)
    src = jnp.asarray(rng.standard_normal((n_tiles * K.SUBLANE, K.LANE)) * 10
                      ).astype(DTYPES[dtype])
    tmap = rng.permutation(n_tiles).astype(np.int32)
    return src, tmap


@pytest.mark.parametrize("n_tiles", [1, 4, 17])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_gather_equals_reference_and_interpret_kernel(n_tiles, dtype):
    src, tmap = _inputs(n_tiles, dtype, seed=n_tiles)
    want_ref = r_ref.pack_ref(src.reshape(-1), jnp.asarray(tmap), TILE)
    want_kernel = r_kernel.gather_tiles(src, jnp.asarray(tmap), interpret=True)
    p_src = from_reference_tree(np.asarray(src))
    got = K.gather_tiles(p_src, torch.from_numpy(tmap))
    got_np = to_reference_tree(got)
    assert got.dtype == p_src.dtype and got_np.shape == want_kernel.shape
    np.testing.assert_array_equal(_bits(got_np), _bits(want_kernel))
    np.testing.assert_array_equal(_bits(got_np.reshape(-1)), _bits(want_ref))
    # the inverse scatter undoes it, as the reference's does
    back = ref.unpack_ref(got.reshape(-1), torch.from_numpy(tmap), TILE,
                          n_tiles)
    want_back = r_ref.unpack_ref(want_ref, jnp.asarray(tmap), TILE, n_tiles)
    np.testing.assert_array_equal(_bits(to_reference_tree(back)),
                                  _bits(want_back))
    np.testing.assert_array_equal(_bits(to_reference_tree(back)),
                                  _bits(np.asarray(src).reshape(-1)))


def test_empty_map_gives_empty_output():
    src = torch.zeros(K.SUBLANE, K.LANE)
    out = K.gather_tiles(src, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, K.LANE)
    pack_map, unpack_map, n = ops.build_tile_maps([])
    assert n == 0 and pack_map.shape == unpack_map.shape == (0,)


@pytest.mark.parametrize("bad", ["shape", "map_dtype", "itemsize", "device",
                                 "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src = torch.zeros(2 * K.SUBLANE, K.LANE)
    tmap = torch.zeros(2, dtype=torch.int32)
    if bad == "shape":
        src = torch.zeros(K.SUBLANE + 1, K.LANE)
    elif bad == "map_dtype":
        tmap = tmap.long()
    elif bad == "itemsize":
        src = src.double()
    elif bad == "device":
        tmap = tmap.to("meta")
    else:
        src = torch.zeros(K.LANE, 2 * K.SUBLANE).t()
    with pytest.raises(ValueError):
        K.gather_tiles(src, tmap)


def test_tile_map_check_rejects_out_of_range():
    with pytest.raises(ValueError, match="tile map"):
        ops.check_tile_map(np.int32([0, 3]), 3)
    ops.check_tile_map(np.int32([2, 0, 1]), 3)


def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((10, 10)).astype(np.float32),
            "ids": np.arange(3000, dtype=np.int32),
            "b": {"c": rng.standard_normal((3, 700)).astype(np.float32),
                  "s": np.float32(2.5)}}


@pytest.mark.parametrize("align", [1, TILE])
def test_build_tile_maps_equal_reference(align):
    tree = _mixed_tree()
    shapes = [np.shape(l) for l in jax.tree_util.tree_leaves(tree)]
    want = r_ops.build_tile_maps(shapes, r_engine.arena_lib.plan(tree, align))
    got = ops.build_tile_maps(shapes, plan(from_reference_tree(tree), align))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0][got[1]], np.arange(got[2]))


def test_pack_tree_equals_reference_and_round_trips():
    tree = {"a": jnp.arange(100, dtype=jnp.float32).reshape(10, 10),
            "b": {"c": jnp.full((3, 700), 2.0, jnp.float32),
                  "d": jnp.asarray(np.random.default_rng(1)
                                   .standard_normal(2100), jnp.float32)}}
    want_packed, _ = r_ops.pack_tree(tree, interpret=True)
    port_tree = from_reference_tree(jax.tree_util.tree_map(np.asarray, tree))
    packed, meta = ops.pack_tree(port_tree, device="cpu",
                                 session=TransferSession())
    np.testing.assert_array_equal(_bits(packed.numpy()), _bits(want_packed))
    out = ops.unpack_tree(packed, meta)
    for a, b in zip(tree_leaves(out), tree_leaves(port_tree)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_pack_tree_maps_are_cached_per_layout():
    session = TransferSession()
    tree = {"a": torch.arange(3000, dtype=torch.float32)}
    _, m1 = ops.pack_tree(tree, device="cpu", session=session)
    _, m2 = ops.pack_tree({"a": torch.ones(3000)}, device="cpu",
                          session=session)
    assert m1["layout"] is m2["layout"]
    assert m1["unpack_map"] is m2["unpack_map"]
