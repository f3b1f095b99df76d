"""The port on a CUDA card: the CUDA kernel against its plain version, and
the transfer schemes' device paths (copy stream, pinned staging, event
fences) on real hardware.

Every test here needs a card and skips without one (the CUDA kernel has
no CPU mode).  The file imports neither JAX nor the reference package, so
it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import TransferSession, transfer_scheme, tree_leaves, tree_map
from repro_torch.kernels.marshal_pack import kernel as K
from repro_torch.kernels.marshal_pack import ops, ref
from repro_torch import scenarios as PS

pytestmark = pytest.mark.cuda

TILE = K.SUBLANE * K.LANE
SPECS = ("uvm", "marshal", "marshal+db", "marshal+delta", "pointerchain")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel and the device "
                    "paths have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_kernel_equals_plain_version(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    for n in (1, 4, 17, 1000):
        src = (torch.randn(n * K.SUBLANE, K.LANE, generator=gen) * 10
               ).to(dtype).to(cuda)
        tmap = torch.randperm(n, generator=gen).to(torch.int32).to(cuda)
        before = K.gather_tiles.launches
        got = K.gather_tiles(src, tmap)
        torch.cuda.synchronize(cuda)
        assert K.gather_tiles.launches == before + 1
        assert torch.equal(got, ref.pack_ref(src.reshape(-1), tmap, TILE)
                           .reshape(-1, K.LANE))


def test_empty_map_does_not_launch(cuda):
    before = K.gather_tiles.launches
    out = K.gather_tiles(torch.zeros(K.SUBLANE, K.LANE, device=cuda),
                         torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (0, K.LANE) and K.gather_tiles.launches == before


def test_pack_tree_round_trip(cuda):
    tree = {"a": torch.randn(10, 10), "b": [torch.randn(3, 700)]}
    before = K.gather_tiles.launches
    packed, meta = ops.pack_tree(tree)                 # default: the card
    out = ops.unpack_tree(packed, meta)
    assert packed.device == cuda and K.gather_tiles.launches == before + 2
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert torch.equal(a.cpu(), b)


def test_algorithm2_on_the_card(cuda):
    for sc in PS.iter_scenarios("smoke"):
        tree = sc.build()
        for spec in SPECS:
            m = PS.run_scenario(sc, spec, tree=tree)   # default: the card
            assert m.device == "cuda:0"
            assert m.ok and m.motion_ok, (sc.name, spec)


def test_steady_state_on_the_card(cuda):
    sc = PS.steady_reuse_case(2048)
    for m in PS.run_steady_scenario(sc, passes=3):
        assert m.ok and m.motion_ok
        assert (m.h2d_bytes, m.h2d_calls) == sc.steady_expected.as_tuple()


@pytest.mark.parametrize("spec", ["marshal+db", "marshal+delta"])
def test_fences_keep_in_flight_copies_intact(cuda, spec):
    """Three back-to-back non-blocking transfers of a 64 MiB tree: the
    third rewrites the first pass's pinned staging buffer, which is safe
    only because pack_host waits that buffer's fence first."""
    t = {"a": torch.randn(16 * 2 ** 20), "i": torch.arange(1024,
                                                           dtype=torch.int32)}
    s = transfer_scheme(spec, TransferSession())
    trees, devs = [], []
    for _ in range(3):
        trees.append(t)
        devs.append(s.to_device(t))
        t = tree_map(lambda x: x + 1, t)
    torch.cuda.synchronize(cuda)
    for tree, dev in zip(trees, devs):
        for a, b in zip(tree_leaves(dev), tree_leaves(tree)):
            assert a.device == cuda and torch.equal(a.cpu(), b)
