"""The port on a CUDA card: each CUDA kernel against its plain version, and
the transfer schemes' device paths (copy stream, pinned staging, event
fences) on real hardware.

Every test here needs a card and skips without one (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the reference package, so
it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import TransferSession, transfer_scheme, tree_leaves, tree_map
from repro_torch.kernels.marshal_pack import kernel as K
from repro_torch.kernels.marshal_pack import ops, ref
from repro_torch import scenarios as PS
from repro_torch.kernels.decode_attention import kernel as DK, ref as DR
from repro_torch.kernels.flash_attention import kernel as FK, ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.rmsnorm import kernel as RK, ref as RR

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


# -- the model kernels against their plain versions, at the shapes of
# tests/test_kernels.py with its tolerances (bf16 2e-2, f32 2e-5) -----------

def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype).to(device)


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 256), (1000, 64),
                                   (7, 96), (5, 2048), (3, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_equals_plain_version(cuda, shape, dtype):
    rng = np.random.default_rng(7)
    x = _randn(rng, shape, dtype, cuda)
    w = _randn(rng, shape[-1:], dtype, cuda)
    before = RK.rmsnorm.launches
    got = RK.rmsnorm(x, w)
    torch.cuda.synchronize(cuda)
    assert RK.rmsnorm.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), RR.rmsnorm_ref(x, w).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (2, 4, 2, 256, 256, 64),
    (1, 8, 8, 128, 384, 128),
    (2, 4, 1, 256, 256, 64),
    (1, 2, 2, 96, 160, 64),
    (1, 32, 8, 1000, 1000, 64),
    (2, 4, 2, 33, 33, 16),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_equals_plain_version(cuda, B, H, KV, Sq, Sk, hd, causal,
                                           dtype):
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, Sq, H, hd), dtype, cuda)      # the model's layout
    k = _randn(rng, (B, Sk, KV, hd), dtype, cuda)
    v = _randn(rng, (B, Sk, KV, hd), dtype, cuda)
    for kv_len in (Sk, max(1, Sk - 37)):
        before = FK.flash_attention.launches
        got = FO.mha(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize(cuda)
        assert FK.flash_attention.launches == before + 1
        assert got.shape == q.shape and got.is_contiguous()
        want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                kv_len=kv_len).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (2, 4, 2, 512, 64),
    (3, 8, 1, 300, 128),
    (1, 16, 2, 2048, 64),
    (8, 32, 8, 2048, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_equals_plain_version(cuda, B, H, KV, S, hd, dtype):
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, H, hd), dtype, cuda)
    cache_k = _randn(rng, (B, S, KV, hd), dtype, cuda)   # one cache layer
    cache_v = _randn(rng, (B, S, KV, hd), dtype, cuda)
    valid = torch.from_numpy(rng.integers(1, S, size=(B,)).astype(np.int32)
                             ).to(cuda)
    valid[0] = S + 5                    # past the cache: every key counts
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    before = DK.decode_attention.launches
    got = DK.decode_attention(q, k, v, valid)
    torch.cuda.synchronize(cuda)
    assert DK.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               DR.decode_ref(q, k, v, valid).float(),
                               **_tol(dtype))


def test_decode_kernel_keeps_the_empty_row_value(cuda):
    """valid_len == 0: the Pallas kernel's sum(V[:S]) / (ceil(S/bk) * bk)."""
    rng = np.random.default_rng(3)
    B, H, KV, S, hd = 2, 4, 2, 300, 64
    q = _randn(rng, (B, H, hd), torch.float32, cuda)
    k = _randn(rng, (B, KV, S, hd), torch.float32, cuda)
    v = _randn(rng, (B, KV, S, hd), torch.float32, cuda)
    valid = torch.tensor([0, 17], dtype=torch.int32, device=cuda)
    got = DK.decode_attention(q, k, v, valid, block_k=128)
    want = DR.decode_ref(q, k, v, valid, block_k=128)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    empty = v[0].sum(dim=1) / 384.0                   # ceil(300/128)*128
    torch.testing.assert_close(got[0], empty.repeat_interleave(2, dim=0),
                               rtol=2e-5, atol=2e-5)


# -- the smoke llama and its Server on the card -------------------------------

def test_smoke_server_on_the_card_matches_the_cpu(cuda):
    """The smoke llama (f32) served on the card through the kernels gives
    the CPU's tokens (plain versions), with exact launch counts: 2L+1
    rmsnorm per forward, L flash per prefill, L decode per step."""
    from repro_torch.models import registry
    from repro_torch.runtime import Request, Server
    from repro_torch.core import tree_map

    api = registry.get("llama3.2-1b", smoke=True)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 257, n).astype(np.int32) for n in (9, 5, 17)]
    done = {}
    for dev, p in (("cpu", params), (cuda, tree_map(lambda t: t.to(cuda),
                                                    params))):
        server = Server(api, p, slots=2, max_seq=64, device=dev)
        for k in (RK.rmsnorm, FK.flash_attention, DK.decode_attention):
            k.launches = 0
        for i, prompt in enumerate(prompts):
            server.submit(Request(rid=i, prompt=prompt, max_new_tokens=6))
        done[str(dev)] = {r.rid: r.tokens_out for r in server.run(100)}
        server.tracker.assert_conserved()
    L, st = api.cfg.num_layers, server.stats
    assert RK.rmsnorm.launches == (2 * L + 1) * (st.prefill_requests
                                                 + st.decode_steps)
    assert FK.flash_attention.launches == L * st.prefill_requests
    assert DK.decode_attention.launches == L * st.decode_steps
    assert done["cuda:0"] == done["cpu"]
