"""The port on a CUDA card: each CUDA kernel against its plain version, and
the transfer schemes' device paths (copy stream, pinned staging, event
fences) on real hardware.

Every test here needs a card and skips without one (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the reference package, so
it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import os

# deterministic cuBLAS for the bit-identical restart test: read when the
# first cuBLAS handle is made, so set before any test runs a product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest
import torch

from repro_torch.core import TransferSession, transfer_scheme, tree_leaves, tree_map
from repro_torch.kernels.marshal_pack import kernel as K
from repro_torch.kernels.marshal_pack import ops, ref
from repro_torch import scenarios as PS
from repro_torch.kernels.decode_attention import kernel as DK, ref as DR
from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.flash_attention import kernel as FK, ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.rmsnorm import kernel as RK, ref as RR
from repro_torch.kernels.ssd_scan import kernel as SK, ops as SO
from repro_torch.kernels.ssd_scan import ref as SR

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


@pytest.mark.parametrize("n", [1, 131, 132, 133, 4 * 132 + 5, 2 ** 18 + 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_around_the_persistent_grid(cuda, n, dtype):
    """Tile counts below, at and just past one and several blocks per SM
    (4 KiB f32 and 2 KiB bf16 tiles), up to 2^18 + 7 tiles, by a random
    permutation: bit-exact against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    src = torch.randn(n * K.SUBLANE, K.LANE, generator=gen,
                      device=cuda).to(dtype)
    tmap = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
    before = K.gather_tiles.launches
    got = K.gather_tiles(src, tmap)
    torch.cuda.synchronize(cuda)
    assert K.gather_tiles.launches == before + 1
    assert torch.equal(got, ref.pack_ref(src.reshape(-1), tmap, TILE)
                       .reshape(-1, K.LANE))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_kernel_with_repeated_entries(cuda, dtype):
    """A map that names some source tiles many times and others never."""
    rng = np.random.default_rng(3)
    n_src, n_dst = 97, 1500
    src = _randn(rng, (n_src * K.SUBLANE, K.LANE), torch.float32, cuda)
    src = (src * 100).to(dtype)
    tmap = torch.from_numpy(rng.integers(0, n_src, n_dst).astype(np.int32)
                            ).to(cuda)
    got = K.gather_tiles(src, tmap)
    torch.cuda.synchronize(cuda)
    assert torch.equal(got, ref.pack_ref(src.reshape(-1), tmap, TILE)
                       .reshape(-1, K.LANE))


def test_kernel_skips_out_of_range_entries(cuda):
    """Entries outside [0, n_src) write nothing and fault nothing; every
    in-range tile still equals the plain version."""
    rng = np.random.default_rng(4)
    n_src, n_dst = 300, 700
    src = _randn(rng, (n_src * K.SUBLANE, K.LANE), torch.float32, cuda)
    m = rng.integers(0, n_src, n_dst).astype(np.int32)
    bad = rng.random(n_dst) < 0.2
    m[bad] = rng.choice(np.array([-1, -7, n_src, n_src + 5, 2 ** 31 - 1],
                                 np.int32), bad.sum())
    tmap = torch.from_numpy(m).to(cuda)
    got = K.gather_tiles(src, tmap)
    torch.cuda.synchronize(cuda)
    ok = torch.from_numpy(~bad).to(cuda)
    want = ref.pack_ref(src.reshape(-1), tmap.clamp(0, n_src - 1), TILE)
    assert torch.equal(got.view(n_dst, -1)[ok], want.view(n_dst, -1)[ok])


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


# -- the policy scenarios on the card ----------------------------------------

def _region_motion(m):
    return {k: (r["h2d_bytes"], r["h2d_calls"]) for k, r in m.regions.items()}


@pytest.mark.parametrize("executor", ["blocking", "async"])
@pytest.mark.parametrize("family", ["mixed_policy", "elastic"])
def test_policy_scenario_on_the_card(cuda, family, executor):
    """Cold, then two passes after the scenario's mutation: every region
    ledger equal to its closed form, one synchronize a pass, staged values
    equal to the host tree."""
    sc = PS.iter_scenarios("smoke", only=[family])[0]
    ms = PS.run_policy_scenario(sc, passes=3, executor=executor,
                                session=TransferSession())
    assert all(m.ok and m.motion_ok and m.syncs == 1 for m in ms)
    assert _region_motion(ms[0]) == {k: v.as_tuple() for k, v in
                                     sc.region_expected.items()}
    for m in ms[1:]:
        assert _region_motion(m) == {k: v.as_tuple() for k, v in
                                     sc.steady_region_expected.items()}


def test_algorithm2_over_a_policy_on_the_card(cuda):
    for family in ("mixed_policy", "elastic"):
        sc = PS.iter_scenarios("smoke", only=[family])[0]
        tree = sc.build()
        for policy in (sc.declared_policy,
                       "params/**=uvm; opt/**=marshal+delta; **=pointerchain"):
            m = PS.run_algorithm2(tree, list(sc.used_paths), policy=policy)
            assert m.ok and m.scheme == "policy" and m.device == "cuda:0"
        program = TransferSession().compile(tree, sc.policy())
        m = PS.run_algorithm2(tree, list(sc.used_paths), program=program)
        assert m.ok and m.h2d_bytes == sum(
            v.h2d_bytes for v in sc.region_expected.values())


def test_full_deepcopy_policy_equals_a_program_pass_on_the_card(cuda):
    from repro_torch.core import full_deepcopy

    for family in ("mixed_policy", "elastic"):
        sc = PS.iter_scenarios("smoke", only=[family])[0]
        tree = sc.build()
        want = full_deepcopy(tree, policy=sc.policy())
        got = TransferSession().compile(tree, sc.policy()).to_device(tree)
        torch.cuda.synchronize(cuda)
        for a, b, h in zip(tree_leaves(want), tree_leaves(got),
                           tree_leaves(tree)):
            assert a.device == b.device == cuda
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert torch.equal(a.cpu(), h)


# -- the static analysis on the card -----------------------------------------

def test_calibration_on_the_card(cuda):
    from repro_torch.analysis.cost import CostModel

    model = CostModel.calibrate()
    assert model.calibrated and model.latency_us > 0
    assert model.bandwidth_gbps > 0
    assert [b for b, _ in model.probes] == [1 << 16, 1 << 20, 1 << 22]
    assert all(us > 0 for _, us in model.probes)
    assert CostModel.calibrate(sizes=(1 << 16, 1 << 18), repeats=1,
                               device=cuda).calibrated


@pytest.mark.parametrize("name", [sc.name for sc in
                                  PS.iter_scenarios("smoke")])
def test_static_prediction_equals_the_card_ledger(cuda, name):
    """policy_cost of the signature tree == the card's region ledgers, cold
    and steady, under the declared policy (marshal where none)."""
    from repro_torch.analysis.cost import policy_cost, signature_tree
    from repro_torch.core import TransferPolicy

    sc = {s.name: s for s in PS.iter_scenarios("smoke")}[name]
    tree = sc.build()
    policy = sc.policy() or TransferPolicy.of("marshal")
    cost = policy_cost(signature_tree(tree), policy,
                       sc.steady_mutate_paths())
    ms = PS.run_policy_scenario(sc, policy, tree=tree, passes=2,
                                session=TransferSession())
    assert all(m.ok and m.motion_ok for m in ms)
    assert _region_motion(ms[0]) == {r.key: r.cold.as_tuple()
                                     for r in cost.regions}
    assert _region_motion(ms[1]) == {r.key: r.steady.as_tuple()
                                     for r in cost.regions}


def test_the_live_mesh_is_the_card_count(cuda):
    from repro_torch.analysis import check

    live = check.check_registry("smoke", mesh_size=None)
    count = torch.cuda.device_count()
    assert check._live_device_count() == count
    assert live == check.check_registry("smoke", mesh_size=count)
    if count == 1:
        assert live == check.check_registry("smoke", mesh_size=1)
    assert not [d for ds in live.values() for d in ds if d.is_error]


def test_policy_pass_enqueues_without_a_sync(cuda):
    """A warm program pass over pinned staging, a delta region and a
    pointerchain region: every region packs and enqueues under
    sync_debug_mode "error" (no host read, no stream synchronize), and the
    pass's one barrier waits after it."""
    from repro_torch.core import TreePath

    for case in (PS.mixed_policy_case, PS.elastic_case):
        sc = case(2 ** 16, 1)
        tree = sc.build()
        program = TransferSession().compile(tree, sc.policy())
        program.to_device(tree)                       # cold: staging made
        tp = TreePath.parse(sc.steady_mutate_paths()[0])
        mutated = tp.set(tree, tp.resolve(tree) + 1)
        program.reset_ledgers()
        torch.cuda.synchronize(cuda)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fut = program.to_device_async(mutated)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        dev = fut.result()
        assert program.last_stats.syncs == 1
        assert {k: (l.h2d_bytes, l.h2d_calls)
                for k, l in program.ledgers.items()} == \
            {k: v.as_tuple()
             for k, v in sc.steady_region_expected.items()}
        for a, b in zip(tree_leaves(dev), tree_leaves(mutated)):
            assert torch.equal(a.cpu(), b)


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


def test_session_counts_its_pinned_staging(cuda):
    """A CUDA target's marshal entry holds two pinned buffers per dtype
    bucket; clearing the session lets them go."""
    session = TransferSession()
    tree = {"a": torch.ones(300), "b": torch.zeros(7, dtype=torch.int32)}
    program = session.compile(tree, "**=marshal", device=cuda)
    program.to_device(tree)
    torch.cuda.synchronize(cuda)
    assert session.pinned_bytes() == 2 * (300 * 4 + 7 * 4)
    program.clear()
    session.clear()
    assert session.pinned_bytes() == 0


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


# the rows and widths the main path launches rmsnorm with (chip_smoke
# phase 3's grid), then the edges of its launch plan: 1 row, rows that are
# not a multiple of a CTA's rows, rows that are not 16-byte aligned, rows
# above 8 KB (a CTA a row) and above 64 KB (the strided loop)
RMS_PATH_SHAPES = [((r, d), torch.bfloat16) for d in (2048, 2560, 3072)
                   for r in (8, 938, 1024, 4096)] + [((1024, 2048),
                                                      torch.float32)]
RMS_EDGE_SHAPES = [((1, 2048), torch.bfloat16), ((939, 2560), torch.bfloat16),
                   ((5, 2047), torch.bfloat16), ((3, 2050), torch.float32),
                   ((7, 8192), torch.bfloat16), ((300, 5120), torch.float32),
                   ((2, 65536), torch.bfloat16)]
RMS_BF16_MAX_ERR = 0.03125      # one bf16 ulp at [4, 8)


@pytest.mark.parametrize("shape,dtype", RMS_PATH_SHAPES + RMS_EDGE_SHAPES)
def test_rmsnorm_at_the_path_shapes_and_the_plans_edges(cuda, shape, dtype):
    rng = np.random.default_rng(11)
    x = _randn(rng, shape, dtype, cuda)
    w = _randn(rng, shape[-1:], dtype, cuda)
    before = RK.rmsnorm.launches
    got = RK.rmsnorm(x, w)
    torch.cuda.synchronize(cuda)
    assert RK.rmsnorm.launches == before + 1
    want = RR.rmsnorm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == torch.bfloat16:
        assert float((got.float() - want.float()).abs().max()) \
            <= RMS_BF16_MAX_ERR


@pytest.mark.parametrize("shape,dtype", RMS_PATH_SHAPES)
def test_rmsnorm_row_path_equals_the_strided_loop_bit_for_bit(
        cuda, shape, dtype):
    """The row path keeps the reduction order of the one-block-a-row
    kernel, which the strided path still is: forced onto the strided path,
    the same inputs give the same bits."""
    rng = np.random.default_rng(13)
    x = _randn(rng, shape, dtype, cuda)
    w = _randn(rng, shape[-1:], dtype, cuda)
    item = x.element_size()
    assert RK._plan(x.numel() // shape[-1], shape[-1], item, True).path \
        == "row"
    got = RK.rmsnorm(x, w)
    assert torch.equal(got, RK._launch(x, w, 1e-6, strided=True))


def test_rmsnorm_on_a_pointer_off_16_bytes(cuda):
    """A contiguous x that starts 2 bytes past a 16-byte boundary takes
    the strided scalar path and equals the plain version."""
    rng = np.random.default_rng(12)
    rows, D = 9, 2048
    flat = _randn(rng, (rows * D + 8,), torch.bfloat16, cuda)
    x = flat[1:1 + rows * D].view(rows, D)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert RK._plan(rows, D, 2, False).path == "strided"
    w = _randn(rng, (D,), torch.bfloat16, cuda)
    got = RK.rmsnorm(x, w)
    want = RR.rmsnorm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    assert float((got.float() - want.float()).abs().max()) \
        <= RMS_BF16_MAX_ERR


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
    short = torch.full((B,), max(1, Sk - 37), dtype=torch.int32, device=cuda)
    for kv_len in (None, short):        # every key, and a per-batch length
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


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,offsets,lens", [
    (2, 4, 2, 7, 32, 16, (0, 9), (7, 16)),
    (3, 8, 2, 70, 300, 64, (3, 64, 230), (73, 134, 300)),
    (2, 32, 32, 200, 2048, 80, (0, 900), (200, 1100)),
    (1, 4, 4, 33, 33, 80, (0,), (33,)),
    (2, 4, 1, 5, 130, 128, (125, 2), (130, 1)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_with_q_offset_equals_plain_version(
        cuda, B, H, KV, Sq, Sk, hd, offsets, lens, dtype):
    """Per-batch query offsets and key lengths (as a prefill at a nonzero
    cache position passes them), and head dim 80 (zamba2's)."""
    rng = np.random.default_rng(Sq)
    q = _randn(rng, (B, Sq, H, hd), dtype, cuda)
    k = _randn(rng, (B, Sk, KV, hd), dtype, cuda)
    v = _randn(rng, (B, Sk, KV, hd), dtype, cuda)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = FK.flash_attention.launches
    got = FO.mha(q, k, v, causal=True, kv_len=kl, q_offset=off)
    torch.cuda.synchronize(cuda)
    assert FK.flash_attention.launches == before + 1
    want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, kv_len=kl,
                            q_offset=off).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_kernel_offset_row_zero_still_sees_key_zero(cuda):
    """kv_len 1 at a nonzero offset, and a length below 1 or an offset
    below 0 (clamped): each row attends to key 0 alone."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (2, 3, 2, 16), torch.float32, cuda)
    k = _randn(rng, (2, 70, 2, 16), torch.float32, cuda)
    v = _randn(rng, (2, 70, 2, 16), torch.float32, cuda)
    got = FO.mha(q, k, v, causal=True,
                 kv_len=torch.tensor([1, 0], dtype=torch.int32, device=cuda),
                 q_offset=torch.tensor([65, -4], dtype=torch.int32,
                                       device=cuda))
    for b in range(2):
        torch.testing.assert_close(got[b], v[b, :1].expand(3, 2, 16),
                                   rtol=1e-6, atol=1e-6)


# -- the tensor-core flash kernel (bf16) and the split-KV decode kernel at
# their edges: lengths that are not multiples of 64, every head dim, GQA
# groups of 1, 4 and 8, valid lengths on both sides of a split -------------

@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (63, 63), (65, 65), (938, 938),
                                   (65, 938)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_at_ragged_lengths(cuda, hd, Sq, Sk, causal):
    rng = np.random.default_rng(hd + Sq + Sk)
    for H, KV in ((4, 4), (8, 2), (8, 1)):                 # g = 1, 4, 8
        q = _randn(rng, (2, Sq, H, hd), torch.bfloat16, cuda)
        k = _randn(rng, (2, Sk, KV, hd), torch.bfloat16, cuda)
        v = _randn(rng, (2, Sk, KV, hd), torch.bfloat16, cuda)
        before = FK.flash_attention.launches
        got = FO.mha(q, k, v, causal=causal)
        torch.cuda.synchronize(cuda)
        assert FK.flash_attention.launches == before + 1
        want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal
                                ).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])
def test_flash_bf16_kernel_at_offsets(cuda, hd, H, KV):
    """Per-batch offsets and lengths; batch 2's row 0 sits at offset 65
    with one valid key and batch 3's offset and length are clamped: both
    attend to key 0 alone."""
    rng = np.random.default_rng(hd * H)
    q = _randn(rng, (4, 70, H, hd), torch.bfloat16, cuda)
    k = _randn(rng, (4, 938, KV, hd), torch.bfloat16, cuda)
    v = _randn(rng, (4, 938, KV, hd), torch.bfloat16, cuda)
    off = torch.tensor([3, 868, 65, -4], dtype=torch.int32, device=cuda)
    kl = torch.tensor([73, 938, 1, 0], dtype=torch.int32, device=cuda)
    got = FO.mha(q, k, v, causal=True, kv_len=kl, q_offset=off)
    want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, kv_len=kl,
                            q_offset=off).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    key0 = v[2:, :1].repeat_interleave(H // KV, dim=2).expand(2, 70, H, hd)
    torch.testing.assert_close(got[2:], key0, rtol=0, atol=0)


def test_flash_bf16_kernel_refuses_misaligned_input(cuda):
    """The bf16 kernel copies 16-byte rows: an odd base pointer or a row
    stride that is not a multiple of 8 elements raises, before any launch
    and without running the FMA kernel or the plain version."""
    q = torch.randn(1, 2, 70, 64, device=cuda).to(torch.bfloat16)
    flat = torch.randn(2 * 70 * 64 + 1, device=cuda).to(torch.bfloat16)
    shifted = flat[1:].view(1, 2, 70, 64)                  # 2 bytes off
    padded = torch.randn(1, 2, 70, 68, device=cuda).to(torch.bfloat16)[..., :64]
    before = FK.flash_attention.launches
    for k in (shifted, padded):
        with pytest.raises(ValueError, match="16-byte"):
            FK.flash_attention(q, k, k)
    assert FK.flash_attention.launches == before
    # the f32 kernel reads elements one by one and takes such strides
    FK.flash_attention(q.float(), padded.float(), padded.float())
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("hd", [64, 80, 96])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])              # g = 1, 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_across_split_boundaries(cuda, hd, H, KV, dtype):
    """valid_len in {0, 1, split - 1, split, split + 1, S, S + 5}, the split
    being the one the wrapper takes at this shape."""
    B, S = 7, 600
    split = DK.split_keys(S)
    rng = np.random.default_rng(hd + H)
    valid = torch.tensor([0, 1, split - 1, split, split + 1, S, S + 5],
                         dtype=torch.int32, device=cuda)
    q = _randn(rng, (B, H, hd), dtype, cuda)
    cache_k = _randn(rng, (B, S, KV, hd), dtype, cuda)
    cache_v = _randn(rng, (B, S, KV, hd), dtype, cuda)
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    before = DK.decode_attention.launches
    got = DK.decode_attention(q, k, v, valid)
    torch.cuda.synchronize(cuda)
    assert DK.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               DR.decode_ref(q, k, v, valid).float(),
                               **_tol(dtype))
    empty = v[0].float().sum(dim=1) / DR.empty_denominator(S)
    torch.testing.assert_close(got[0].float(),
                               empty.repeat_interleave(H // KV, dim=0),
                               **_tol(dtype))


def test_attention_wrappers_read_nothing_back(cuda):
    """Under sync_debug_mode "error" a host read of a device tensor
    (valid_len, kv_len, q_offset) raises: neither wrapper makes one."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (2, 70, 8, 64), torch.bfloat16, cuda)
    kv = _randn(rng, (2, 300, 2, 64), torch.bfloat16, cuda)
    lens = torch.tensor([0, 200], dtype=torch.int32, device=cuda)
    FO.mha(q, kv, kv, causal=True, kv_len=lens, q_offset=lens)   # built
    DK.decode_attention(q[:, 0], kv.transpose(1, 2), kv.transpose(1, 2), lens)
    torch.cuda.synchronize(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            FO.mha(q, kv, kv, causal=True, kv_len=lens, q_offset=lens)
            DK.decode_attention(q[:, 0], kv.transpose(1, 2),
                                kv.transpose(1, 2), lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda)


# -- the SSD chunk kernel: y within the kernel tolerances (bf16 2e-2, f32
# 1e-4, test_kernels.py's SSD tolerance), the f32 states and cum within
# 1e-3 in bf16 and 1e-4 in f32 ----------------------------------------------

def _ssd_inputs(rng, B, S, nh, hd, N, dtype, device):
    """Model-layout x (B, S, nh, hd), dt > 0 and A < 0 as
    tests/test_kernels.py draws them, Bm/Cm (B, S, N)."""
    x = _randn(rng, (B, S, nh, hd), dtype, device)
    dt = torch.from_numpy((np.abs(rng.standard_normal((B, S, nh))) * 0.1
                           + 0.01).astype(np.float32)).to(device)
    A = torch.from_numpy((-np.abs(rng.standard_normal(nh)) - 0.1
                          ).astype(np.float32)).to(device)
    return (x, dt, A, _randn(rng, (B, S, N), dtype, device),
            _randn(rng, (B, S, N), dtype, device))


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", [
    (2, 64, 3, 8, 4, 16),
    (1, 128, 2, 16, 8, 32),
    (2, 32, 1, 8, 16, 8),
    (1, 37, 2, 8, 4, 256),            # one chunk of 37 steps
    (1, 1, 3, 16, 8, 256),            # one step
    (1, 512, 8, 64, 128, 256),        # mamba2's widths
    (2, 300, 5, 64, 64, 100),         # zamba2's state width, a ragged tile
    (1, 128, 4, 64, 128, 64),         # Q = 64: one query tile a chunk
    (1, 130, 4, 64, 128, 65),         # Q = 65: a one-row second tile
    (1, 510, 3, 64, 64, 255),         # Q = 255
    (1, 2048, 4, 64, 128, 1024),      # Q = 1024, the largest chunk
    (1, 512, 3, 80, 64, 256),         # hd 80 (zamba2's attention width)
    (1, 512, 2, 128, 128, 256),       # hd 128
    (1, 512, 2, 64, 256, 256),        # N 256, the largest state
    (1, 512, 80, 64, 64, 256),        # zamba2's 80 heads: a partial group
    (1, 512, 20, 64, 64, 256),        # zamba2's heads a member on (1, 4)
    (1, 512, 5, 64, 64, 256),         # and on 16: a part-filled group
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_equals_plain_version(cuda, B, S, nh, hd, N, chunk, dtype):
    """The chunk kernel on the strided views ops.ssd_chunked_kernel passes
    it, against the plain version on the same views."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(S), B, S, nh, hd,
                                   N, dtype, cuda)
    Q = min(chunk, S)
    nc = S // Q
    xc = x.reshape(B, nc, Q, nh, hd).transpose(2, 3)
    dtc = dt.reshape(B, nc, Q, nh).transpose(2, 3)[:, :, :, None, :]
    dtA = (dt * A).reshape(B, nc, Q, nh).transpose(2, 3)[:, :, :, None, :]
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    before = SK.ssd_chunks.launches
    got = SK.ssd_chunks(xc, dtc, dtA, Bc, Cc)
    torch.cuda.synchronize(cuda)
    assert SK.ssd_chunks.launches == before + 1
    want = SR.ssd_chunks_ref(xc, dtc, dtA, Bc, Cc)
    y_tol = _tol(dtype) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    f32_tol = dict(rtol=1e-3, atol=1e-3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    torch.testing.assert_close(got[0].float(), want[0].float(), **y_tol)
    torch.testing.assert_close(got[1], want[1], **f32_tol)
    torch.testing.assert_close(got[2], want[2], **f32_tol)
    # and the whole scan on the card against the CPU's
    y, st = SO.ssd_chunked_kernel(x, dt, A, Bm, Cm, chunk)
    cy, cst = SO.ssd_chunked_kernel(*(t.cpu() for t in (x, dt, A, Bm, Cm)),
                                    chunk)
    torch.testing.assert_close(y.cpu().float(), cy.float(), **y_tol)
    torch.testing.assert_close(st.cpu(), cst, **f32_tol)


def test_ssd_kernel_never_overflows_above_the_diagonal(cuda):
    rng = np.random.default_rng(11)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 64, 2, 8, 4, torch.float32, cuda)
    dt = dt * 400.0                    # exp(cum_i - cum_j) overflows for i < j
    y, st = SO.ssd_chunked_kernel(x, dt, A, Bm, Cm, 64)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    cy, cst = SO.ssd_chunked_kernel(*(t.cpu() for t in (x, dt, A, Bm, Cm)),
                                    64)
    torch.testing.assert_close(y.cpu(), cy, rtol=1e-4, atol=1e-4)


# -- the smoke models and their Server on the card ---------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "zamba2-2.7b", "starcoder2-3b",
                                  "granite-3-8b", "qwen1.5-110b",
                                  "moonshot-v1-16b-a3b", "arctic-480b"])
def test_smoke_server_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model (f32) served on the card through the kernels gives
    the CPU's tokens (plain versions), with exact launch counts."""
    from repro_torch.models import lm, registry
    from repro_torch.runtime import Request, Server
    from repro_torch.core import tree_map

    api = registry.get(arch, smoke=True)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 257, n).astype(np.int32) for n in (9, 5, 17)]
    kernels = {"rmsnorm": RK.rmsnorm, "flash_attention": FK.flash_attention,
               "decode_attention": DK.decode_attention,
               "ssd_chunks": SK.ssd_chunks}
    done = {}
    for dev, p in (("cpu", params), (cuda, tree_map(lambda t: t.to(cuda),
                                                    params))):
        server = Server(api, p, slots=2, max_seq=64, device=dev)
        for k in kernels.values():
            k.launches = 0
        for i, prompt in enumerate(prompts):
            server.submit(Request(rid=i, prompt=prompt, max_new_tokens=6))
        done[str(dev)] = {r.rid: r.tokens_out for r in server.run(100)}
        server.tracker.assert_conserved()
    st = server.stats
    assert {n: k.launches for n, k in kernels.items()} == lm.kernel_launches(
        api.cfg, st.prefill_requests, st.decode_steps)
    assert done["cuda:0"] == done["cpu"]


# -- head dim 128 at the GQA groups of the attention variants: 12 query
# heads a KV head (starcoder2: the decode kernel's second head group is
# part-filled), 8 (qwen), 7 (arctic: a part-filled group of 8), 4
# (granite), 1 (moonshot) ----------------------------------------------------

HD128_GROUPS = [(24, 2), (64, 8), (56, 8), (32, 8), (16, 16)]


@pytest.mark.parametrize("H,KV", HD128_GROUPS)
def test_flash_bf16_kernel_at_head_dim_128(cuda, H, KV):
    """As prefill calls it: a 938-token prompt against the first rows of a
    2048-row cache layer, and two rows at per-batch offsets (one a
    continuation at 300) with ragged valid lengths."""
    rng = np.random.default_rng(H * 100 + KV)
    hd = 128
    for B, Sq, off, kl in ((1, 938, [0], [938]),
                           (2, 65, [0, 300], [65, 365])):
        q = _randn(rng, (B, Sq, H, hd), torch.bfloat16, cuda)
        ck = _randn(rng, (B, 2048, KV, hd), torch.bfloat16, cuda)
        cv = _randn(rng, (B, 2048, KV, hd), torch.bfloat16, cuda)
        off = torch.tensor(off, dtype=torch.int32, device=cuda)
        kl = torch.tensor(kl, dtype=torch.int32, device=cuda)
        before = FK.flash_attention.launches
        got = FO.mha(q, ck, cv, causal=True, kv_len=kl, q_offset=off)
        torch.cuda.synchronize(cuda)
        assert FK.flash_attention.launches == before + 1
        want = FR.attention_ref(q.transpose(1, 2), ck.transpose(1, 2),
                                cv.transpose(1, 2), causal=True, kv_len=kl,
                                q_offset=off).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("H,KV", HD128_GROUPS)
def test_decode_bf16_kernel_at_head_dim_128(cuda, H, KV):
    """Eight slots of a 2048-row cache layer read in place, valid lengths
    0, 1, on both sides of a split, the whole layer and past it."""
    rng = np.random.default_rng(H + KV)
    B, S, hd = 8, 2048, 128
    split = DK.split_keys(S)
    valid = torch.tensor([0, 1, split - 1, split + 1, 938, 1000, S, S + 5],
                         dtype=torch.int32, device=cuda)
    q = _randn(rng, (B, 1, H, hd), torch.bfloat16, cuda)
    ck = _randn(rng, (B, S, KV, hd), torch.bfloat16, cuda)
    cv = _randn(rng, (B, S, KV, hd), torch.bfloat16, cuda)
    before = DK.decode_attention.launches
    got = DO.decode_mha(q, ck, cv, valid)[:, 0]
    torch.cuda.synchronize(cuda)
    assert DK.decode_attention.launches == before + 1
    want = DR.decode_ref(q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2),
                         valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# -- the kernel wrappers write only into what they allocate -----------------

def test_kernel_wrappers_leave_their_inputs_unchanged(cuda):
    """Each wrapper's inputs, as the model passes them (strided cache
    views included), keep their bytes and their version counter: no
    kernel writes through an input's data_ptr(), a write the counter
    could not see (so a marshal+delta pass could not either)."""
    rng = np.random.default_rng(21)
    bf = torch.bfloat16
    ck = _randn(rng, (2, 256, 2, 128), bf, cuda)
    cv = _randn(rng, (2, 256, 2, 128), bf, cuda)
    lens = torch.tensor([40, 200], dtype=torch.int32, device=cuda)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 512, 4, 64, 128, bf, cuda)
    xc = x.reshape(1, 2, 256, 4, 64).transpose(2, 3)
    dtc = dt.reshape(1, 2, 256, 4).transpose(2, 3)[:, :, :, None, :]
    dtA = (dt * A).reshape(1, 2, 256, 4).transpose(2, 3)[:, :, :, None, :]
    src = _randn(rng, (64 * K.SUBLANE, K.LANE), torch.float32, cuda)
    tmap = torch.from_numpy(rng.permutation(64).astype(np.int32)).to(cuda)
    cases = {
        "gather_tiles": (K.gather_tiles, (src, tmap), {}),
        "rmsnorm": (RK.rmsnorm, (_randn(rng, (8, 2048), bf, cuda),
                                 _randn(rng, (2048,), bf, cuda)), {}),
        "flash_attention": (FO.mha, (_randn(rng, (2, 37, 24, 128), bf, cuda),
                                     ck, cv),
                            dict(causal=True, kv_len=lens, q_offset=lens - 37)),
        "decode_attention": (DK.decode_attention,
                             (_randn(rng, (2, 24, 128), bf, cuda),
                              ck.transpose(1, 2), cv.transpose(1, 2), lens),
                             {}),
        "ssd_chunks": (SK.ssd_chunks,
                       (xc, dtc, dtA, Bm.reshape(1, 2, 256, 128),
                        Cm.reshape(1, 2, 256, 128)), {}),
    }
    for name, (fn, args, kw) in cases.items():
        ins = [t for t in (*args, *kw.values())
               if isinstance(t, torch.Tensor)]
        saved = [(t.clone(), t._version) for t in ins]
        fn(*args, **kw)
        torch.cuda.synchronize(cuda)
        for i, (t, (copy, version)) in enumerate(zip(ins, saved)):
            assert t._version == version, f"{name} input {i}: version moved"
            assert torch.equal(t, copy), f"{name} input {i}: bytes changed"


# -- marshal+delta after an in-place write on the card -----------------------

def test_delta_pass_after_an_in_place_write_returns_the_host_values(cuda):
    """The returned leaves are views of the retained device buckets: after
    a write to one (a kernel's output would be another tensor; this is the
    caller's own in-place op), the next pass re-ships that bucket alone,
    the pass after it none, and a program's delta region does the same on
    a pass where the host changed another bucket."""
    from repro_torch.core import TransferPolicy

    rng = np.random.default_rng(2)
    tree = {"a": torch.from_numpy(rng.standard_normal(300).astype(
                np.float32)),
            "b": torch.arange(40, dtype=torch.int32),
            "c": torch.from_numpy(rng.standard_normal(64).astype(
                np.float32)).to(torch.bfloat16)}
    s = transfer_scheme("marshal+delta", TransferSession(), device=cuda)
    dev = s.to_device(tree)
    bb = s.layout.bucket_bytes()
    dev["a"].mul_(1.5)
    s.ledger.reset()
    again = s.to_device(tree)
    for key in tree:
        assert torch.equal(again[key].cpu(), tree[key]), key
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (bb["float32"], 1)
    s.ledger.reset()
    s.to_device(tree)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (0, 0)

    host = {"cache": tree, "params": {"w": torch.ones(16)}}
    prog = TransferSession().compile(
        host, TransferPolicy.parse("cache/**=marshal+delta; **=marshal"),
        device=cuda)
    dev = prog.to_device(host)
    dev["cache"]["b"].index_fill_(0, torch.tensor([3], device=cuda), -1)
    host["cache"] = dict(tree, c=tree["c"] + 1)
    before = prog.ledgers["cache/**"].h2d_bytes
    got = prog.to_device(host)
    for key in tree:
        assert torch.equal(got["cache"][key].cpu(), host["cache"][key]), key
    assert prog.ledgers["cache/**"].h2d_bytes - before \
        == bb["int32"] + bb["bfloat16"]


# -- the MoE layer and the attention variants' steps on the card -------------

def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    """The smoke moonshot's MoE layer (f32) on the card against the CPU,
    at a decode step's and a prefill's token counts."""
    from repro_torch.models import moe, registry

    api = registry.get("moonshot-v1-16b-a3b", smoke=True)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    p = tree_map(lambda t: t[0], params["blocks"]["moe"])
    dp = tree_map(lambda t: t.to(cuda), p)
    rng = np.random.default_rng(4)
    for shape in ((8, 1, 64), (1, 40, 64)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out, aux = moe.apply_moe(api.cfg, p, x)
        dout, daux = moe.apply_moe(api.cfg, dp, x.to(cuda))
        torch.testing.assert_close(dout.cpu(), out, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(daux["moe_aux_loss"].cpu(),
                                   aux["moe_aux_loss"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "starcoder2-3b"])
def test_model_steps_read_nothing_back(cuda, arch):
    """One layer at full width (bf16): a prefill of 8 sequences and a
    decode step, and moonshot's MoE layer alone at a decode step's and a
    938-token prefill's token counts, under sync_debug_mode "error", where
    any host read of a device tensor raises."""
    import dataclasses
    from repro_torch.models import moe, registry

    cfg = dataclasses.replace(registry.get(arch).cfg, num_layers=1)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (8, 37), generator=gen,
                         device=cuda, dtype=torch.int32)
    xs = [torch.randn(8, 1, cfg.d_model, generator=gen, device=cuda
                      ).to(torch.bfloat16),
          torch.randn(1, 938, cfg.d_model, generator=gen, device=cuda
                      ).to(torch.bfloat16)]
    block = tree_map(lambda t: t[0], params["blocks"])

    def run():
        cache = api.init_cache(8, 256, device=cuda)
        logits, cache = api.prefill(params, toks, cache)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        logits, cache = api.decode_step(params, nxt, cache)
        if cfg.family == "moe":
            for x in xs:
                moe.apply_moe(cfg, block["moe"], x)
        return logits

    run()                                    # builds the kernels
    torch.cuda.synchronize(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_gradients_equal_the_plain_gradients(cuda, dtype):
    """The kernel forward under autograd: dx and dscale equal autograd of
    the plain version on the same inputs (f32 within 1e-5, bf16 within
    the forward's 2e-2), and the backward launches nothing."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 2048, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(2048, generator=gen, device=cuda)).to(dtype)
    g = torch.randn(64, 2048, generator=gen, device=cuda).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = RK.rmsnorm.launches
    y = RK.rmsnorm(xa, wa)
    assert RK.rmsnorm.launches == before + 1 and y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (xa, wa), g)
    assert RK.rmsnorm.launches == before + 1
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    ex, ew = torch.autograd.grad(RR.rmsnorm_ref(xb, wb), (xb, wb), g)
    assert dx.dtype == dtype and dw.dtype == dtype
    torch.testing.assert_close(dx.float(), ex.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), ew.float(), rtol=tol,
                               atol=tol * float(ew.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_equal_the_plain_gradients(cuda, dtype):
    """Causal GQA at the train shapes (8 query heads on 2 KV heads, S 128,
    hd 64): dq, dk, dv equal autograd of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, H, KV, S, hd = 2, 8, 2, 128, 64
    q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=cuda
                           ).to(dtype).transpose(1, 2)
               for n in (H, KV, KV))
    g = torch.randn(B, H, S, hd, generator=gen, device=cuda).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    before = FK.flash_attention.launches
    out = FK.flash_attention(qa, ka, va, causal=True)
    assert FK.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, (qa, ka, va), g)
    assert FK.flash_attention.launches == before + 1
    qb, kb, vb = (t.detach().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(FR.attention_ref(qb, kb, vb, causal=True),
                               (qb, kb, vb), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_and_decode_at_head_dim_96(cuda, dtype):
    """phi-3-vision's attention (32 query heads on 32 KV heads of 96): a
    ragged causal prefill at per-batch offsets, a non-causal call and an
    8-slot ragged decode, each against its plain version."""
    rng = np.random.default_rng(96)
    B, H, S = 2, 32, 300
    q, k, v = (_randn(rng, (B, S, H, 96), dtype, cuda).transpose(1, 2)
               for _ in range(3))
    lens = torch.tensor([S, 211], dtype=torch.int32, device=cuda)
    offs = torch.tensor([0, 17], dtype=torch.int32, device=cuda)
    for causal in (True, False):
        got = FK.flash_attention(q, k, v, causal=causal, kv_len=lens,
                                 q_offset=offs)
        want = FR.attention_ref(q.float(), k.float(), v.float(),
                                causal=causal, kv_len=lens, q_offset=offs)
        torch.testing.assert_close(got.float(), want, **_tol(dtype))
    cache_k = _randn(rng, (8, 2048, H, 96), dtype, cuda)
    cache_v = _randn(rng, (8, 2048, H, 96), dtype, cuda)
    qd = _randn(rng, (8, H, 96), dtype, cuda)
    valid = torch.tensor([1, 33, 128, 129, 700, 1500, 2047, 2048],
                         dtype=torch.int32, device=cuda)
    kk, vv = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    got = DK.decode_attention(qd, kk, vv, valid)
    torch.testing.assert_close(got.float(), DR.decode_ref(
        qd.float(), kk.float(), vv.float(), valid), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_gradients_equal_the_plain_gradients(cuda, dtype):
    """ssd_chunks under autograd at mamba2's widths (two 256-step chunks):
    one kernel launch forward, none backward, and the gradients of all
    five inputs, with y_diag, states and cum each carrying one, equal
    autograd of the plain version in f32 (within 1e-5 of each gradient's
    largest element; bf16 within 2e-2)."""
    rng = np.random.default_rng(7)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 2, 512, 8, 64, 128, dtype, cuda)
    xc = x.reshape(2, 2, 256, 8, 64).transpose(2, 3)
    dtc = dt.reshape(2, 2, 256, 8).transpose(2, 3)[:, :, :, None, :]
    dtA = dtc * A[None, None, :, None, None]
    ins = (xc, dtc, dtA, Bm.reshape(2, 2, 256, 128),
           Cm.reshape(2, 2, 256, 128))
    gen = torch.Generator(device=cuda).manual_seed(8)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    leaves = [t.detach().requires_grad_() for t in ins]
    before = SK.ssd_chunks.launches
    outs = SK.ssd_chunks(*leaves)
    grads = [torch.randn(o.shape, generator=gen, device=cuda).to(o.dtype)
             for o in outs]
    got = torch.autograd.grad(outs, leaves, grads)
    assert SK.ssd_chunks.launches == before + 1
    plain = [t.detach().float().requires_grad_() for t in ins]
    want = torch.autograd.grad(SR.ssd_chunks_ref(*plain), plain,
                               [g.float() for g in grads])
    for a, b, t in zip(got, want, ins):
        assert a.dtype == t.dtype and a.shape == b.shape
        bound = tol * float(b.abs().max())
        assert float((a.float() - b).abs().max()) <= bound


def test_smoke_mamba2_train_step_on_the_card(cuda):
    """One remat train step of the smoke mamba2 (f32) on the card: the
    loss and every gradient leaf equal the CPU's (within 2e-4 of the
    leaf's largest element), and ssd_chunks launches once per Mamba2 layer
    forward and again per recompute."""
    import dataclasses
    from repro_torch.models import lm, registry
    from repro_torch.runtime import train

    cfg = dataclasses.replace(registry.get("mamba2-1.3b", smoke=True).cfg,
                              remat="dots")
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want_loss, _, want = train.value_and_grad(api.loss_fn, params, batch)
    RK.rmsnorm.launches = SK.ssd_chunks.launches = 0
    loss, _, got = train.value_and_grad(
        api.loss_fn, tree_map(lambda t: t.to(cuda), params),
        {k: v.to(cuda) for k, v in batch.items()})
    counts = lm.kernel_launches(cfg, train_steps=1)
    assert (RK.rmsnorm.launches, SK.ssd_chunks.launches) == (
        counts["rmsnorm"], counts["ssd_chunks"])
    torch.testing.assert_close(float(loss), float(want_loss), rtol=1e-4,
                               atol=0)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-6 + 2e-4 * float(b.abs().max())


def test_one_layer_full_width_step_moves_every_param(cuda):
    """A full-width llama3.2-1b layer (bf16, remat "dots") takes a train
    step on the card: every gradient leaf is finite and nonzero (the norm
    scales and q/k/v reach their gradients through the kernels'
    backward), and the step launches what kernel_launches predicts."""
    import dataclasses
    from repro_torch.models import lm, registry
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train

    cfg = dataclasses.replace(registry.get("llama3.2-1b").cfg, num_layers=1)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen,
                         device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    RK.rmsnorm.launches = FK.flash_attention.launches = 0
    loss, _, grads = train.value_and_grad(api.loss_fn, params, batch)
    want = lm.kernel_launches(cfg, train_steps=1)
    assert (RK.rmsnorm.launches, FK.flash_attention.launches) == (
        want["rmsnorm"], want["flash_attention"])
    assert bool(torch.isfinite(loss))
    for g in tree_leaves(grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    opt = make_optimizer("adamw")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    # lr 1e-2: a bf16 norm scale of 1.0 moves only by more than half its
    # ulp (2^-8)
    new, met = train.make_train_step(api, opt, constant(1e-2))(state, batch)
    assert all(not torch.equal(a, b) for a, b in zip(
        tree_leaves(new["params"]), tree_leaves(params)))


def test_async_snapshot_holds_the_values_of_its_step(cuda, tmp_path):
    """A snapshot taken before a later step writes the same tensors in
    place holds the earlier values: the pack into the checkpointer's
    buckets is ordered on the compute stream before the write."""
    from repro_torch import checkpoint as ckpt

    gen = torch.Generator(device=cuda).manual_seed(2)
    state = {"params": {"w": torch.randn(4096, 1024, generator=gen,
                                         device=cuda).to(torch.bfloat16)},
             "opt": {"mu": torch.randn(4096, 1024, generator=gen,
                                       device=cuda)},
             "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    want = tree_map(lambda t: t.cpu(), state)
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(state, 7)
    for _ in range(20):                   # the later steps, in place
        for t in tree_leaves(state):
            t.mul_(3).add_(1)
    ac.wait()
    got = ckpt.load(str(tmp_path), 7)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ac._snapshot._bufs[0]["float32"].is_pinned()
    ac.close()


def test_deterministic_restart_is_bit_identical(cuda, tmp_path):
    """Under deterministic algorithms, a run that fails at step 5 and
    restores step 4 through the state policy's program ends with the same
    losses and params, bit for bit, as an uninterrupted run."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import (NodeFailure, make_train_step, run,
                                     state_transfer_policy, train_state,
                                     trajectory_diff)

    api = registry.get("llama3.2-1b", smoke=True)
    opt = make_optimizer("adamw")
    step = make_train_step(api, opt, constant(1e-2))
    data = SyntheticLM(api.cfg.vocab_size, 32, 8)
    init = lambda: train_state(api, opt, torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    boom = {"armed": True}

    def fail(s):
        if s == 5 and boom["armed"]:
            boom["armed"] = False
            raise NodeFailure("simulated")

    torch.use_deterministic_algorithms(True)
    try:
        a = run(step, init, data.batch, 8, device=cuda)
        b = run(step, init, data.batch, 8, ckpt_dir=str(tmp_path), ckpt_every=4,
                failure_injector=fail, state_policy=state_transfer_policy(),
                device=cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    assert b.restarts == 1
    assert trajectory_diff(a.metrics_history, b.metrics_history,
                           keys=("loss", "grad_norm")) == []
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)


# -- the staging race sanitizer on the card: DC301 and DC305 with real
# copy events, the copy stream held so the copy is in flight -------------

def _hold_copy_stream(device, seconds):
    from repro_torch._device import copy_stream

    with torch.cuda.stream(copy_stream(device)):
        torch.cuda._sleep(int(seconds * 2e9))


def _san_tree(v, n=2 ** 22):
    return {"w": torch.full((n,), float(v)),
            "i": torch.arange(64, dtype=torch.int32) + v}


@pytest.mark.parametrize("skip_wait", [True, False])
def test_sanitizer_dc301_with_real_fences(cuda, skip_wait):
    """Three marshal+db passes whose copies wait behind a held copy
    stream: with the fence wait skipped the third pack would rewrite the
    first pass's staging under its queued copy, and the sanitizer raises
    DC301 first; with the wait the passes land intact and it is silent."""
    from repro_torch.analysis.sanitizer import StagingRaceError, sanitize

    session = TransferSession()
    s = transfer_scheme("marshal+db", session, device=cuda)
    if skip_wait:
        session.get_entry(_san_tree(0), 1, pin_memory=True)._wait_fence = \
            lambda bucket, buf_idx: None
    _hold_copy_stream(cuda, 0.2)
    with sanitize():
        if skip_wait:
            with pytest.raises(StagingRaceError) as ei:
                for v in (1, 2, 3):
                    s.to_device(_san_tree(v))
            assert ei.value.code == "DC301"
        else:
            devs = [s.to_device(_san_tree(v)) for v in (1, 2, 3)]
    torch.cuda.synchronize(cuda)
    if not skip_wait:
        for v, d in zip((1, 2, 3), devs):
            assert bool((d["w"] == float(v)).all()) and int(d["i"][0]) == v


@pytest.mark.parametrize("scribble", [True, False])
def test_sanitizer_dc305_with_a_held_copy(cuda, scribble):
    """A host write to pinned staging while its copy is queued lands on
    the card and the sanitizer raises DC305 at the drain; without the
    write the drain is silent and the bytes are the enqueued ones."""
    from repro_torch.analysis.sanitizer import StagingRaceError, sanitize

    s = transfer_scheme("marshal+db", TransferSession(), device=cuda)
    _hold_copy_stream(cuda, 0.2)
    with sanitize() as san:
        pending, finish = s.begin_pass(_san_tree(1))
        f32 = pending[list(s._entry.staging).index("float32")]
        if scribble:
            s._entry.staging["float32"][0] += 1.0  # lint: allow=DC204 -- seeded bug
            with pytest.raises(StagingRaceError) as ei:
                finish()
            assert ei.value.code == "DC305"
        else:
            finish()
            assert san.events["drain"] == 2
    torch.cuda.synchronize(cuda)
    assert float(f32[0]) == (2.0 if scribble else 1.0)


# -- sharded execution: a four-position mesh on the card ---------------------

_SHARD_SPECS = ("uvm@dp4", "marshal@dp4", "marshal+delta@dp4",
                "pointerchain@dp4")


def _mesh(cuda):
    """Four positions on the visible cards, position i on cuda:(i mod
    count) (on one card all four sit on cuda:0)."""
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % count) for i in range(4))


@pytest.mark.parametrize("family", ["sharded", "sharded_delta"])
def test_sharded_algorithm2_on_the_card(cuda, family):
    from repro_torch.core import ShardedTensor, to_host

    mesh = _mesh(cuda)
    sc = PS.iter_scenarios("quick", only=[family], devices=4)[0]
    tree = sc.build()
    for spec in _SHARD_SPECS:
        m = PS.run_scenario(sc, spec, tree=tree, device=mesh)
        assert m.ok and m.motion_ok, (sc.name, spec, m)
        scheme = sc.scheme_for(spec, TransferSession(), device=mesh)
        dev = scheme.to_device(tree)
        if spec.startswith("uvm"):
            dev = scheme.materialize(dev)
        for a, b in zip(tree_leaves(dev), tree_leaves(tree)):
            assert isinstance(a, ShardedTensor)
            assert all(p.tensor.device.type == "cuda" for p in a.pieces)
            assert torch.equal(to_host(a), b)


def test_sharded_delta_shard_fences_and_write_check_on_the_card(cuda):
    """Three marshal+delta@dp4 passes behind a held copy stream: each
    shard copy's event fences the staging until it lands, so every
    returned tree keeps its own bytes; then an in-place write through one
    piece re-ships that shard only."""
    from repro_torch.core import to_host

    mesh = _mesh(cuda)
    sc = PS.sharded_delta_case(2 ** 20, 4)
    s = sc.scheme_for(sc.steady_spec, TransferSession(), device=mesh)
    tree = sc.build()
    trees, devs = [], []
    _hold_copy_stream(cuda, 0.2)
    for _ in range(3):
        trees.append(tree)
        devs.append(s.to_device(tree))
        tree = {"hot": {k: v + 1 for k, v in tree["hot"].items()},
                "cold": tree["cold"], "ids": tree["ids"]}
    torch.cuda.synchronize(cuda)
    for t, d in zip(trees, devs):
        for a, b in zip(tree_leaves(d), tree_leaves(t)):
            assert torch.equal(to_host(a), b)
    last = trees[-1]
    piece = next(p for p in devs[-1]["cold"].pieces if p.position == 1)
    piece.tensor.mul_(2.0)
    s.ledger.reset()
    again = s.to_device(last)
    assert s.ledger.h2d_bytes_by_device == {"1": 2 ** 22}
    for a, b in zip(tree_leaves(again), tree_leaves(last)):
        assert torch.equal(to_host(a), b)


@pytest.mark.parametrize("executor", ["blocking", "async"])
def test_sharded_policy_scenario_on_the_card(cuda, executor):
    mesh = _mesh(cuda)
    for case in (PS.mixed_policy_case, PS.elastic_case):
        sc = case(2 ** 12, 4)
        ms = PS.run_policy_scenario(sc, passes=3, executor=executor,
                                    session=TransferSession(), device=mesh)
        for m in ms:
            assert m.ok and m.motion_ok and m.syncs == 1
            led = m.regions["params/**"]
            assert led["h2d_calls_by_device"] == {str(s): 1 for s in range(4)}


# -- data parallelism over positions of the card -----------------------------

def _named(cuda, shape):
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(*shape, device=_mesh(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collectives_on_the_card_equal_their_plain_versions(cuda, dtype):
    """Each collective over card positions against the same arithmetic on
    one device: sums in position order, bit for bit."""
    from repro_torch.core import collectives as C

    mesh = _named(cuda, (2, 2))
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(8, 6, generator=gen, device=cuda).to(dtype)
          .to(d) for d in mesh.positions]
    for axes in ("data", "model", ("data", "model")):
        summed = C.psum(xs, mesh, axes)
        mx = C.pmax(xs, mesh, axes)
        mean = C.pmean(xs, mesh, axes)
        parts = C.psum_scatter(xs, mesh, axes)
        gathered = C.all_gather(parts, mesh, axes)
        a2a = C.all_to_all(xs, mesh, axes, split_axis=0, concat_axis=1)
        for g in mesh.groups(axes):
            n = len(g)
            total = xs[g[0]]
            for p in g[1:]:
                total = total + xs[p].to(total.device)
            for i, p in enumerate(g):
                assert summed[p].device == mesh.positions[p]
                assert torch.equal(summed[p].cpu(), total.cpu())
                assert torch.equal(mean[p].cpu(), (total / n).cpu())
                assert torch.equal(mx[p].cpu(), torch.stack(
                    [xs[q].cpu() for q in g]).amax(0))
                assert torch.equal(parts[p].cpu(), total.chunk(n)[i].cpu())
                assert torch.equal(gathered[p].cpu(), total.cpu())
                assert torch.equal(a2a[p].cpu(), torch.cat(
                    [xs[q].cpu().chunk(n)[i] for q in g], dim=1))


def test_dp2_step_on_the_card_sums_the_positions_gradients(cuda):
    """A dp-2 step on two positions of the card, smoke llama in bf16,
    SGD with momentum: the delivered gradient (the momentum from zero) is
    the sum of the positions' halves, close to twice the dp-1 gradient
    over the whole batch (each half's mean over equal tokens); arena
    equals pertensor bit for bit; both positions' params equal."""
    import dataclasses
    from repro_torch.core.sharded import replica
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train

    base = registry.get("llama3.2-1b", smoke=True).cfg
    api = registry.get_model(dataclasses.replace(
        base, param_dtype="bfloat16", compute_dtype="bfloat16"))
    opt = make_optimizer("sgdm")
    mesh = (cuda, cuda)
    data = SyntheticLM(api.cfg.vocab_size, 16, 4)
    batch = data.batch(0)
    outs = {}
    for scheme in ("pertensor", "arena"):
        state = train.train_state(api, opt, torch.Generator(
            device=cuda).manual_seed(0), device=cuda)
        step = train.make_dp_train_step(api, opt, constant(1e-2), 2,
                                        device=mesh, grad_scheme=scheme)
        new, _, _ = step(state, batch, {})
        outs[scheme] = [[replica(l, p) for l in tree_leaves(new)]
                        for p in range(2)]
    for a, b in zip(outs["pertensor"][0], outs["arena"][0]):
        assert torch.equal(a, b)
    for a, b in zip(outs["pertensor"][0], outs["pertensor"][1]):
        assert torch.equal(a, b)
    whole = {k: torch.as_tensor(v).to(cuda) for k, v in batch.items()}
    _, _, g1 = train.value_and_grad(api.loss_fn, state["params"], whole)
    mu = [replica(m, 0) for m in tree_leaves(new["opt"]["mu"])]
    for got, want in zip(mu, tree_leaves(g1)):
        want = 2 * want.float()
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-2 * top + 1e-6


# -- tensor parallelism of the MoE block on card positions -------------------

@pytest.mark.parametrize("t", [2, 4])
def test_moe_tensor_parallel_block_at_full_width(cuda, t):
    """One moonshot-v1-16b-a3b block at full width (16 heads of 128, 64
    experts top-6, d_ff 1408), float32, batch 2 x 128, over a model group
    of ``t`` positions of the card (``lm._attn_block_tp``: the heads and
    every expert's d_ff split, the router replicated) against the plain
    block (``lm._attn_block``) on one position: each member's output and
    aux loss, and the gradients (the aux loss seeded too) of every leaf,
    each member's block of a split one, and of the input, within 1e-4 of
    the largest element (float32 sums in other orders); the router's and
    the input's gradients bit-equal over the members; each member runs
    the block's two rmsnorm and one flash launches."""
    from repro_torch.core.treepath import tree_flatten, tree_flatten_with_path
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm, registry
    from repro_torch.models import tp as TP
    from repro_torch.models.specs import init_params

    cfg = registry.get("moonshot-v1-16b-a3b").cfg
    specs = lm._attn_block_specs(cfg)
    p = init_params(specs, torch.Generator(device=cuda).manual_seed(0),
                    "float32", cuda)
    leaves, treedef = tree_flatten(p)
    paths = [path for path, _ in tree_flatten_with_path(p)]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 128, cfg.d_model, device=cuda, generator=g)
    cot = torch.randn(2, 128, cfg.d_model, device=cuda, generator=g)
    pos = torch.arange(128, device=cuda)[None, :]

    whole = [v.clone().requires_grad_() for v in leaves]
    xw = x.clone().requires_grad_()
    want, want_aux = lm._attn_block(cfg, treedef.unflatten(whole), xw,
                                    positions=pos, cache=None,
                                    kv_valid_len=None)
    ((want * cot).sum() + want_aux).backward()

    mesh = make_debug_mesh(1, t, device=(cuda,) * t)
    group = TP.ModelGroup(mesh, mesh.groups("model")[0], heads=True,
                          mlp=False, vocab=False, experts=True)
    dims = {path[1:]: d - 1 for region in ("heads", "experts")
            for path, d in TP.REGIONS[region] if path[0] == "blocks"}
    members = []
    for r in range(t):
        mine = []
        for path, v in zip(paths, leaves):
            d = dims.get(path)
            if d is not None:
                n = v.shape[d] // t
                v = v.narrow(d, r * n, n)
            mine.append(v.clone().requires_grad_())
        members.append(mine)
    xs = [x.clone().requires_grad_() for _ in range(t)]
    before = (RK.rmsnorm.launches, FK.flash_attention.launches)
    outs, auxs = lm._attn_block_tp(cfg, group,
                                   [treedef.unflatten(m) for m in members],
                                   xs, positions=[pos] * t)
    assert (RK.rmsnorm.launches - before[0],
            FK.flash_attention.launches - before[1]) == (2 * t, t)
    torch.autograd.backward([(o * cot).sum() + a
                             for o, a in zip(outs, auxs)])

    def close(got, want, what):
        top = float(want.detach().abs().max())
        err = float((got - want).detach().abs().max())
        assert err <= 1e-4 * top + 1e-6, f"{what}: {err} vs max {top}"

    for o, a in zip(outs, auxs):
        close(o, want, "out")
        close(a, want_aux, "aux")
    for i, path in enumerate(paths):
        grads = [m[i].grad for m in members]
        d = dims.get(path)
        got = torch.cat(grads, dim=d) if d is not None else grads[0]
        if d is None:
            for gr in grads[1:]:
                assert torch.equal(gr, grads[0]), path
        close(got, whole[i].grad, "/".join(path))
    for xi in xs:
        assert torch.equal(xi.grad, xs[0].grad)
    close(xs[0].grad, xw.grad, "x")


# -- tensor parallelism of the Mamba2 block on card positions ----------------

@pytest.mark.parametrize("arch,t", [("mamba2-1.3b", 2), ("mamba2-1.3b", 4),
                                    ("zamba2-2.7b", 4)])
def test_ssm_tensor_parallel_block_at_full_width(cuda, arch, t):
    """One Mamba2 block at full width (mamba2: 64 heads of 64, N 128;
    zamba2: 80 heads, N 64, 20 a member on 4), float32, batch 2 x 512 (two
    256-step chunks), over a model group of ``t`` positions of the card
    (``lm._ssm_block_tp``: the mixer's heads and their channels split,
    ``wB`` / ``wC`` whole) against the plain block (``lm._ssm_block``) on
    one position: each member's output, and the gradients of every leaf,
    each member's block of a split one, and of the input, within 1e-4 of
    the largest element (float32 sums in other orders); the whole leaves'
    and the input's gradients bit-equal over the members; each member
    runs the block's one rmsnorm and one ssd_chunks launch."""
    from repro_torch.core.treepath import tree_flatten, tree_flatten_with_path
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm, registry
    from repro_torch.models import tp as TP
    from repro_torch.models.specs import init_params

    cfg = registry.get(arch).cfg
    specs = lm._ssm_block_specs(cfg)
    p = init_params(specs, torch.Generator(device=cuda).manual_seed(0),
                    "float32", cuda)
    leaves, treedef = tree_flatten(p)
    paths = [path for path, _ in tree_flatten_with_path(p)]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 512, cfg.d_model, device=cuda, generator=g)
    cot = torch.randn(2, 512, cfg.d_model, device=cuda, generator=g)

    whole = [v.clone().requires_grad_() for v in leaves]
    xw = x.clone().requires_grad_()
    want, _ = lm._ssm_block(cfg, treedef.unflatten(whole), xw, cache=None)
    (want * cot).sum().backward()

    mesh = make_debug_mesh(1, t, device=(cuda,) * t)
    group = TP.ModelGroup(mesh, mesh.groups("model")[0], heads=False,
                          mlp=False, vocab=False, ssm=True)
    dims = {path[1:]: d - 1 for path, d in TP.REGIONS["ssm"]}
    members = []
    for r in range(t):
        mine = []
        for path, v in zip(paths, leaves):
            d = dims.get(path)
            if d is not None:
                n = v.shape[d] // t
                v = v.narrow(d, r * n, n)
            mine.append(v.clone().requires_grad_())
        members.append(mine)
    xs = [x.clone().requires_grad_() for _ in range(t)]
    before = (RK.rmsnorm.launches, SK.ssd_chunks.launches)
    outs = lm._ssm_block_tp(cfg, group,
                            [treedef.unflatten(m) for m in members], xs)
    assert (RK.rmsnorm.launches - before[0],
            SK.ssd_chunks.launches - before[1]) == (t, t)
    torch.autograd.backward([(o * cot).sum() for o in outs])

    def close(got, want, what):
        top = float(want.detach().abs().max())
        err = float((got - want).detach().abs().max())
        assert err <= 1e-4 * top + 1e-6, f"{what}: {err} vs max {top}"

    for o in outs:
        close(o, want, "out")
    for i, path in enumerate(paths):
        grads = [m[i].grad for m in members]
        d = dims.get(path)
        got = torch.cat(grads, dim=d) if d is not None else grads[0]
        if d is None:
            for gr in grads[1:]:
                assert torch.equal(gr, grads[0]), path
        close(got, whole[i].grad, "/".join(path))
    for xi in xs:
        assert torch.equal(xi.grad, xs[0].grad)
    close(xs[0].grad, xw.grad, "x")


# -- tensor parallelism of the encoder-decoder's blocks on card positions ---

@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encdec_tensor_parallel_blocks_at_full_width(cuda, part, t):
    """seamless-m4t-medium at full width (16 heads of 64, kv 16, d_ff
    4096, LayerNorm), float32, batch 2 x 128, over a model group of ``t``
    positions of the card: one encoder block (``encdec._enc_block_tp``,
    non-causal) against ``encdec._enc_block``, or one decoder block
    through ``encdec._decode_stack_tp`` (the causal self-attention, the
    cross-attention over 32 rows of memory, the MLP) against
    ``encdec._decode_stack`` on one position: each member's output, and
    the gradients of every leaf, each member's block of a split one, of
    the input and of the memory, within 1e-4 of the largest element for
    the encoder block and 1e-3 for the decoder block (float32 sums in
    other orders: every float32 reading of the decoder block's gradients
    lies 2.4e-4 to 4.6e-4 of a leaf's largest element from the float64
    value, ``scripts/torch_encdec_block_spread.py``); the whole leaves',
    the input's and the memory's gradients bit-equal over the members;
    each member runs one flash launch an attention and no rmsnorm."""
    import dataclasses

    from repro_torch.core.treepath import tree_flatten, tree_flatten_with_path
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import encdec, registry
    from repro_torch.models import tp as TP
    from repro_torch.models.specs import init_params

    cfg = dataclasses.replace(registry.get("seamless-m4t-medium").cfg,
                              num_layers=1)
    stack = "enc_blocks" if part == "encoder" else "dec_blocks"
    specs = encdec.spec_tree(cfg)[stack]
    p = init_params(specs, torch.Generator(device=cuda).manual_seed(0),
                    "float32", cuda)
    if part == "encoder":
        p = tree_flatten(p)[1].unflatten([v[0] for v in tree_flatten(p)[0]])
    leaves, treedef = tree_flatten(p)
    paths = [path for path, _ in tree_flatten_with_path(p)]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 128, cfg.d_model, device=cuda, generator=g)
    mem = torch.randn(2, 32, cfg.d_model, device=cuda, generator=g)
    cot = torch.randn(2, 128, cfg.d_model, device=cuda, generator=g)
    pos = torch.arange(128, device=cuda)[None, :]

    whole = [v.clone().requires_grad_() for v in leaves]
    xw, mw = x.clone().requires_grad_(), mem.clone().requires_grad_()
    if part == "encoder":
        want = encdec._enc_block(cfg, treedef.unflatten(whole), xw,
                                 positions=pos)
    else:
        want = encdec._decode_stack(cfg, {"dec_blocks": treedef.unflatten(
            whole)}, xw, mw, positions=pos, cache=None, kv_valid_len=None)
    (want * cot).sum().backward()

    mesh = make_debug_mesh(1, t, device=(cuda,) * t)
    group = TP.ModelGroup(mesh, mesh.groups("model")[0], heads=True,
                          mlp=True, vocab=False)
    drop = part == "encoder"
    dims = {path[1:]: d - drop for region in ("heads", "mlp")
            for path, d in TP.REGIONS[region] if path[0] == stack}
    members = []
    for r in range(t):
        mine = []
        for path, v in zip(paths, leaves):
            d = dims.get(path)
            if d is not None:
                n = v.shape[d] // t
                v = v.narrow(d, r * n, n)
            mine.append(v.clone().requires_grad_())
        members.append(mine)
    xs = [x.clone().requires_grad_() for _ in range(t)]
    mems = [mem.clone().requires_grad_() for _ in range(t)]
    ps = [treedef.unflatten(m) for m in members]
    before = (RK.rmsnorm.launches, FK.flash_attention.launches)
    if part == "encoder":
        outs = encdec._enc_block_tp(cfg, group, ps, xs, positions=[pos] * t)
    else:
        outs = encdec._decode_stack_tp(cfg, group, ps, xs, mems,
                                       positions=[pos] * t)
    assert (RK.rmsnorm.launches - before[0],
            FK.flash_attention.launches - before[1]) == \
        (0, t * (1 if part == "encoder" else 2))
    torch.autograd.backward([(o * cot).sum() for o in outs])
    rtol = 1e-4 if part == "encoder" else 1e-3

    def close(got, want, what):
        top = float(want.detach().abs().max())
        err = float((got - want).detach().abs().max())
        assert err <= rtol * top + 1e-6, f"{what}: {err} vs max {top}"

    for o in outs:
        close(o, want, "out")
    for i, path in enumerate(paths):
        grads = [m[i].grad for m in members]
        d = dims.get(path)
        got = torch.cat(grads, dim=d) if d is not None else grads[0]
        if d is None:
            for gr in grads[1:]:
                assert torch.equal(gr, grads[0]), path
        close(got, whole[i].grad, "/".join(path))
    for xi in xs:
        assert torch.equal(xi.grad, xs[0].grad)
    close(xs[0].grad, xw.grad, "x")
    if part == "decoder":
        for m in mems:
            assert torch.equal(m.grad, mems[0].grad)
        close(mems[0].grad, mw.grad, "memory")


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", (2, 2)),
                                        ("zamba2-2.7b", (1, 4)),
                                        ("seamless-m4t-medium", (2, 2))])
def test_placed_tensor_parallel_serve_on_the_card(cuda, arch, shape):
    """Tensor-parallel placed serving (``runtime.placed.PlacedServe`` over
    each model group, ``lm.serve_tp``, the encoder-decoder's
    ``encdec.serve_tp``) of the smoke model (float32, vocab 256, so
    heads, d_ff, vocab and the Mamba2 heads split) on four positions of
    the card against the same on four CPU positions (the plain versions):
    four slot prefills (one prompt straddles a ``kv_seq`` block boundary;
    the encoder-decoder's each with seeded frames, encoded) and three
    decode steps under the decode rules, every logit and cache leaf
    within 2e-4 of its largest element, and the launches exactly
    ``kernel_launches`` of the row's holders' prefills (and encodes) and
    every position's steps."""
    import dataclasses

    from repro_torch.launch.mesh import (adapt_batch_rule, make_debug_mesh,
                                         rules_for)
    from repro_torch.models import registry
    from repro_torch.runtime.placed import PlacedServe

    api = registry.get_model(dataclasses.replace(
        registry.get(arch, smoke=True).cfg, vocab_size=256))
    cfg = api.cfg
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(0, 256, (1, n)).astype(np.int32))
               for n in (3, 11, 7, 5)]
    steps = [torch.as_tensor(rng.integers(0, 256, (4, 1)).astype(np.int32))
             for _ in range(3)]
    extras = [{"frames": torch.as_tensor(rng.standard_normal(
        (1, 16 // cfg.src_ratio, cfg.d_model)).astype(np.float32))}
        if cfg.is_encdec else {} for _ in prompts]
    kernels = (RK.rmsnorm, FK.flash_attention, DK.decode_attention,
               SK.ssd_chunks)
    out = {}
    for where in ("cpu", cuda):
        mesh = make_debug_mesh(*shape, device=(torch.device(where),) * 4)
        serve = PlacedServe(api, mesh, adapt_batch_rule(
            rules_for(cfg, mesh, "decode"), mesh, 4))
        assert serve.plan is not None and serve.plan.vocab
        placed = serve.place_params(params)
        cache = serve.place_cache(api.init_cache(4, 16, device="cpu"))
        for k in kernels:
            k.launches = 0
        logits = []
        for r, (tok, extra) in enumerate(zip(prompts, extras)):
            lg, cache = serve.prefill(placed, tok.to(where), cache, slot=r,
                                      **{k: v.to(where)
                                         for k, v in extra.items()})
            logits.append(lg.cpu())
        for tok in steps:
            lg, cache = serve.decode_step(placed, tok.to(where), cache)
            logits.append(lg.gather())
        out[str(where)] = (logits, {k: v.gather() for k, v in cache.items()},
                           [k.launches for k in kernels])
    (want, want_c, _), (got, got_c, launched) = out["cpu"], out[str(cuda)]
    for a, b in list(zip(got, want)) + [(got_c[k], want_c[k])
                                        for k in want_c]:
        top = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-4 * top
    holders = 4 // shape[0]
    encodes = {"encodes": holders * 4} if cfg.is_encdec else {}
    n = registry.kernel_launches(cfg, prefills=holders * 4, steps=4 * 3,
                                 **encodes)
    assert launched == [n["rmsnorm"], n["flash_attention"],
                        n["decode_attention"], n["ssd_chunks"]]
