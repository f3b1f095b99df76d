"""The port's dense llama and its model kernels, held against the JAX
package on the CPU.

  * the configuration copies equal the reference's field for field (less
    ``use_pallas``), and the parameter tree has the reference's paths and
    shapes;
  * ``forward``, ``prefill`` and ``decode_step`` of the smoke llama (f32),
    with the reference's weights carried across by
    ``params_from_reference``, give the reference's logits and caches within
    2e-4 (the tolerance of
    ``test_kernels.py::test_flash_matches_model_attention_blockwise``);
  * each kernel's plain version — what its wrapper runs for a CPU tensor —
    against the Pallas kernel in interpret mode and against the
    reference's ``ref.py`` oracle, at ``tests/test_kernels.py``'s shapes and
    tolerances (bf16 2e-2, f32 2e-5);
  * the decode kernel's ``valid_len == 0`` value, and the multi-token call
    at a nonzero cache position raising.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as r_llama
from repro.core import leaf_paths as r_leaf_paths
from repro.kernels.decode_attention import kernel as r_da, ref as r_da_ref
from repro.kernels.flash_attention import ops as r_fa, ref as r_fa_ref
from repro.kernels.rmsnorm import kernel as r_rn, ref as r_rn_ref
from repro.models import lm as r_lm
from repro.models import registry as r_registry

from repro_torch import NoCudaDeviceError
from repro_torch.configs import llama3_2_1b as p_llama
from repro_torch.convert import params_from_reference
from repro_torch.core import leaf_paths, tree_leaves
from repro_torch.kernels.decode_attention import kernel as DK, ref as DR
from repro_torch.kernels.flash_attention import kernel as FK, ops as FO
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.models import lm as p_lm
from repro_torch.models import registry as p_registry
from repro_torch.models.specs import param_count

CPU = "cpu"
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a, dtype):
    """One numpy draw as a JAX array and a torch CPU tensor of ``dtype``
    (bf16 rounded once, the same way in both)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(t):
    return t.float().numpy()


# ------------------------------------------------------------ configs/specs

def test_config_copies_equal_the_reference():
    ref = dataclasses.asdict(r_llama.CONFIG)
    assert ref.pop("use_pallas") is False
    assert dataclasses.asdict(p_llama.CONFIG) == ref
    ref_smoke = dataclasses.asdict(r_llama.CONFIG.smoke())
    ref_smoke.pop("use_pallas")
    assert dataclasses.asdict(p_llama.CONFIG.smoke()) == ref_smoke
    assert not hasattr(p_llama.CONFIG, "use_pallas")


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_the_reference(smoke):
    r_cfg = r_registry.get("llama3.2-1b", smoke=smoke).cfg
    p_cfg = p_registry.get("llama3.2-1b", smoke=smoke).cfg
    r_tree = r_lm.spec_tree(r_cfg)
    p_tree = p_lm.spec_tree(p_cfg)
    r_leaves = jax.tree_util.tree_leaves(r_tree)
    assert [str(p) for p in leaf_paths(p_tree)] \
        == [str(p) for p in r_leaf_paths(r_tree)]
    for a, b in zip(tree_leaves(p_tree), r_leaves):
        assert (a.shape, a.axes, a.init, a.scale) == \
            (b.shape, b.axes, b.init, b.scale)
    assert param_count(p_tree) == sum(int(np.prod(s.shape)) for s in r_leaves)
    if not smoke:
        assert param_count(p_tree) == 1235814400


def test_init_is_seeded_and_placed():
    api = p_registry.get("llama3.2-1b", smoke=True)
    a = api.init(torch.Generator().manual_seed(3), device=CPU)
    b = api.init(torch.Generator().manual_seed(3), device=CPU)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            api.init(torch.Generator().manual_seed(0))


def test_other_architectures_are_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        p_registry.get("mamba2-1.3b")
    with pytest.raises(KeyError):
        p_registry.get("no-such-model")


# ------------------------------------------------------- the model vs JAX

@pytest.fixture(scope="module")
def llama():
    api = r_registry.get("llama3.2-1b", smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    port = p_registry.get("llama3.2-1b", smoke=True)
    return api, params, port, params_from_reference(jax.device_get(params),
                                                    CPU)


@pytest.fixture(scope="module")
def reference_run(llama):
    """forward, prefill and three greedy decode steps of the reference on
    one token batch; the port replays the same inputs."""
    api, params, _, _ = llama
    toks = np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (2, 13)).astype(np.int32)
    logits, _, _ = r_lm.forward(api.cfg, params, jnp.asarray(toks))
    cache = api.init_cache(2, 32)
    steps = []
    out, cache = api.prefill(params, jnp.asarray(toks), cache)
    steps.append((None, np.asarray(out), jax.device_get(cache)))
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(out[:, -1], axis=-1))[:, None].astype(
            np.int32)
        out, cache = api.decode_step(params, jnp.asarray(nxt), cache)
        steps.append((nxt, np.asarray(out), jax.device_get(cache)))
    return toks, np.asarray(logits), steps


def test_forward_equals_the_reference(llama, reference_run):
    _, _, port, pp = llama
    toks, want, _ = reference_run
    got, cache, aux = port.forward(pp, torch.from_numpy(toks))
    assert cache is None and float(aux) == 0.0
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_prefill_and_decode_equal_the_reference(llama, reference_run):
    _, _, port, pp = llama
    toks, _, steps = reference_run
    cache = port.init_cache(2, 32, device=CPU)
    for i, (nxt, want_logits, want_cache) in enumerate(steps):
        if nxt is None:
            logits, cache = port.prefill(pp, torch.from_numpy(toks), cache)
        else:
            logits, cache = port.decode_step(pp, torch.from_numpy(nxt), cache)
        np.testing.assert_allclose(logits.numpy(), want_logits, **MODEL_TOL)
        assert torch.equal(cache["pos"], torch.tensor(want_cache["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), want_cache[key],
                                       **MODEL_TOL, err_msg=f"step {i} {key}")


def test_prefill_at_a_nonzero_position_is_not_yet_ported(llama):
    _, _, port, pp = llama
    cache = port.init_cache(1, 32, device=CPU)
    _, cache = port.prefill(pp, torch.tensor([[1, 2, 3]]), cache)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port.prefill(pp, torch.tensor([[4, 5]]), cache)
    # one token at a nonzero position is a decode step, which is ported
    logits, cache = port.prefill(pp, torch.tensor([[4]]), cache)
    assert int(cache["pos"][0]) == 4 and torch.isfinite(logits).all()


def test_cpu_wrappers_run_the_plain_versions_without_launching(llama):
    _, _, port, pp = llama
    before = (RK.rmsnorm.launches, FK.flash_attention.launches,
              DK.decode_attention.launches)
    cache = port.init_cache(1, 16, device=CPU)
    _, cache = port.prefill(pp, torch.tensor([[1, 2, 3]]), cache)
    port.decode_step(pp, torch.tensor([[4]], dtype=torch.int32), cache)
    assert (RK.rmsnorm.launches, FK.flash_attention.launches,
            DK.decode_attention.launches) == before
    with pytest.raises(ValueError):
        RK.rmsnorm(torch.ones(2, 4, device="meta"),
                   torch.ones(4, device="meta"))


# ------------------------------------------------ plain versions vs Pallas

RNG = np.random.default_rng(7)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (2, 4, 2, 256, 256, 64),
    (1, 8, 8, 128, 384, 128),
    (2, 4, 1, 256, 256, 64),
    (1, 2, 2, 96, 160, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_equals_pallas(B, H, KV, Sq, Sk, hd, causal,
                                           dtype):
    qj, qt = _pair(RNG.standard_normal((B, Sq, H, hd)), dtype)
    kj, kt = _pair(RNG.standard_normal((B, Sk, KV, hd)), dtype)
    vj, vt = _pair(RNG.standard_normal((B, Sk, KV, hd)), dtype)
    got = _np(FO.mha(qt, kt, vt, causal=causal))
    pallas = np.asarray(r_fa.mha(qj, kj, vj, causal=causal, interpret=True),
                        np.float32)
    oracle = np.asarray(r_fa_ref.attention_ref(
        qj.transpose(0, 2, 1, 3).astype(jnp.float32),
        kj.transpose(0, 2, 1, 3).astype(jnp.float32),
        vj.transpose(0, 2, 1, 3).astype(jnp.float32),
        causal=causal).transpose(0, 2, 1, 3), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))
    np.testing.assert_allclose(got, oracle, **_tol(dtype))


@pytest.mark.parametrize("B,H,KV,S,hd,bk", [
    (2, 4, 2, 512, 64, 128),
    (3, 8, 1, 300, 128, 128),
    (1, 16, 2, 2048, 64, 512),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_version_equals_pallas(B, H, KV, S, hd, bk, dtype):
    qj, qt = _pair(RNG.standard_normal((B, H, hd)), dtype)
    kj, kt = _pair(RNG.standard_normal((B, KV, S, hd)), dtype)
    vj, vt = _pair(RNG.standard_normal((B, KV, S, hd)), dtype)
    valid = RNG.integers(1, S, size=(B,)).astype(np.int32)
    got = _np(DK.decode_attention(qt, kt, vt, torch.from_numpy(valid),
                                  block_k=bk))
    pallas = np.asarray(r_da.decode_attention(
        qj, kj, vj, jnp.asarray(valid), interpret=True, block_k=bk),
        np.float32)
    oracle = np.asarray(r_da_ref.decode_ref(
        qj.astype(jnp.float32), kj.astype(jnp.float32),
        vj.astype(jnp.float32), jnp.asarray(valid)), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))
    np.testing.assert_allclose(got, oracle, **_tol(dtype))


def test_decode_empty_row_keeps_the_pallas_value():
    """valid_len == 0: every score is the finite -1e30, every probability
    1, and the Pallas kernel divides sum(V[:S]) by its padded key count,
    ceil(S / bk) * bk (the oracle would give NaN)."""
    B, H, KV, S, hd, bk = 2, 4, 2, 300, 64, 128
    qj, qt = _pair(RNG.standard_normal((B, H, hd)), "float32")
    kj, kt = _pair(RNG.standard_normal((B, KV, S, hd)), "float32")
    vj, vt = _pair(RNG.standard_normal((B, KV, S, hd)), "float32")
    valid = np.array([0, 41], np.int32)
    got = DK.decode_attention(qt, kt, vt, torch.from_numpy(valid), block_k=bk)
    pallas = np.asarray(r_da.decode_attention(
        qj, kj, vj, jnp.asarray(valid), interpret=True, block_k=bk))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    assert DR.empty_denominator(S, bk) == 384
    empty = vt[0].sum(dim=1) / 384.0
    torch.testing.assert_close(got[0], empty.repeat_interleave(2, dim=0),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 256), (1000, 64), (7, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_version_equals_pallas(shape, dtype):
    xj, xt = _pair(RNG.standard_normal(shape), dtype)
    wj, wt = _pair(RNG.standard_normal(shape[-1]), dtype)
    got = _np(RK.rmsnorm(xt, wt))
    pallas = np.asarray(r_rn.rmsnorm(xj, wj, interpret=True), np.float32)
    oracle = np.asarray(r_rn_ref.rmsnorm_ref(xj, wj), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))
    np.testing.assert_allclose(got, oracle, **_tol(dtype))


def test_flash_rejects_an_empty_key_range():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="kv_len"):
        FK.flash_attention(q, q[:, :1], q[:, :1], kv_len=0)
