"""The port's attention models (dense llama, starcoder2, granite, qwen; the
MoE moonshot and arctic) and their model kernels, held against the JAX
package on the CPU.

  * the configuration copies equal the reference's field for field (less
    ``use_pallas``), and the parameter tree has the reference's paths and
    shapes;
  * ``forward``, ``prefill`` and ``decode_step`` of the smoke models (f32),
    with the reference's weights carried across by
    ``params_from_reference``, give the reference's logits, caches and MoE
    aux loss within 2e-4 (the tolerance of
    ``test_kernels.py::test_flash_matches_model_attention_blockwise``); for
    the five variants every constant-initialised leaf (LayerNorm's scale
    and bias, the qkv and MLP biases, the RMS norm scales) is redrawn first,
    so each takes part;
  * LayerNorm and the tanh GeLU against the reference's, and the erf GeLU
    shown to miss it;
  * each kernel's plain version — what its wrapper runs for a CPU tensor —
    against the Pallas kernel in interpret mode and against the
    reference's ``ref.py`` oracle, at ``tests/test_kernels.py``'s shapes and
    tolerances (bf16 2e-2, f32 2e-5);
  * the decode kernel's ``valid_len == 0`` value;
  * a multi-token call at a nonzero cache position (prefill after prefill
    or decode, per-batch offsets) against the reference's logits and
    caches, for llama, mamba2 and zamba2, and the flash plain version's
    per-batch ``q_offset`` and ``kv_len`` against the reference's masked
    softmax over the real positions.
"""
import dataclasses
import functools
import importlib

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
from repro.models import layers as r_layers
from repro.models import lm as r_lm
from repro.models import registry as r_registry

from repro_torch import NoCudaDeviceError
from repro_torch.configs import llama3_2_1b as p_llama
from repro_torch.convert import params_from_reference
from repro_torch.core import leaf_paths, tree_leaves
from repro_torch.kernels.decode_attention import kernel as DK, ref as DR
from repro_torch.kernels.flash_attention import kernel as FK, ops as FO
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.models import layers as p_layers
from repro_torch.models import lm as p_lm
from repro_torch.models import registry as p_registry
from repro_torch.models.specs import param_count

CPU = "cpu"
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# the dense variants and the MoE family, ported together
VARIANTS = ("starcoder2-3b", "granite-3-8b", "qwen1.5-110b",
            "moonshot-v1-16b-a3b", "arctic-480b")
FULL_PARAMS = {"llama3.2-1b": 1235814400, "starcoder2-3b": 3181274112,
               "granite-3-8b": 8372187136, "qwen1.5-110b": 111209914368,
               "moonshot-v1-16b-a3b": 28057995264,
               "arctic-480b": 476850275328}


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

def _configs(arch):
    mod = arch.replace("-", "_").replace(".", "_")
    return tuple(importlib.import_module(f"{pkg}.configs.{mod}").CONFIG
                 for pkg in ("repro", "repro_torch"))


@pytest.mark.parametrize("arch", ("llama3.2-1b",) + VARIANTS)
def test_config_copies_equal_the_reference(arch):
    r_cfg, p_cfg = _configs(arch)
    ref = dataclasses.asdict(r_cfg)
    assert ref.pop("use_pallas") is False
    assert dataclasses.asdict(p_cfg) == ref
    ref_smoke = dataclasses.asdict(r_cfg.smoke())
    ref_smoke.pop("use_pallas")
    assert dataclasses.asdict(p_cfg.smoke()) == ref_smoke
    assert not hasattr(p_cfg, "use_pallas")
    assert p_registry.load_config(arch) is p_cfg


@pytest.mark.parametrize("arch", ("llama3.2-1b",) + VARIANTS)
@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_the_reference(arch, smoke):
    r_cfg = r_registry.get(arch, smoke=smoke).cfg
    p_cfg = p_registry.get(arch, smoke=smoke).cfg
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
        assert param_count(p_tree) == FULL_PARAMS[arch]


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


def test_unknown_architecture_raises():
    with pytest.raises(KeyError):
        p_registry.get("no-such-model")


@pytest.mark.parametrize("arch,layers,per_forward,per_prefill", [
    ("llama3.2-1b", None, {"rmsnorm": 33},
     {"flash_attention": 16, "decode_attention": 16}),
    ("mamba2-1.3b", None, {"rmsnorm": 49}, {"ssd_chunks": 48}),
    ("zamba2-2.7b", 12, {"rmsnorm": 17},
     {"flash_attention": 2, "decode_attention": 2, "ssd_chunks": 12}),
    ("zamba2-2.7b", None, {"rmsnorm": 73},
     {"flash_attention": 9, "decode_attention": 9, "ssd_chunks": 54}),
    # LayerNorm is plain PyTorch: starcoder2 launches no rmsnorm
    ("starcoder2-3b", None, {"rmsnorm": 0},
     {"flash_attention": 30, "decode_attention": 30}),
    ("granite-3-8b", None, {"rmsnorm": 81},
     {"flash_attention": 40, "decode_attention": 40}),
    ("qwen1.5-110b", 1, {"rmsnorm": 3},
     {"flash_attention": 1, "decode_attention": 1}),
    # an MoE block launches what a dense block does
    ("moonshot-v1-16b-a3b", 4, {"rmsnorm": 9},
     {"flash_attention": 4, "decode_attention": 4}),
    ("moonshot-v1-16b-a3b", None, {"rmsnorm": 97},
     {"flash_attention": 48, "decode_attention": 48}),
    ("arctic-480b", None, {"rmsnorm": 71},
     {"flash_attention": 35, "decode_attention": 35}),
    # the vision projection launches nothing: phi-3's dense stack
    ("phi-3-vision-4.2b", None, {"rmsnorm": 65},
     {"flash_attention": 32, "decode_attention": 32}),
])
def test_kernel_launches_closed_forms(arch, layers, per_forward, per_prefill):
    """At full width: rmsnorm per forward, flash and ssd_chunks per prefill
    request, decode_attention per decode step (``per_prefill`` holds both
    per-block counts)."""
    cfg = p_registry.get(arch).cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    per_block = {k: per_prefill.get(k, 0) for k in
                 ("flash_attention", "decode_attention", "ssd_chunks")}
    assert p_lm.kernel_launches(cfg, 3, 5) == {
        "rmsnorm": per_forward["rmsnorm"] * 8,
        "flash_attention": per_block["flash_attention"] * 3,
        "decode_attention": per_block["decode_attention"] * 5,
        "ssd_chunks": per_block["ssd_chunks"] * 3}


@pytest.mark.parametrize("arch,layers,remat,micro,want", [
    # a forward per micro-batch, and under remat every block's forward
    # again in the backward (its norms, flash and ssd_chunks)
    ("mamba2-1.3b", None, "dots", 1,
     {"rmsnorm": 49 + 48, "flash_attention": 0, "ssd_chunks": 2 * 48}),
    ("mamba2-1.3b", None, "none", 2,
     {"rmsnorm": 2 * 49, "flash_attention": 0, "ssd_chunks": 2 * 48}),
    ("mamba2-1.3b", None, "full", 2,
     {"rmsnorm": 2 * (49 + 48), "flash_attention": 0,
      "ssd_chunks": 2 * 2 * 48}),
    ("zamba2-2.7b", 12, "dots", 1,
     {"rmsnorm": 17 + 16, "flash_attention": 2 * 2, "ssd_chunks": 2 * 12}),
    ("zamba2-2.7b", None, "dots", 1,
     {"rmsnorm": 73 + 72, "flash_attention": 2 * 9, "ssd_chunks": 2 * 54}),
    ("zamba2-2.7b", None, "none", 1,
     {"rmsnorm": 73, "flash_attention": 9, "ssd_chunks": 54}),
    ("moonshot-v1-16b-a3b", 4, "dots", 1,
     {"rmsnorm": 9 + 8, "flash_attention": 2 * 4, "ssd_chunks": 0}),
    ("phi-3-vision-4.2b", None, "dots", 1,
     {"rmsnorm": 65 + 64, "flash_attention": 2 * 32, "ssd_chunks": 0}),
])
def test_train_kernel_launches_closed_forms(arch, layers, remat, micro,
                                            want):
    """One train step at full width: no decode call, the rest per
    forward and per recompute."""
    cfg = dataclasses.replace(p_registry.get(arch).cfg, remat=remat,
                              micro_batches=micro)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    assert p_lm.kernel_launches(cfg, train_steps=3) == {
        **{k: 3 * n for k, n in want.items()}, "decode_attention": 0}


@pytest.mark.parametrize("arch", ("llama3.2-1b", "mamba2-1.3b",
                                  "zamba2-2.7b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium") + VARIANTS)
def test_kernel_launches_counts_the_model_call_sites(arch, monkeypatch):
    """The formula against the calls the smoke model makes into each kernel
    wrapper's entry point on the CPU, over one prefill and three decode
    steps."""
    from repro_torch.models import layers as p_layers, ssm as p_ssm

    calls = dict.fromkeys(("rmsnorm", "flash_attention", "decode_attention",
                           "ssd_chunks"), 0)
    for mod, attr, name in ((p_layers, "rmsnorm", "rmsnorm"),
                            (p_layers, "mha", "flash_attention"),
                            (p_layers, "decode_mha", "decode_attention"),
                            (p_ssm, "ssd_chunked_kernel", "ssd_chunks")):
        def counted(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    api = p_registry.get(arch, smoke=True)
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (2, 11)).astype(np.int32))
    logits, cache = api.prefill(params, toks, api.init_cache(2, 32,
                                                             device=CPU))
    for _ in range(3):
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        logits, cache = api.decode_step(params, nxt, cache)
    assert calls == p_registry.kernel_launches(api.cfg, 1, 3)


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


def _redrawn(params, seed=11):
    """The reference's init with every constant-initialised leaf (norm
    scales, LayerNorm and MLP biases, qkv biases) redrawn around its value,
    so each takes part in the comparison."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.reshape(-1)[0]):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return jnp.asarray(a)

    return jax.tree_util.tree_map(redraw, jax.device_get(params))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Built once per arch: pytest tears a parametrized module fixture
    down and up again when tests of other params come between."""
    api = r_registry.get(arch, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    if arch in VARIANTS:
        params = _redrawn(params)
    port = p_registry.get(arch, smoke=True)
    return api, params, port, params_from_reference(jax.device_get(params),
                                                    CPU)


@pytest.fixture(scope="module", params=("llama3.2-1b", "mamba2-1.3b",
                                        "zamba2-2.7b") + VARIANTS)
def any_model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=VARIANTS)
def variant(request):
    return _model(request.param)


def test_forward_prefill_and_decode_equal_the_reference(variant):
    """forward (logits and aux loss), a prefill and three greedy decode
    steps, each as ``forward`` with the cache so its aux loss is compared
    too (nonzero for the MoE models, zero for the dense variants)."""
    api, params, port, pp = variant
    toks = np.random.default_rng(4).integers(
        0, api.cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _, want_aux = r_lm.forward(api.cfg, params, jnp.asarray(toks))
    got, cache, aux = port.forward(pp, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)
    assert (float(aux) > 0) == (api.cfg.family == "moe")
    rc, pc = api.init_cache(2, 24), port.init_cache(2, 24, device=CPU)
    chunk = toks
    for step in range(4):
        rpos, ppos = rc["pos"], pc["pos"]
        S = chunk.shape[1]
        positions = np.arange(S)[None, :] + np.asarray(rpos)[:, None]
        rl, rc, raux = r_lm.forward(
            api.cfg, params, jnp.asarray(chunk), positions=jnp.asarray(
                positions), cache=rc, kv_valid_len=rpos + S)
        pl, pc, paux = p_lm.forward(
            port.cfg, pp, torch.from_numpy(chunk),
            positions=torch.from_numpy(positions), cache=pc,
            kv_valid_len=ppos + S)
        _same_step((pl, pc), (rl, rc), f"step {step}")
        np.testing.assert_allclose(float(paux), float(raux), **MODEL_TOL,
                                   err_msg=f"step {step} aux")
        chunk = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None].astype(
            np.int32)


def _same_step(got, want, what):
    (gl, gc), (wl, wc) = got, want
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL,
                               err_msg=what)
    assert sorted(gc) == sorted(wc)
    for key in wc:
        np.testing.assert_allclose(gc[key].float().numpy(),
                                   np.asarray(wc[key], np.float32),
                                   **MODEL_TOL, err_msg=f"{what} {key}")


def test_prefill_at_a_nonzero_position_equals_the_reference(any_model):
    """Prefill a first part, then the rest as one multi-token call at pos
    > 0, then once more after a decode step: the reference's logits and
    caches each time (its attention masks with the real positions; its
    Mamba2 scan starts from the cached state)."""
    api, params, port, pp = any_model
    toks = np.random.default_rng(8).integers(
        0, api.cfg.vocab_size, (2, 30)).astype(np.int32)
    rc, pc = api.init_cache(2, 40), port.init_cache(2, 40, device=CPU)
    for i, (a, b) in enumerate(((0, 11), (11, 23), (23, 24), (24, 30))):
        chunk = toks[:, a:b]
        if b - a == 1:
            want = api.decode_step(params, jnp.asarray(chunk), rc)
            got = port.decode_step(pp, torch.from_numpy(chunk), pc)
        else:
            want = api.prefill(params, jnp.asarray(chunk), rc)
            got = port.prefill(pp, torch.from_numpy(chunk), pc)
        _same_step(got, want, f"call {i} at pos {a}")
        rc, pc = want[1], got[1]
    assert pc["pos"].tolist() == [30, 30]


def test_prefill_at_per_batch_offsets_equals_the_reference(any_model):
    """Rows at different cache positions in one multi-token call, one of
    them running past the end of the cache (the reference writes only the
    rows that fit)."""
    api, params, port, pp = any_model
    toks = np.random.default_rng(9).integers(
        0, api.cfg.vocab_size, (3, 9)).astype(np.int32)
    pos = np.array([0, 5, 20], np.int32)
    rc = dict(api.init_cache(3, 24), pos=jnp.asarray(pos))
    pc = dict(port.init_cache(3, 24, device=CPU), pos=torch.from_numpy(pos))
    want = api.prefill(params, jnp.asarray(toks), rc)
    got = port.prefill(pp, torch.from_numpy(toks), pc)
    _same_step(got, want, "per-batch offsets")
    nxt = np.asarray(jnp.argmax(want[0][:, -1], -1))[:, None].astype(np.int32)
    _same_step(port.decode_step(pp, torch.from_numpy(nxt), got[1]),
               api.decode_step(params, jnp.asarray(nxt), want[1]),
               "decode after it")


def test_a_multi_token_call_makes_no_host_synchronize(llama, monkeypatch):
    """multihead_attention reads no position on the host: the cache
    position is a meta tensor, which has no values to read, and the call
    still runs as far as the flash kernel's wrapper."""
    from repro_torch.models import layers as p_layers

    _, _, port, pp = llama
    cfg = port.cfg
    seen = {}

    def fake_mha(q, k, v, *, causal, kv_len, q_offset):
        seen.update(kv_len=kv_len, q_offset=q_offset)
        return torch.zeros(q.shape, device="meta")

    monkeypatch.setattr(p_layers, "mha", fake_mha)
    x = torch.zeros(2, 5, cfg.d_model, device="meta")
    p = {k: v[0].to("meta") for k, v in pp["blocks"]["attn"].items()}
    cache = {"k": torch.zeros(2, 16, cfg.num_kv_heads,
                              cfg.resolved_head_dim, device="meta")}
    cache["v"] = torch.zeros_like(cache["k"])
    pos = torch.zeros(2, dtype=torch.int32, device="meta")
    positions = torch.arange(5, device="meta")[None, :] + pos[:, None]
    out, _ = p_layers.multihead_attention(cfg, p, x, positions=positions,
                                          kv_cache=cache,
                                          kv_valid_len=pos + 5)
    assert out.shape == (2, 5, cfg.d_model)
    assert seen["q_offset"].shape == (2,) and seen["kv_len"].shape == (2,)


def test_cpu_wrappers_run_the_plain_versions_without_launching(llama):
    _, _, port, pp = llama
    before = (RK.rmsnorm.launches, FK.flash_attention.launches,
              DK.decode_attention.launches)
    cache = port.init_cache(1, 16, device=CPU)
    _, cache = port.prefill(pp, torch.tensor([[1, 2, 3]]), cache)
    port.decode_step(pp, torch.tensor([[4]], dtype=torch.int32), cache)
    assert (RK.rmsnorm.launches, FK.flash_attention.launches,
            DK.decode_attention.launches) == before
    # a meta tensor (the dry run's) takes the plain version too; a scale
    # on another device than x still raises
    out = RK.rmsnorm(torch.ones(2, 4, device="meta"),
                     torch.ones(4, device="meta"))
    assert out.device.type == "meta"
    assert RK.rmsnorm.launches == before[0]
    with pytest.raises(ValueError):
        RK.rmsnorm(torch.ones(2, 4, device="meta"), torch.ones(4))


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


def _reference_masked_attention(q, k, v, q_offset, kv_len):
    """The reference model's attention over real positions: its
    ``_masked_softmax`` with ``k_pos <= q_offset + i`` and ``k_pos <
    kv_len`` per batch (q (B, Sq, H, hd), k/v (B, Sk, KV, hd), numpy)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qpos = q_offset[:, None] + np.arange(Sq)[None]
    scores = r_layers._gqa_scores_block(
        jnp.asarray(q).reshape(B, Sq, KV, H // KV, hd), jnp.asarray(k),
        1.0 / np.sqrt(hd))
    k_pos = np.arange(Sk)
    mask = (k_pos[None, None, :] <= qpos[:, :, None]) \
        & (k_pos[None, None, :] < kv_len[:, None, None])
    probs = r_layers._masked_softmax(scores, jnp.asarray(mask)[:, None, None])
    out = jnp.einsum("bkgqs,bskh->bqkgh", probs, jnp.asarray(v))
    return np.asarray(out).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,offsets,lens", [
    (2, 4, 2, 7, 32, 16, (0, 9), (7, 16)),
    (3, 4, 4, 70, 200, 64, (3, 64, 130), (73, 134, 200)),
    (2, 4, 1, 5, 24, 80, (19, 2), (24, 7)),
    (1, 2, 2, 130, 130, 32, (0,), (130,)),
])
def test_flash_plain_version_with_q_offset_equals_the_reference(
        B, H, KV, Sq, Sk, hd, offsets, lens):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    off, kl = np.array(offsets, np.int32), np.array(lens, np.int32)
    got = FO.mha(*map(torch.from_numpy, (q, k, v)), causal=True,
                 kv_len=torch.from_numpy(kl), q_offset=torch.from_numpy(off))
    want = _reference_masked_attention(q, k, v, off, kl)
    np.testing.assert_allclose(got.numpy(), want, **_tol("float32"))


def test_flash_offset_row_zero_still_sees_key_zero():
    """The causal tile skip relies on every row having key 0 valid: a row
    at a nonzero offset with kv_len 1 attends to key 0 alone, and a length
    below 1 is clamped to 1 (an offset below 0 to 0), on the device as in
    the plain version."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 3, 2, 16), (2, 70, 2, 16), (2, 70, 2, 16)))
    got = FO.mha(q, k, v, causal=True,
                 kv_len=torch.tensor([1, 0], dtype=torch.int32),
                 q_offset=torch.tensor([65, -4], dtype=torch.int32))
    for b in range(2):
        torch.testing.assert_close(got[b], v[b, :1].expand(3, 2, 16),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="q_offset"):
        FO.mha(q, k, v, q_offset=torch.zeros(3, dtype=torch.int32))


# ----------------------------------- LayerNorm and the non-gated GeLU MLP

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_equals_the_reference(dtype):
    """f32 statistics with the biased variance and eps 1e-5, the affine in
    f32, cast back to x's dtype."""
    cfg = r_registry.get("starcoder2-3b", smoke=True).cfg
    rng = np.random.default_rng(12)
    xj, xt = _pair(3.0 * rng.standard_normal((2, 7, cfg.d_model)) + 0.5,
                   dtype)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = r_layers.apply_norm(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                               xj)
    got = p_layers.apply_norm(p_registry.get("starcoder2-3b", smoke=True).cfg,
                              {k: torch.from_numpy(v) for k, v in p.items()},
                              xt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


def _gelu_mlp_case():
    """starcoder2's smoke MLP with redrawn biases on inputs wide enough that
    the hidden units reach |h| ~ 3, where the two GeLU forms part."""
    api = r_registry.get("starcoder2-3b", smoke=True)
    params = _redrawn(api.init(jax.random.PRNGKey(1)))
    p = jax.tree_util.tree_map(lambda t: t[0], params["blocks"]["mlp"])
    x = 2.0 * np.random.default_rng(13).standard_normal(
        (2, 9, api.cfg.d_model)).astype(np.float32)
    want = np.asarray(r_layers.apply_mlp(api.cfg, p, jnp.asarray(x)))
    pp = params_from_reference(jax.device_get(p), CPU)
    cfg = p_registry.get("starcoder2-3b", smoke=True).cfg
    return cfg, pp, torch.from_numpy(x), want


def test_gelu_mlp_equals_the_reference():
    cfg, pp, x, want = _gelu_mlp_case()
    np.testing.assert_allclose(p_layers.apply_mlp(cfg, pp, x).numpy(), want,
                               **MODEL_TOL)


def test_erf_gelu_would_miss_the_reference(monkeypatch):
    """jax.nn.gelu defaults to the tanh approximation; the erf form
    (torch's default) misses the reference by more than MODEL_TOL."""
    import torch.nn.functional as F

    cfg, pp, x, want = _gelu_mlp_case()
    erf = F.gelu
    monkeypatch.setattr(p_layers.F, "gelu",
                        lambda h, approximate="none": erf(h))
    got = p_layers.apply_mlp(cfg, pp, x).numpy()
    assert not np.allclose(got, want, **MODEL_TOL)
