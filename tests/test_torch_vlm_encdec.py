"""The port's vlm (phi-3-vision-4.2b) and encoder-decoder
(seamless-m4t-medium) models held against the JAX package on the CPU.

From the reference's params (carried across by ``params_from_reference``)
and the same seeded numpy tokens, patches and frames:

  * the configuration copies and the shape grid equal the reference's, and
    ``ModelApi.inputs`` gives the shapes and dtypes of the reference's
    ``input_specs`` for every model and mode;
  * the spec trees have the reference's paths, shapes, axes, inits and
    param counts, smoke and full size;
  * the teacher-forced logits (phi-3 with its patches prepended, seamless
    through the encoder and the cross-attending decoder), a prefill with
    patches / frames and 4 greedy decode steps (logits and caches), within
    ``MODEL_TOL``, the models' tolerance of tests/test_torch_models.py;
  * the loss, its metrics within rtol 1e-4 and the gradients leaf by leaf
    within ``GRAD_RTOL`` of the leaf's largest element
    (tests/test_torch_train.py's);
  * seamless' prefill without frames reading the cache's ``enc_out``, and
    ``kernel_launches`` against the kernel calls of a prefill with frames,
    decode steps and a remat train step;
  * the port's ``Server`` against the reference's on both models (the
    reference's ``Server`` passes neither patches nor frames).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.configs import shapes as r_shapes
from repro.core import leaf_paths as r_leaf_paths
from repro.models import encdec as r_encdec
from repro.models import layers as r_layers
from repro.models import lm as r_lm
from repro.models import registry as r_registry
from repro.runtime import Request as RRequest
from repro.runtime import Server as RServer

from repro_torch.configs import shapes as p_shapes
from repro_torch.convert import params_from_reference
from repro_torch.core import leaf_paths, tree_leaves
from repro_torch.models import encdec as p_encdec
from repro_torch.models import registry as p_registry
from repro_torch.models.specs import param_count
from repro_torch.runtime import Request, Server
from repro_torch.runtime import train as p_train

CPU = "cpu"
ARCHS = ("phi-3-vision-4.2b", "seamless-m4t-medium")
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_torch_models.py's
RTOL, ATOL, GRAD_RTOL = 1e-4, 1e-6, 2e-4   # tests/test_torch_train.py's
FULL_PARAMS = {"phi-3-vision-4.2b": 3830516736,
               "seamless-m4t-medium": 614926336}


def _r_module(cfg):
    return r_encdec if cfg.is_encdec else r_lm


# ------------------------------------------------------------ configs/specs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_equal_the_reference(arch):
    mod = arch.replace("-", "_").replace(".", "_")
    r_cfg, p_cfg = (importlib.import_module(f"{pkg}.configs.{mod}").CONFIG
                    for pkg in ("repro", "repro_torch"))
    for r, p in ((r_cfg, p_cfg), (r_cfg.smoke(), p_cfg.smoke())):
        ref = dataclasses.asdict(r)
        assert ref.pop("use_pallas") is False
        assert dataclasses.asdict(p) == ref
        assert (p.is_encdec, p.supports_long_context) == \
            (r.is_encdec, r.supports_long_context)
    assert p_registry.load_config(arch) is p_cfg


@pytest.mark.parametrize("arch", r_registry.ARCH_IDS)
def test_shape_grid_equals_the_reference(arch):
    r_cfg = r_registry.get(arch).cfg
    p_cfg = p_registry.get(arch).cfg
    assert {k: dataclasses.asdict(v) for k, v in p_shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_shapes.SHAPES.items()}
    assert sorted(p_shapes.shapes_for(p_cfg)) == \
        sorted(r_shapes.shapes_for(r_cfg))
    for name in r_shapes.SHAPES:
        assert p_shapes.skip_reason(p_cfg, name) == \
            r_shapes.skip_reason(r_cfg, name)


@pytest.mark.parametrize("arch", r_registry.ARCH_IDS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_inputs_equal_the_reference_input_specs(arch, mode):
    shape = next(s for s in r_shapes.SHAPES.values() if s.mode == mode)
    r_specs = r_registry.get(arch, smoke=True).input_specs(shape.smoke())
    p_shape = p_shapes.SHAPES[shape.name].smoke()
    got = p_registry.get(arch, smoke=True).inputs(p_shape)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in r_specs.items()} \
        == {k: (s, str(d).replace("torch.", "")) for k, (s, d) in got.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_the_reference(arch, smoke):
    r_cfg = r_registry.get(arch, smoke=smoke).cfg
    p_cfg = p_registry.get(arch, smoke=smoke).cfg
    r_tree = _r_module(r_cfg).spec_tree(r_cfg)
    p_tree = p_registry.spec_tree(p_cfg)
    r_leaves = jax.tree_util.tree_leaves(r_tree)
    assert [str(p) for p in leaf_paths(p_tree)] \
        == [str(p) for p in r_leaf_paths(r_tree)]
    for a, b in zip(tree_leaves(p_tree), r_leaves):
        assert (a.shape, a.axes, a.init, a.scale) == \
            (b.shape, b.axes, b.init, b.scale)
    assert param_count(p_tree) == sum(int(np.prod(s.shape)) for s in r_leaves)
    if not smoke:
        assert param_count(p_tree) == FULL_PARAMS[arch]


# ------------------------------------------------------------- the models

def _redrawn(params, seed=11):
    """Every constant-initialised leaf (norm scales and biases, MLP
    biases) redrawn around its value, so each takes part."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.reshape(-1)[0]):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return jnp.asarray(a)

    return jax.tree_util.tree_map(redraw, jax.device_get(params))


_MODELS = {}


def _model(arch):
    """Built once per arch: the reference api, its params, the port api and
    the same params as the port's tree."""
    if arch not in _MODELS:
        api = r_registry.get(arch, smoke=True)
        params = _redrawn(api.init(jax.random.PRNGKey(0)))
        port = p_registry.get(arch, smoke=True)
        _MODELS[arch] = (api, params, port, params_from_reference(
            jax.device_get(params), CPU))
    return _MODELS[arch]


def _extra(cfg, B, S, seed):
    """The seeded side input of a prefill or train step: patches (B, P,
    d_model) for the vlm, frames (B, S / src_ratio, d_model) for the
    encdec, as numpy, under its keyword."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        n, key = max(1, S // cfg.src_ratio), "frames"
    else:
        n, key = cfg.frontend_tokens, "patches"
    return key, rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


def _r_logits(api, params, toks, key, extra):
    cfg = api.cfg
    if not cfg.is_encdec:
        return r_lm.forward(cfg, params, jnp.asarray(toks),
                            patches=jnp.asarray(extra))[0]
    enc = r_encdec.encode(cfg, params, jnp.asarray(extra))
    x = r_layers.embed_tokens(cfg, params["embed"], jnp.asarray(toks))
    x, _ = r_encdec._decode_stack(cfg, params, x, enc,
                                  positions=jnp.arange(toks.shape[1])[None],
                                  cache=None, kv_valid_len=None)
    x = r_layers.apply_norm(cfg, params["final_norm"], x)
    return r_layers.unembed(cfg, params["embed"], x)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_equal_the_reference(arch):
    api, params, port, pp = _model(arch)
    toks = np.random.default_rng(2).integers(
        0, api.cfg.vocab_size, (2, 12)).astype(np.int32)
    key, extra = _extra(api.cfg, 2, 12, 3)
    want = _r_logits(api, params, toks, key, extra)
    got, cache, aux = port.forward(pp, torch.from_numpy(toks),
                                   **{key: torch.from_numpy(extra)})
    assert cache is None and float(aux) == 0.0
    assert tuple(got.shape) == (2, 12, api.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(arch):
    """A prefill with patches / frames, then 4 greedy decode steps: the
    logits and every cache leaf, step by step."""
    api, params, port, pp = _model(arch)
    toks = np.random.default_rng(4).integers(
        0, api.cfg.vocab_size, (2, 11)).astype(np.int32)
    max_seq = 48
    key, extra = _extra(api.cfg, 2, max_seq, 5)
    rc, pc = api.init_cache(2, max_seq), port.init_cache(2, max_seq,
                                                         device=CPU)
    rl, rc = api.prefill(params, jnp.asarray(toks), rc,
                         **{key: jnp.asarray(extra)})
    pl, pc = port.prefill(pp, torch.from_numpy(toks), pc,
                          **{key: torch.from_numpy(extra)})
    extra_pos = 0 if api.cfg.is_encdec else api.cfg.frontend_tokens
    assert pc["pos"].tolist() == [11 + extra_pos] * 2
    for step in range(5):
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **MODEL_TOL,
                                   err_msg=f"step {step} logits")
        assert sorted(pc) == sorted(rc)
        for k in rc:
            np.testing.assert_allclose(pc[k].float().numpy(),
                                       np.asarray(rc[k], np.float32),
                                       **MODEL_TOL,
                                       err_msg=f"step {step} {k}")
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None].astype(np.int32)
        assert nxt.tolist() == pl[:, -1].argmax(-1, keepdim=True).tolist()
        rl, rc = api.decode_step(params, jnp.asarray(nxt), rc)
        pl, pc = port.decode_step(pp, torch.from_numpy(nxt), pc)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_reference(arch):
    api, params, port, pp = _model(arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, api.cfg.vocab_size, (2, 17)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1
    key, extra = _extra(api.cfg, 2, 16, 7)
    batch = {"tokens": toks[:, :-1], "labels": labels, key: extra}
    (r_loss, r_met), r_g = jax.value_and_grad(
        lambda p: api.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}), has_aux=True)(params)
    loss, met, grads = p_train.value_and_grad(
        port.loss_fn, pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=RTOL)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(met[k]), float(r_met[k]), rtol=RTOL,
                                   atol=ATOL)
    assert float(met["tokens"]) == 2 * 16 - 2
    got, want = tree_leaves(grads), jax.tree_util.tree_leaves(r_g)
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r, np.float32)
        bound = ATOL + GRAD_RTOL * float(np.abs(r).max(initial=0.0))
        err = float(np.abs(g.numpy() - r).max(initial=0.0))
        assert err <= bound, f"{arch} grad leaf {i}: {err} > {bound}"
        assert bool(g.abs().max() > 0), f"{arch} grad leaf {i} is zero"


def test_vlm_without_patches_is_its_text_model():
    """phi-3 without patches: the dense stack over the text alone, the
    reference's forward."""
    api, params, port, pp = _model("phi-3-vision-4.2b")
    toks = np.random.default_rng(8).integers(
        0, api.cfg.vocab_size, (2, 9)).astype(np.int32)
    want, _, _ = r_lm.forward(api.cfg, params, jnp.asarray(toks))
    got, _, _ = port.forward(pp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_encdec_prefill_without_frames_reads_the_cache():
    """Frames encoded at one prefill stay in the cache; a later prefill
    without frames (a second turn) cross-attends to them, as the
    reference's does."""
    api, params, port, pp = _model("seamless-m4t-medium")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, api.cfg.vocab_size, (2, 7)).astype(np.int32)
    more = rng.integers(0, api.cfg.vocab_size, (2, 5)).astype(np.int32)
    _, frames = _extra(api.cfg, 2, 32, 10)
    rc, pc = api.init_cache(2, 32), port.init_cache(2, 32, device=CPU)
    _, rc = api.prefill(params, jnp.asarray(toks), rc,
                        frames=jnp.asarray(frames))
    _, pc = port.prefill(pp, torch.from_numpy(toks), pc,
                         frames=torch.from_numpy(frames))
    enc = pc["enc_out"].clone()
    rl, rc = api.prefill(params, jnp.asarray(more), rc)
    pl, pc = port.prefill(pp, torch.from_numpy(more), pc)
    assert torch.equal(pc["enc_out"], enc) and pc["pos"].tolist() == [12, 12]
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **MODEL_TOL)


def _count_calls(monkeypatch):
    from repro_torch.models import layers as p_layers

    calls = dict.fromkeys(("rmsnorm", "flash_attention", "decode_attention",
                           "ssd_chunks"), 0)
    for attr, name in (("rmsnorm", "rmsnorm"), ("mha", "flash_attention"),
                       ("decode_mha", "decode_attention")):
        def counted(*a, _fn=getattr(p_layers, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(p_layers, attr, counted)
    return calls


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_encdec_kernel_launches_count_the_call_sites(norm, monkeypatch):
    """Two prefills with frames, one without, three decode steps, then one
    remat train step: the calls the smoke model makes into each kernel
    wrapper equal ``encdec.kernel_launches``."""
    calls = _count_calls(monkeypatch)
    cfg = dataclasses.replace(p_registry.get("seamless-m4t-medium",
                                             smoke=True).cfg, norm=norm)
    api = p_registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, 257, (2, 6)).astype(np.int32))
    frames = torch.as_tensor(rng.standard_normal((2, 8, 64)).astype(
        np.float32))
    cache = api.init_cache(2, 32, device=CPU)
    for kw in ({"frames": frames}, {"frames": frames}, {}):
        logits, cache = api.prefill(params, toks[:, :2], cache, **kw)
    for _ in range(3):
        logits, cache = api.decode_step(
            params, logits[:, -1].argmax(-1, keepdim=True).to(torch.int32),
            cache)
    assert calls == p_encdec.kernel_launches(cfg, 3, 3, encodes=2)
    remat = dataclasses.replace(cfg, remat="full")
    api = p_registry.get_model(remat)
    calls.update(dict.fromkeys(calls, 0))
    p_train.value_and_grad(api.loss_fn, params, {
        "tokens": toks, "labels": toks, "frames": frames})
    assert calls == p_encdec.kernel_launches(remat, train_steps=1)


def test_encdec_full_size_launch_closed_forms():
    cfg = p_registry.get("seamless-m4t-medium").cfg     # 12 + 12, LayerNorm
    assert p_registry.kernel_launches(cfg, 8, 32, encodes=8) == {
        "rmsnorm": 0, "flash_attention": 8 * (12 + 2 * 12) + 32 * 12,
        "decode_attention": 32 * 12, "ssd_chunks": 0}
    assert p_registry.kernel_launches(cfg, train_steps=2) == {
        "rmsnorm": 0, "flash_attention": 2 * 2 * (12 + 2 * 12),
        "decode_attention": 0, "ssd_chunks": 0}


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("arch", ARCHS)
def test_server_serves_like_the_reference(arch):
    """The port's Server, unchanged, against the reference's on the same
    requests: tokens, terminal states, stats and install ledgers (the
    cache region holds seamless' ``enc_out``)."""
    api, params, port, pp = _model(arch)
    ref = RServer(api, params, slots=2, max_seq=64)
    srv = Server(port, pp, slots=2, max_seq=64, device=CPU)
    assert {k: (l.h2d_bytes, l.h2d_calls)
            for k, l in srv.program.ledgers.items()} == \
        {k: (l.h2d_bytes, l.h2d_calls) for k, l in ref.program.ledgers.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 257, 4 + (i % 5)).astype(np.int32)
               for i in range(5)]
    for i, prompt in enumerate(prompts):
        ref.submit(RRequest(rid=i, prompt=prompt, max_new_tokens=5))
        srv.submit(Request(rid=i, prompt=prompt, max_new_tokens=5))
    want = {r.rid: (r.state, list(r.tokens_out))
            for r in ref.run(max_steps=200)}
    got = {r.rid: (r.state, list(r.tokens_out))
           for r in srv.run(max_steps=200)}
    assert got == want and len(got) == 5
    assert srv.stats.as_dict() == ref.stats.as_dict()
    srv.tracker.assert_conserved()
