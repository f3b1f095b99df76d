"""The port's Mamba2 path — the SSD chunk kernel's plain version, the
chunked scan, the Mamba2 mixer and the mamba2 / zamba2 models — held
against the JAX package on the CPU.

  * ``kernels.ssd_scan``'s plain version (what ``ssd_chunks`` runs for a
    CPU tensor) against the Pallas kernel in interpret mode and against
    ``ref.ssd_chunk_ref`` tile by tile, at ``tests/test_kernels.py``'s
    shapes plus a chunk of 37 steps, within 1e-4 in f32;
  * ``ops.ssd_chunked_kernel`` against the reference's
    ``ssd_chunked_kernel`` and ``models.ssm.ssd_chunked`` (1e-4) and
    against the literal per-token recurrence (1e-3, the tolerance of
    ``test_kernels.py::test_ssd_chunked_matches_sequential_recurrence``);
  * the scan's gradients (the plain version under autograd, which is
    the card's backward) against ``jax.grad`` of ``ssd_chunked``, each
    within 1e-4 of the gradient's largest element, and the
    ``_SSDChunks`` Function's backward, with the kernel launch stood in
    for by the plain version, against autograd of the plain version for
    every subset of the outputs that carries a gradient;
  * ``apply_ssm``, ``forward``, ``prefill`` and ``decode_step`` of the smoke
    mamba2 and the smoke zamba2, with the reference's weights carried
    across by ``params_from_reference``, within 2e-4 in f32, and the
    port's prefill-then-decode logits against its own full forward
    (``test_models.py::test_decode_matches_teacher_forcing``'s check).

Inputs are drawn with numpy from fixed seeds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as r_mamba, zamba2_2_7b as r_zamba
from repro.core import leaf_paths as r_leaf_paths
from repro.kernels.ssd_scan import kernel as r_ssd, ops as r_ssd_ops
from repro.kernels.ssd_scan import ref as r_ssd_ref
from repro.models import lm as r_lm
from repro.models import registry as r_registry
from repro.models import ssm as r_ssm

from repro_torch.configs import mamba2_1_3b as p_mamba, zamba2_2_7b as p_zamba
from repro_torch.convert import params_from_reference
from repro_torch.core import leaf_paths, tree_leaves
from repro_torch.kernels.ssd_scan import kernel as SK, ops as SO
from repro_torch.models import lm as p_lm
from repro_torch.models import registry as p_registry
from repro_torch.models import ssm as p_ssm
from repro_torch.models.specs import param_count

CPU = "cpu"
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
# tests/test_kernels.py's shapes, plus one chunk of 37 steps and a
# chunk-multiple sequence at a chunk that is not a power of two
SSD_SHAPES = [(2, 64, 3, 8, 4, 16), (1, 128, 2, 16, 8, 32),
              (2, 32, 1, 8, 16, 8), (1, 37, 2, 8, 4, 256),
              (2, 74, 2, 16, 8, 37)]


def _scan_inputs(rng, B, S, nh, hd, N):
    """x, dt (> 0), A (< 0), Bm, Cm as test_kernels.py draws them."""
    return (rng.standard_normal((B, S, nh, hd)).astype(np.float32),
            (np.abs(rng.standard_normal((B, S, nh))) * 0.1 + 0.01
             ).astype(np.float32),
            (-np.abs(rng.standard_normal(nh)) - 0.1).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


def _chunked(x, dt, A, Bm, Cm, chunk):
    """The chunk kernel's inputs, laid out as the reference's ops.py lays
    them out (numpy)."""
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xc = x.reshape(B, nc, Q, nh, hd).transpose(0, 1, 3, 2, 4)
    dtc = dt.reshape(B, nc, Q, nh).transpose(0, 1, 3, 2)[:, :, :, None, :]
    dtA = (dt * A[None, None, :]).reshape(B, nc, Q, nh).transpose(
        0, 1, 3, 2)[:, :, :, None, :]
    return [np.ascontiguousarray(a) for a in
            (xc, dtc, dtA, Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N))]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------ the chunk kernel

@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_SHAPES)
def test_ssd_plain_version_equals_pallas_and_the_oracle(B, S, nh, hd, N,
                                                        chunk):
    ins = _chunked(*_scan_inputs(np.random.default_rng(S), B, S, nh, hd, N),
                   chunk)
    before = SK.ssd_chunks.launches
    y, st, cum = SK.ssd_chunks(*_t(*ins))
    assert SK.ssd_chunks.launches == before          # the CPU launches nothing
    assert y.dtype == torch.float32 and st.dtype == cum.dtype == torch.float32
    py, pst, pcum = r_ssd.ssd_chunks(*map(jnp.asarray, ins), interpret=True)
    for got, want in ((y, py), (st, pst), (cum, pcum)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    xc, dtc, dtA, Bc, Cc = ins
    nc = xc.shape[1]
    for b in range(B):
        for c in range(nc):
            for h in range(nh):
                oy, ost, ocum = r_ssd_ref.ssd_chunk_ref(
                    xc[b, c, h], dtc[b, c, h, 0], dtA[b, c, h, 0], Bc[b, c],
                    Cc[b, c])
                np.testing.assert_allclose(y[b, c, h].numpy(), oy, **SSD_TOL)
                np.testing.assert_allclose(st[b, c, h].numpy(), ost,
                                           **SSD_TOL)
                np.testing.assert_allclose(cum[b, c, h, 0].numpy(), ocum,
                                           **SSD_TOL)


def test_ssd_plain_version_never_overflows_above_the_diagonal():
    """A steep decay makes exp(cum_i - cum_j) overflow for i < j; those
    entries are masked before the exp, so nothing is inf or NaN."""
    rng = np.random.default_rng(11)
    x, dt, A, Bm, Cm = _scan_inputs(rng, 1, 64, 2, 8, 4)
    dt = dt * 400.0                                     # cum falls by ~1e3
    ins = _chunked(x, dt, A, Bm, Cm, 64)
    y, st, _ = SK.ssd_chunks(*_t(*ins))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    py, pst, _ = r_ssd.ssd_chunks(*map(jnp.asarray, ins), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **SSD_TOL)


def test_ssd_chunks_rejects_mismatched_shapes():
    x = torch.zeros(1, 2, 3, 8, 4)
    dt = torch.zeros(1, 2, 3, 1, 8)
    bm = torch.zeros(1, 2, 8, 5)
    with pytest.raises(ValueError, match="one chunked scan"):
        SK.ssd_chunks(x, dt, dt, bm[:, :, :7], bm[:, :, :7])
    with pytest.raises(ValueError, match="want x"):
        SK.ssd_chunks(x[0], dt, dt, bm, bm)
    with pytest.raises(ValueError, match="one device"):
        SK.ssd_chunks(x, dt, dt, bm, torch.zeros(1, 2, 8, 5, device="meta"))


def _fake_launch(x, dt, dtA, Bm, Cm):
    """The plain version in the kernel launch's output layout: y_diag's
    contiguous (B, nc, Q, nh, hd) base."""
    y, st, cum = SK.ref.ssd_chunks_ref(x, dt, dtA, Bm, Cm)
    return y.transpose(2, 3).contiguous(), st, cum


@pytest.mark.parametrize("outputs", [(0,), (1,), (2,), (0, 1, 2)])
def test_ssd_function_backward_is_the_plain_gradient(outputs, monkeypatch):
    """The card's autograd Function, run on the CPU with the launch stood
    in for: the backward returns the plain version's gradients for the
    outputs that received one (y_diag, states, cum), None-safe."""
    monkeypatch.setattr(SK, "_launch", _fake_launch)
    ins = _t(*_chunked(*_scan_inputs(np.random.default_rng(21), 2, 32, 3, 8,
                                     4), 16))
    rng = np.random.default_rng(22)
    fn = [t.clone().requires_grad_() for t in ins]
    y, st, cum = SK._SSDChunks.apply(*fn)
    outs = (y.transpose(2, 3), st, cum)
    gs = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
          for o in outs]
    got = torch.autograd.grad([outs[i] for i in outputs], fn,
                              [gs[i] for i in outputs], allow_unused=True)
    plain = [t.clone().requires_grad_() for t in ins]
    ref_outs = SK.ref.ssd_chunks_ref(*plain)
    want = torch.autograd.grad([ref_outs[i] for i in outputs], plain,
                               [gs[i] for i in outputs], allow_unused=True)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------- the full scan

@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_SHAPES)
def test_ssd_chunked_kernel_gradients_equal_the_reference(B, S, nh, hd, N,
                                                          chunk):
    rng = np.random.default_rng(200 + S)
    ins = _scan_inputs(rng, B, S, nh, hd, N)
    init = rng.standard_normal((B, nh, hd, N)).astype(np.float32)
    gy = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    gst = rng.standard_normal((B, nh, hd, N)).astype(np.float32)

    def r_obj(*a):
        y, st = r_ssm.ssd_chunked(*a[:5], chunk=chunk, init_state=a[5])
        return jnp.sum(y * gy) + jnp.sum(st * gst)

    want = jax.grad(r_obj, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in ins], jnp.asarray(init))
    leaves = [t.requires_grad_() for t in _t(*ins, init)]
    y, st = SO.ssd_chunked_kernel(*leaves[:5], chunk=chunk,
                                  init_state=leaves[5])
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gst)).sum(),
        leaves)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        bound = 1e-4 * float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= bound, i


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_kernel_equals_the_reference(B, S, nh, hd, N, chunk,
                                                 with_init):
    rng = np.random.default_rng(100 + S)
    ins = _scan_inputs(rng, B, S, nh, hd, N)
    init = rng.standard_normal((B, nh, hd, N)).astype(np.float32) \
        if with_init else None
    y, st = SO.ssd_chunked_kernel(
        *_t(*ins), chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    jin = [jnp.asarray(a) for a in ins]
    jinit = None if init is None else jnp.asarray(init)
    r_chunked = jax.jit(r_ssm.ssd_chunked, static_argnames="chunk")
    for ry, rst in (r_ssd_ops.ssd_chunked_kernel(*jin, chunk=chunk,
                                                 init_state=jinit),
                    r_chunked(*jin, chunk=chunk, init_state=jinit)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(rst), **SSD_TOL)


def test_ssd_chunked_kernel_equals_the_sequential_recurrence():
    B, S, nh, hd, N = 2, 48, 2, 8, 4
    x, dt, A, Bm, Cm = _scan_inputs(np.random.default_rng(4), B, S, nh, hd,
                                    N)
    y, st = SO.ssd_chunked_kernel(*_t(x, dt, A, Bm, Cm), chunk=16)
    state = np.zeros((B, nh, hd, N))
    ys = []
    for t in range(S):
        decay = np.exp(dt[:, t] * A[None])
        upd = np.einsum("bn,bhd,bh->bhdn", Bm[:, t], x[:, t], dt[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(np.einsum("bn,bhdn->bhd", Cm[:, t], state))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(st.numpy(), state, rtol=1e-3, atol=1e-3)
    # one decode step of the port's recurrence continues it
    y1, st1 = p_ssm.ssd_step(*_t(x[:, -1], dt[:, -1], A, Bm[:, -1],
                                 Cm[:, -1]), torch.zeros(B, nh, hd, N))
    ry1, rst1 = r_ssm.ssd_step(*(jnp.asarray(a) for a in (
        x[:, -1], dt[:, -1], A, Bm[:, -1], Cm[:, -1])),
        jnp.zeros((B, nh, hd, N)))
    np.testing.assert_allclose(y1.numpy(), np.asarray(ry1), **SSD_TOL)
    np.testing.assert_allclose(st1.numpy(), np.asarray(rst1), **SSD_TOL)


# ------------------------------------------------------- configs / specs

@pytest.mark.parametrize("mods", [(r_mamba, p_mamba), (r_zamba, p_zamba)])
def test_config_copies_equal_the_reference(mods):
    r_cfg, p_cfg = (m.CONFIG for m in mods)
    ref = dataclasses.asdict(r_cfg)
    assert ref.pop("use_pallas") is False
    assert dataclasses.asdict(p_cfg) == ref
    ref_smoke = dataclasses.asdict(r_cfg.smoke())
    ref_smoke.pop("use_pallas")
    assert dataclasses.asdict(p_cfg.smoke()) == ref_smoke


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_the_reference(arch, smoke):
    r_tree = r_lm.spec_tree(r_registry.get(arch, smoke=smoke).cfg)
    p_tree = p_lm.spec_tree(p_registry.get(arch, smoke=smoke).cfg)
    r_leaves = jax.tree_util.tree_leaves(r_tree)
    assert [str(p) for p in leaf_paths(p_tree)] \
        == [str(p) for p in r_leaf_paths(r_tree)]
    for a, b in zip(tree_leaves(p_tree), r_leaves):
        assert (a.shape, a.axes, a.init, a.scale) == \
            (b.shape, b.axes, b.init, b.scale)
    count = param_count(p_tree)
    assert count == sum(int(np.prod(s.shape)) for s in r_leaves)
    if not smoke:
        assert count == {"mamba2-1.3b": 1446652928,
                         "zamba2-2.7b": 2422635680}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_the_reference(arch):
    r_cache = r_registry.get(arch, smoke=True).init_cache(3, 24)
    p_cache = p_registry.get(arch, smoke=True).init_cache(3, 24, device=CPU)
    assert sorted(p_cache) == sorted(r_cache)
    for key, want in r_cache.items():
        got = p_cache[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).split(".")[-1] == str(want.dtype), key
        assert not got.any()


# --------------------------------------------------- the models vs JAX

@functools.lru_cache(maxsize=None)
def _model(arch):
    """Built once per arch: pytest tears a parametrized module fixture
    down and up again when tests of other params come between."""
    api = r_registry.get(arch, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    port = p_registry.get(arch, smoke=True)
    return api, params, port, params_from_reference(jax.device_get(params),
                                                    CPU)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _close_cache(got, want, what):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   **MODEL_TOL, err_msg=f"{what} {key}")


@pytest.mark.parametrize("S", [1, 5, 21])
def test_apply_ssm_equals_the_reference(model, S):
    """The mixer alone, without a cache and from a nonzero cache (S == 1:
    the recurrent step; S = 21 at chunk 8: padded to 24)."""
    api, params, port, pp = model
    cfg = port.cfg
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.ssm_conv_width - 1, cfg.d_inner)
                               ).astype(np.float32)
    rp = jax.tree_util.tree_map(lambda a: a[1], params["blocks"]["ssm"])
    p = {k: v[1] for k, v in pp["blocks"]["ssm"].items()}
    r_apply = jax.jit(r_ssm.apply_ssm, static_argnums=0)
    want, _ = r_apply(api.cfg, rp, jnp.asarray(x))
    got, none = p_ssm.apply_ssm(cfg, p, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    want, want_c = r_apply(api.cfg, rp, jnp.asarray(x), cache={
        "state": jnp.asarray(state), "conv": jnp.asarray(conv)})
    cache = {"state": torch.from_numpy(state), "conv": torch.from_numpy(conv)}
    got, got_c = p_ssm.apply_ssm(cfg, p, torch.from_numpy(x), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _close_cache(got_c, want_c, f"S={S}")
    # out of place: the cache it was given is untouched
    assert torch.equal(cache["state"], torch.from_numpy(state))
    assert torch.equal(cache["conv"], torch.from_numpy(conv))


@pytest.fixture(scope="module")
def reference_run(model):
    """forward, prefill and three greedy decode steps of the reference on
    one token batch; the port replays the same inputs."""
    api, params, _, _ = model
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


def test_forward_equals_the_reference(model, reference_run):
    _, _, port, pp = model
    toks, want, _ = reference_run
    got, cache, aux = port.forward(pp, torch.from_numpy(toks))
    assert cache is None and float(aux) == 0.0
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_prefill_and_decode_equal_the_reference(model, reference_run):
    _, _, port, pp = model
    toks, _, steps = reference_run
    cache = port.init_cache(2, 32, device=CPU)
    for i, (nxt, want_logits, want_cache) in enumerate(steps):
        if nxt is None:
            logits, cache = port.prefill(pp, torch.from_numpy(toks), cache)
        else:
            logits, cache = port.decode_step(pp, torch.from_numpy(nxt), cache)
        np.testing.assert_allclose(logits.numpy(), want_logits, **MODEL_TOL)
        _close_cache(cache, want_cache, f"step {i}")


def test_decode_step_leaves_its_input_cache_unchanged(model):
    """The SSM state and conv tail are new tensors after a step, so a step
    retried from the same cache gives the same result."""
    _, _, port, pp = model
    cache = port.init_cache(2, 16, device=CPU)
    _, cache = port.prefill(pp, torch.tensor([[1, 2, 3], [4, 5, 6]]), cache)
    before = {k: v.clone() for k, v in cache.items()}
    tok = torch.tensor([[7], [8]], dtype=torch.int32)
    first, c1 = port.decode_step(pp, tok, cache)
    for key in ("state", "conv", "pos"):
        assert torch.equal(cache[key], before[key]), key
    again, c2 = port.decode_step(pp, tok, cache)
    assert torch.equal(first, again)
    for key in c1:
        assert torch.equal(c1[key], c2[key]), key


def test_decode_matches_teacher_forcing(model):
    """prefill + decode logits == the full forward's at the same positions
    (the check of test_models.py, at the port's model tolerance)."""
    _, _, port, pp = model
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, port.cfg.vocab_size, (B, S)).astype(np.int32))
    full, _, _ = port.forward(pp, toks)
    half = S // 2
    cache = port.init_cache(B, S, device=CPU)
    logits, cache = port.prefill(pp, toks[:, :half], cache)
    np.testing.assert_allclose(logits[:, -1].numpy(),
                               full[:, half - 1].numpy(), **MODEL_TOL)
    for t in range(half, S):
        logits, cache = port.decode_step(pp, toks[:, t:t + 1], cache)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   **MODEL_TOL, err_msg=f"step {t}")
