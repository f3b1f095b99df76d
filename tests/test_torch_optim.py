"""The port's optimizers, schedules and gradient compression against the
JAX package's, on the CPU.

The same numpy inputs (seeded) go through ``repro.optim`` and
``repro_torch.optim``: schedules equal exactly on their warmup and floor
stretches and within one float32 ulp on the cosine (the port rounds a
float64 cosine once, see ``optim/schedules.py``); adamw, adafactor, sgdm
and adamw8bit over 5 updates within rtol 1e-6; int8 compression bit
for bit; ``OffloadedOptimizer``'s per-step ledger equal per scheme.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as r_comp
from repro.optim import make_optimizer as r_make
from repro.optim import schedules as r_sched
from repro.optim.quantized import OffloadedOptimizer as ROffloaded
from repro.optim.quantized import _dequantize as r_deq
from repro.optim.quantized import _quantize as r_quant

from repro_torch.core import tree_leaves, tree_map
from repro_torch.optim import compression as p_comp
from repro_torch.optim import make_optimizer as p_make
from repro_torch.optim import schedules as p_sched
from repro_torch.optim.quantized import OffloadedOptimizer as POffloaded
from repro_torch.optim.quantized import _dequantize as p_deq
from repro_torch.optim.quantized import _quantize as p_quant

CPU = "cpu"
RTOL = 1e-6


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "blocks": {"k": rng.standard_normal((3, 4, 5)).astype(np.float32),
                       "s": rng.standard_normal((1, 7)).astype(np.float32)}}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref, what):
    pl, rl = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl), what
    for p, r in zip(pl, rl):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-7, err_msg=what)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("args", [(3e-4, 11, 100), (1.0, 10, 100),
                                  (3e-4, 2, 12), (0.5, 0, 40)])
def test_warmup_cosine_equals_the_reference(args):
    peak, warmup, total = args
    r, p = r_sched.warmup_cosine(*args), p_sched.warmup_cosine(*args)
    for step in range(total + 20):
        want = np.float32(r(jnp.int32(step)))
        got = p(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        got = np.float32(got.item())
        t = (step - warmup) / max(1, total - warmup)
        if step < warmup or t >= 1.0:
            assert got == want, (step, got, want)      # no cosine: exact
        else:
            ulps = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
            assert ulps <= 1, (step, got, want)


def test_constant_schedule_equals_the_reference():
    for step in (0, 3, 1000):
        got = p_sched.constant(3e-4)(torch.tensor(step))
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == np.float32(r_sched.constant(3e-4)(step))


# --------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm", "adamw8bit"])
def test_five_updates_equal_the_reference(name):
    params = _np_tree(0)
    r_opt, p_opt = r_make(name), p_make(name)
    r_p = jax.tree_util.tree_map(jnp.asarray, params)
    p_p = _torch(params)
    r_s, p_s = r_opt.init(r_p), p_opt.init(p_p)
    _close(p_s, r_s, f"{name} init")
    for i in range(5):
        g = _np_tree(100 + i)
        lr = 0.05 * (i + 1)
        r_p, r_s = r_opt.update(jax.tree_util.tree_map(jnp.asarray, g), r_s,
                                r_p, jnp.float32(lr))
        p_p, p_s = p_opt.update(_torch(g), p_s, p_p,
                                torch.tensor(lr, dtype=torch.float32))
        _close(p_p, r_p, f"{name} params after update {i}")
        _close(p_s, r_s, f"{name} state after update {i}")
    # the state trees have the reference's structure, leaf for leaf
    assert [tuple(t.shape) for t in tree_leaves(p_s)] == [
        tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(r_s)]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm", "adamw8bit"])
def test_update_is_functional(name):
    """Nothing given to ``update`` is written in place: a staged param or
    moment may be a view of a retained transfer bucket."""
    opt = p_make(name)
    params = _torch(_np_tree(0))
    state = opt.init(params)
    before = [t.clone() for t in tree_leaves(params) + tree_leaves(state)]
    versions = [t._version for t in tree_leaves(params) + tree_leaves(state)]
    opt.update(_torch(_np_tree(1)), state, params, torch.tensor(0.1))
    after = tree_leaves(params) + tree_leaves(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert [t._version for t in after] == versions


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_abstract_state_matches_init(name):
    opt = p_make(name)
    params = _torch(_np_tree(0))
    concrete = opt.init(params)
    abstract = opt.abstract(tree_map(lambda t: t, params))
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(concrete)] == [
        (tuple(a.shape), a.dtype) for a in tree_leaves(abstract)]


def test_bf16_params_update_in_f32_and_cast_back():
    """A bf16 param is updated in float32 and cast back, as the reference
    does; the moments stay float32."""
    import ml_dtypes  # noqa: F401  (numpy's bfloat16 for the reference)

    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    g = rng.standard_normal((4, 8)).astype(np.float32)
    r_opt, p_opt = r_make("adamw"), p_make("adamw")
    r_p = {"w": jnp.asarray(w, jnp.bfloat16)}
    p_p = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    r_p, r_s = r_opt.update({"w": jnp.asarray(g, jnp.bfloat16)},
                            r_opt.init(r_p), r_p, jnp.float32(1e-2))
    p_p, p_s = p_opt.update({"w": torch.from_numpy(g).to(torch.bfloat16)},
                            p_opt.init(p_p), p_p, torch.tensor(1e-2))
    assert p_p["w"].dtype == torch.bfloat16 and p_s["mu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(p_p["w"].float().numpy(),
                                  np.asarray(r_p["w"], np.float32))
    np.testing.assert_allclose(p_s["nu"]["w"].numpy(),
                               np.asarray(r_s["nu"]["w"]), rtol=RTOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_minimizes_quadratic(name):
    opt = p_make(name)
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32))
    params = {"w": torch.zeros(8, 16), "b": torch.zeros(16)}
    state = opt.init(params)

    def loss_fn(p):
        return ((p["w"] - target) ** 2).mean() + ((p["b"] - 1.0) ** 2).mean()

    lr = 0.05 if name != "sgdm" else 0.2
    loss0 = float(loss_fn(params))
    for _ in range(60):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves),
                                                     list(leaves.values()))))
        params, state = opt.update(grads, state, params, lr)
    assert float(loss_fn(params)) < 0.2 * loss0


def test_adafactor_state_is_factored():
    state = p_make("adafactor").init({"w": torch.zeros(64, 32),
                                      "b": torch.zeros(32)})
    assert state["v"]["w"]["vr"].shape == (64,)
    assert state["v"]["w"]["vc"].shape == (32,)
    assert state["v"]["b"]["v"].shape == (32,)


def test_optimizer_axes_mirror_the_reference():
    axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    for name in ("adamw", "adafactor", "sgdm", "adamw8bit"):
        assert p_make(name).axes(axes) == r_make(name).axes(axes), name


# ------------------------------------------------------------- compression

@pytest.mark.parametrize("n", [1, 2047, 2048, 5000])
def test_quantize_int8_is_bit_equal(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    x[: n // 3] = 0.0                       # zero chunks and ties
    rq, rs, rn = r_comp.quantize_int8(jnp.asarray(x))
    pq, ps, pn = p_comp.quantize_int8(torch.from_numpy(x))
    assert rn == pn == n
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        p_comp.dequantize_int8(pq, ps, n).numpy(),
        np.asarray(r_comp.dequantize_int8(rq, rs, n)))


def test_round_half_to_even_as_the_reference():
    """Exact halves after scaling: both packages round them to even."""
    x = np.zeros(p_comp.CHUNK, np.float32)
    x[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    rq, _, _ = r_comp.quantize_int8(jnp.asarray(x))
    pq, _, _ = p_comp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))


def test_compress_with_feedback_is_bit_equal_over_steps():
    rng = np.random.default_rng(1)
    n = p_comp.CHUNK * 2 + 17
    r_err, p_err = jnp.zeros(n, jnp.float32), torch.zeros(n)
    for _ in range(10):
        g = (rng.standard_normal(n) * 0.01).astype(np.float32)
        rq, rs, r_err = r_comp.compress_with_feedback(jnp.asarray(g), r_err)
        pq, ps, p_err = p_comp.compress_with_feedback(torch.from_numpy(g),
                                                      p_err)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(p_err.numpy(), np.asarray(r_err))


def test_init_error_buffers_skip_integer_buckets():
    bufs = {"float32": torch.zeros(10), "int32": torch.zeros(4, dtype=torch.int32),
            "bfloat16": torch.zeros(6, dtype=torch.bfloat16)}
    out = p_comp.init_error_buffers(bufs)
    assert sorted(out) == ["bfloat16", "float32"]
    assert all(v.dtype == torch.float32 for v in out.values())


def test_8bit_block_quantization_is_bit_equal():
    x = np.random.default_rng(4).standard_normal((37, 13)).astype(np.float32)
    rq, pq = r_quant(jnp.asarray(x)), p_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(pq["q"].numpy(), np.asarray(rq["q"]))
    np.testing.assert_array_equal(pq["scale"].numpy(), np.asarray(rq["scale"]))
    np.testing.assert_array_equal(p_deq(pq, x.shape).numpy(),
                                  np.asarray(r_deq(rq, x.shape)))


# ------------------------------------------------------- offloaded optimizer

def _ledger(scheme):
    l = scheme.ledger
    return (l.h2d_bytes, l.h2d_calls, l.skipped_bytes)


@pytest.mark.parametrize("scheme", ["marshal", "uvm", "pointerchain",
                                    "marshal+delta"])
def test_offloaded_optimizer_ledger_and_params_equal_the_reference(scheme):
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    r_off = ROffloaded(r_make("adamw"), scheme)
    p_off = POffloaded(p_make("adamw"), scheme, device=CPU)
    r_p = {"w": jnp.asarray(w0), "b": jnp.zeros(4)}
    p_p = {"w": torch.from_numpy(w0.copy()), "b": torch.zeros(4)}
    r_off.init(r_p)
    p_off.init(p_p)
    for i in range(4):
        g = {"w": rng.standard_normal((8, 4)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32)}
        r_p = r_off.step(jax.tree_util.tree_map(jnp.asarray, g), r_p, 0.05)
        p_p = p_off.step(_torch(g), p_p, 0.05)
        assert _ledger(p_off.scheme) == _ledger(r_off.scheme), (scheme, i)
        _close(p_p, r_p, f"{scheme} step {i}")
