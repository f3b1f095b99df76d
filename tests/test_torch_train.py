"""The port's training path against the JAX package's, on the CPU.

The same weights (``train_state_from_reference``) and the same seeded
numpy batches go through ``repro`` and ``repro_torch``:

  * ``loss_fn`` and its gradients on the smoke llama3.2-1b, starcoder2-3b,
    mamba2-1.3b, zamba2-2.7b, moonshot-v1-16b-a3b and arctic-480b (f32)
    against ``jax.value_and_grad``: the loss and metrics (the MoE aux loss
    among them) within rtol 1e-4, the gradients leaf by leaf against the
    leaf's largest magnitude (``|port - ref| <= 1e-6 + 2e-4 * max|ref|``,
    ``GRAD_RTOL`` says why): the packages sum in different orders, and an
    element that nearly cancels keeps an absolute float32 error that no
    elementwise rtol covers;
  * ``make_train_step`` with ``micro_batches`` 1 and 2 over 3 steps:
    each step taken by both packages from the reference's state of that
    step (the trajectory of this tiny model amplifies a float32 difference
    in the params step by step, in either package alone, so free-running
    trajectories part within three steps), the metrics within
    rtol 1e-4, each leaf's update and momentum as the gradients.  The steps run SGD with momentum, linear in the gradients:
    AdamW's first update is ``lr * g / (|g| + eps)``, the sign of g, so an
    element whose gradient is float32 noise in both packages moves by ±lr
    in one and not the other.  AdamW's update itself is held to the
    reference on the same gradients in tests/test_torch_optim.py;
  * ``make_dp_train_step`` at dp 1 for ``pertensor``, ``arena`` and
    ``arena`` + ``compress`` against the reference on a one-device mesh
    (the error-feedback buffers too);
  * the device-side arena transforms (``pack_traced``, ``unpack_traced``,
    ``repack_traced``, ``ArenaEntry.repack``, ``arena.repack_into``) bit
    for bit, and ``TransferProgram.mark_dirty``'s region ledgers equal;
  * remat ``none`` / ``dots`` / ``full`` giving equal values and the
    launch counts ``kernel_launches(train_steps=)`` predicts, for llama,
    mamba2 and zamba2 (the Mamba2 blocks and the hybrid's shared block
    are each checkpointed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.core import arena as r_arena
from repro.core import engine as r_engine
from repro.core import get_session as r_get_session
from repro.models import registry as r_registry
from repro.optim import constant as r_constant
from repro.optim import make_optimizer as r_make
from repro.runtime import train as r_train

from repro_torch.convert import (from_reference_tree, train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core import TransferSession, arena as p_arena
from repro_torch.core import engine as p_engine
from repro_torch.core import tree_leaves
from repro_torch.core.sharded import replica
from repro_torch.models import lm as p_lm
from repro_torch.models import registry as p_registry
from repro_torch.optim import compression as p_comp
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import train as p_train

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6
# gradients, against each leaf's largest element: each package's float32
# gradients are within half of this of float64 ones of the same model and
# batch (tests/test_torch_train_precision.py; XLA fuses and contracts
# elementwise chains, eager PyTorch rounds every op), so two correct
# float32 implementations may differ by up to this
GRAD_RTOL = 2e-4


def _batch(vocab, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                       # masked label positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _close(port_tree, ref_tree, what, rtol=RTOL, atol=ATOL, per_leaf=False):
    """Elementwise allclose, or with ``per_leaf`` the tolerance scaled by
    each leaf's largest reference magnitude."""
    pl, rl = tree_leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(pl) == len(rl), what
    for i, (p, r) in enumerate(zip(pl, rl)):
        got = p.detach().float().numpy()
        want = np.asarray(r, np.float32)
        if per_leaf:
            bound = atol + rtol * float(np.abs(want).max(initial=0.0))
            err = float(np.abs(got - want).max(initial=0.0))
            assert err <= bound, f"{what} leaf {i}: {err} > {bound}"
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"{what} leaf {i}")


def _pair(arch, **replace):
    cfg = r_registry.get(arch, smoke=True).cfg
    pcfg = p_registry.get(arch, smoke=True).cfg
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
        pcfg = dataclasses.replace(pcfg, **replace)
    return r_registry.get_model(cfg), p_registry.get_model(pcfg)


# ---------------------------------------------------------- loss and grads

@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-3b",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "arctic-480b"])
def test_loss_and_gradients_equal_the_reference(arch):
    r_api, p_api = _pair(arch)
    params = r_api.init(jax.random.PRNGKey(3))
    batch = _batch(r_api.cfg.vocab_size)
    (r_loss, r_met), r_g = jax.value_and_grad(
        lambda p: r_api.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                    batch.items()}), has_aux=True)(params)
    pp = train_state_from_reference(jax.device_get(params), CPU)
    loss, met, grads = p_train.value_and_grad(
        p_api.loss_fn, pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=RTOL)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(met[k]), float(r_met[k]), rtol=RTOL,
                                   atol=ATOL)
    assert float(met["tokens"]) == 4 * 16 - 3
    _close(grads, r_g, f"{arch} grads", rtol=GRAD_RTOL, per_leaf=True)
    assert all(bool(g.abs().max() > 0) for g in tree_leaves(grads))


def test_value_and_grad_writes_no_param():
    _, p_api = _pair("llama3.2-1b")
    params = p_api.init(torch.Generator().manual_seed(0), device=CPU)
    versions = [t._version for t in tree_leaves(params)]
    p_train.value_and_grad(p_api.loss_fn, params, {
        k: torch.as_tensor(v) for k, v in _batch(257).items()})
    assert [t._version for t in tree_leaves(params)] == versions
    assert not any(t.requires_grad for t in tree_leaves(params))


# ----------------------------------------------------------- train steps

def _update(new, old):
    return [a.detach().float() - b.detach().float()
            for a, b in zip(tree_leaves(new), tree_leaves(old))]


def _r_update(new, old):
    return [np.asarray(a, np.float32) - np.asarray(b, np.float32)
            for a, b in zip(jax.tree_util.tree_leaves(new),
                            jax.tree_util.tree_leaves(old))]


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_equals_the_reference(micro):
    r_api, p_api = _pair("llama3.2-1b", micro_batches=micro)
    r_opt, p_opt = r_make("sgdm"), make_optimizer("sgdm")
    r_step = jax.jit(r_train.make_train_step(r_api, r_opt, r_constant(1e-2)))
    p_step = p_train.make_train_step(p_api, p_opt, constant(1e-2))
    r_state = jax.device_get(r_train.train_state(r_api, r_opt,
                                                 jax.random.PRNGKey(1)))
    for i in range(3):
        batch = _batch(257, seed=10 + i)
        p_in = train_state_from_reference(r_state, CPU)
        r_new, r_met = r_step(r_state, batch)
        p_new, p_met = p_step(p_in, batch)
        r_new = jax.device_get(r_new)
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(p_met[k]), float(r_met[k]),
                                       rtol=RTOL, err_msg=f"{k} step {i}")
        _close(_update(p_new["params"], p_in["params"]),
               _r_update(r_new["params"], r_state["params"]),
               f"param update of step {i}", rtol=GRAD_RTOL, per_leaf=True)
        _close(p_new["opt"], r_new["opt"], f"momentum after step {i}",
               rtol=GRAD_RTOL, per_leaf=True)
        assert int(p_new["step"]) == int(r_new["step"]) == i + 1
        r_state = r_new
    back = train_state_to_reference(p_new)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(r_new)


def _quantum_close(port, ref, corrected, what):
    """Bucket ``port`` against ``ref`` elementwise within float32 noise,
    except where the int8 rounding went the other way (the gradients
    differ by float32 noise): there by at most one quantum of the chunk
    (its largest |corrected gradient| / 127), at under 5 % of the
    elements."""
    C = p_comp.CHUNK
    n = port.shape[0]
    pad = lambda a: np.pad(a, (0, (-n) % C)).reshape(-1, C)
    quantum = np.abs(pad(corrected)).max(axis=1, keepdims=True) / 127.0
    err = np.abs(pad(port) - pad(ref))
    top = float(np.abs(ref).max(initial=0.0))
    assert (err <= 1.01 * quantum + ATOL).all(), what
    assert (err > ATOL + GRAD_RTOL * top).mean() < 0.05, what


@pytest.mark.parametrize("scheme,compress", [("pertensor", False),
                                             ("arena", False),
                                             ("arena", True)])
def test_dp_train_step_at_dp1_equals_the_reference(scheme, compress):
    """Each step from the reference's state and error buffers of that
    step.  Without compression, as the plain step.  With it, the gradients
    delivered (read back from SGD's momentum) may differ by one int8
    quantum where the rounding went the other way, and the error-feedback
    invariant holds across the packages: delivered + new error ==
    gradient + old error, within float32 noise."""
    r_api, p_api = _pair("llama3.2-1b")
    r_opt, p_opt = r_make("sgdm"), make_optimizer("sgdm")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    r_step = jax.jit(r_train.make_dp_train_step(
        r_api, r_opt, r_constant(1e-2), mesh, grad_scheme=scheme,
        compress=compress))
    p_step = p_train.make_dp_train_step(p_api, p_opt, constant(1e-2), 1,
                                        grad_scheme=scheme, compress=compress)
    r_err = r_train.init_error_state(r_api, compress, mesh=mesh)
    p_err = p_train.init_error_state(p_api, compress, device=CPU)
    assert {k: tuple(v.shape) for k, v in p_err.items()} == \
        {k: tuple(v.shape) for k, v in r_err.items()}
    r_state = jax.device_get(r_train.train_state(r_api, r_opt,
                                                 jax.random.PRNGKey(2)))
    layout = TransferSession().plan(
        train_state_from_reference(r_state["params"], CPU),
        p_train.grad_arena_spec(1))
    for i in range(3):
        batch = _batch(257, seed=20 + i)
        p_in = train_state_from_reference(r_state, CPU)
        p_err = {b: torch.from_numpy(np.array(v)) for b, v in r_err.items()}
        r_new, r_met, r_err_new = r_step(r_state, batch, r_err)
        p_new, p_met, p_err_new = p_step(p_in, batch, p_err)
        r_new = jax.device_get(r_new)
        np.testing.assert_allclose(float(p_met["loss"]), float(r_met["loss"]),
                                   rtol=RTOL)
        got = _update(p_new["params"], p_in["params"])
        want = _r_update(r_new["params"], r_state["params"])
        if not compress:
            _close(got, want, f"param update of step {i}", rtol=GRAD_RTOL,
                   per_leaf=True)
        else:
            # delivered_t = mu_t - 0.9 mu_(t-1)
            p_sent = [a - 0.9 * b for a, b in zip(
                tree_leaves(p_new["opt"]["mu"]), tree_leaves(p_in["opt"]["mu"]))]
            r_sent = [np.asarray(a) - np.float32(0.9) * np.asarray(b)
                      for a, b in zip(jax.tree_util.tree_leaves(
                          r_new["opt"]["mu"]), jax.tree_util.tree_leaves(
                          r_state["opt"]["mu"]))]
            p_flat = p_engine.pack_traced(layout.treedef.unflatten(p_sent),
                                          layout)
            r_flat = p_engine.pack_traced(layout.treedef.unflatten(
                [torch.from_numpy(a) for a in r_sent]), layout)
            for b in p_err_new:
                n = p_flat[b].shape[0]
                r_corr = (r_flat[b] + torch.from_numpy(np.array(
                    r_err_new[b]))[:n]).numpy()
                _quantum_close(p_flat[b].numpy(), r_flat[b].numpy(), r_corr,
                               f"delivered gradients step {i}")
                # what was delivered plus what was kept back
                _close([p_flat[b] + p_err_new[b][:n]], [r_corr],
                       f"error-feedback invariant step {i}", rtol=GRAD_RTOL,
                       per_leaf=True)
        r_state, r_err = r_new, jax.device_get(r_err_new)


def test_dp_above_one_and_bad_arguments_raise():
    """dp above one runs now (this test pinned its refusal): a dp-2 step on
    two CPU positions sums the positions' gradients (as the reference's,
    not their mean), so from a zero momentum its delivered gradient is
    the sum of the two batch halves' gradients; and ``replicate_state``
    makes one real copy a position.  The bad arguments
    still raise: compression without the arena, dp < 1, a mesh with fewer
    positions than dp."""
    _, p_api = _pair("llama3.2-1b")
    opt = make_optimizer("sgdm")
    state = p_train.train_state(p_api, opt, torch.Generator().manual_seed(0),
                                device=CPU)
    batch = _batch(257, seed=7)
    step = p_train.make_dp_train_step(p_api, opt, constant(1e-2), 2,
                                      device=CPU, grad_scheme="pertensor")
    new, met, err = step(state, batch, {})
    got = [replica(m, 1) for m in tree_leaves(new["opt"]["mu"])]
    halves = [p_train.value_and_grad(
        p_api.loss_fn, state["params"],
        {k: torch.as_tensor(v)[i:i + 2] for k, v in batch.items()})[2]
        for i in (0, 2)]
    want = [a + b for a, b in zip(tree_leaves(halves[0]),
                                  tree_leaves(halves[1]))]
    _close(got, want, "dp-2 delivered gradient", rtol=GRAD_RTOL,
           per_leaf=True)
    assert err == {}
    assert int(replica(new["step"], 0)) == 1
    x = torch.arange(3.0)
    rep = p_train.replicate_state({"x": x}, 2, device=CPU)["x"]
    assert [p.tensor.data_ptr() != x.data_ptr() for p in rep.pieces] == \
        [True, True]
    assert all(torch.equal(replica(rep, i), x) for i in range(2))
    with pytest.raises(ValueError, match="arena"):
        p_train.make_dp_train_step(p_api, opt, constant(1e-2), 1,
                                   grad_scheme="pertensor", compress=True)
    with pytest.raises(ValueError, match=">= 1"):
        p_train.make_dp_train_step(p_api, opt, constant(1e-2), 0,
                                   device=CPU)
    with pytest.raises(ValueError, match="stale"):
        p_train.make_dp_train_step(p_api, opt, constant(1e-2), 4,
                                   device=(torch.device("cpu"),) * 2)
    state = {"x": torch.zeros(1)}
    assert p_train.replicate_state(state, 1) is state


def test_policy_and_spec_strings_equal_the_reference():
    for dp in (1, 4):
        assert str(p_train.state_transfer_policy(dp)) == \
            str(r_train.state_transfer_policy(dp))
        assert str(p_train.grad_arena_spec(dp)) == \
            str(r_train.grad_arena_spec(dp))


# ---------------------------------------------------------------- remat

def _count_calls(monkeypatch):
    from repro_torch.models import layers as p_layers, ssm as p_ssm

    calls = {"rmsnorm": 0, "flash_attention": 0, "ssd_chunks": 0}
    for mod, attr, name in ((p_layers, "rmsnorm", "rmsnorm"),
                            (p_layers, "mha", "flash_attention"),
                            (p_ssm, "ssd_chunked_kernel", "ssd_chunks")):
        def counted(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return calls


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "zamba2-2.7b"])
@pytest.mark.parametrize("micro", [1, 2])
def test_remat_policies_give_equal_values_and_counted_launches(
        arch, micro, monkeypatch):
    """The three policies give the same loss, gradients and new params,
    and each makes the kernel calls ``kernel_launches(train_steps=1)``
    predicts (a remat policy runs every block's forward again: the
    attention blocks, the Mamba2 blocks and the hybrid's shared block)."""
    calls = _count_calls(monkeypatch)
    base = None
    for remat in ("none", "dots", "full"):
        _, api = _pair(arch, remat=remat, micro_batches=micro)
        opt = make_optimizer("adamw")
        state = p_train.train_state(api, opt, torch.Generator().manual_seed(4),
                                    device=CPU)
        step = p_train.make_train_step(api, opt, constant(1e-2))
        calls.update(rmsnorm=0, flash_attention=0, ssd_chunks=0)
        new, met = step(state, _batch(257, seed=5))
        want = p_lm.kernel_launches(api.cfg, train_steps=1)
        assert calls == {k: want[k] for k in calls}, remat
        got = [float(met["loss"]), float(met["grad_norm"])] + [
            t.clone() for t in tree_leaves(new["params"])]
        if base is None:
            base = got
            continue
        assert got[:2] == base[:2], remat
        assert all(torch.equal(a, b) for a, b in zip(got[2:], base[2:])), remat


def test_remat_checkpoints_only_what_autograd_records(monkeypatch):
    """A forward that records no gradient (serving) runs the blocks as
    they are; a train step checkpoints each block once."""
    from torch.utils import checkpoint as ckpt_lib

    calls = []
    real = ckpt_lib.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt_lib, "checkpoint", counted)
    _, api = _pair("llama3.2-1b", remat="dots")
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    toks = torch.as_tensor(_batch(257)["tokens"])
    api.forward(params, toks)
    cache = api.init_cache(4, 32, device=CPU)
    api.prefill(params, toks, cache)
    assert calls == []
    p_train.value_and_grad(api.loss_fn, params, {
        k: torch.as_tensor(v) for k, v in _batch(257).items()})
    assert len(calls) == api.cfg.num_layers


@pytest.mark.parametrize("layers", [2, 4])
def test_grad_norm_at_init_equals_the_reference_across_depth(layers):
    """The reference's init (fan-in = a spec's second-to-last dim: the
    head count for wq / wk / wv) makes the gradient norm at init grow
    with depth (32/8 heads of 16, d 256); the port's follows it.  The
    same growth amplifies float32 differences, so llama3.2-1b's depth is
    held against float64 in tests/test_torch_train_precision.py."""
    kw = dict(num_layers=layers, d_model=256, num_heads=32, num_kv_heads=8,
              head_dim=16, d_ff=1024, vocab_size=1024)
    r_api, p_api = _pair("llama3.2-1b", **kw)
    params = r_api.init(jax.random.PRNGKey(0))
    batch = _batch(1024, 4, 64)
    (r_loss, _), r_g = jax.value_and_grad(
        lambda p: r_api.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                    batch.items()}), has_aux=True)(params)
    r_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                for g in jax.tree_util.tree_leaves(r_g))))
    loss, _, grads = p_train.value_and_grad(
        p_api.loss_fn, train_state_from_reference(jax.device_get(params), CPU),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=RTOL)
    np.testing.assert_allclose(float(p_train._grad_norm(grads)), r_norm,
                               rtol=GRAD_RTOL)


def test_train_launch_closed_forms():
    cfg = p_registry.get("llama3.2-1b").cfg           # 16 layers, remat dots
    assert cfg.remat == "dots"
    mamba = p_registry.get("mamba2-1.3b").cfg         # 48 layers, remat dots
    assert p_lm.kernel_launches(mamba, train_steps=8) == {
        "rmsnorm": 8 * (49 + 48), "flash_attention": 0,
        "decode_attention": 0, "ssd_chunks": 8 * 2 * 48}
    zamba = dataclasses.replace(p_registry.get("zamba2-2.7b").cfg,
                                num_layers=12)        # 2 shared applications
    assert p_lm.kernel_launches(zamba, train_steps=4) == {
        "rmsnorm": 4 * (17 + 16), "flash_attention": 4 * 2 * 2,
        "decode_attention": 0, "ssd_chunks": 4 * 2 * 12}
    assert p_lm.kernel_launches(cfg, train_steps=12) == {
        "rmsnorm": 12 * (33 + 32), "flash_attention": 12 * 32,
        "decode_attention": 0, "ssd_chunks": 0}
    plain = dataclasses.replace(cfg, remat="none", micro_batches=2)
    assert p_lm.kernel_launches(plain, train_steps=3) == {
        "rmsnorm": 3 * 2 * 33, "flash_attention": 3 * 2 * 16,
        "decode_attention": 0, "ssd_chunks": 0}
    star = p_registry.get("starcoder2-3b").cfg        # LayerNorm
    assert p_lm.kernel_launches(star, train_steps=1)["rmsnorm"] == 0


# ---------------------------------------------- device-side arena transforms

def _arena_tree():
    rng = np.random.default_rng(6)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((130,)).astype(ml_dtypes.bfloat16),
            "c": {"d": rng.integers(0, 9, (4, 4)).astype(np.int32),
                  "e": rng.standard_normal((7,)).astype(np.float32)}}


def _bufs_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for b in ref:
        assert from_reference_tree(np.asarray(ref[b])).view(torch.uint8).equal(
            port[b].view(torch.uint8)), b


@pytest.mark.parametrize("align", [1, 128])
def test_pack_unpack_repack_traced_equal_the_reference(align):
    tree = _arena_tree()
    r_layout = r_get_session().plan(
        jax.tree_util.tree_map(jnp.asarray, tree),
        r_train.grad_arena_spec(1).replace(align_elems=align))
    p_tree = from_reference_tree(tree)
    p_layout = TransferSession().plan(
        p_tree, p_train.grad_arena_spec(1).replace(align_elems=align))
    assert p_layout.bucket_sizes == r_layout.bucket_sizes
    r_bufs = r_engine.pack_traced(jax.tree_util.tree_map(jnp.asarray, tree),
                                  r_layout)
    p_bufs = p_engine.pack_traced(p_tree, p_layout)
    _bufs_equal(p_bufs, r_bufs)
    back = p_engine.unpack_traced(p_bufs, p_layout)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(p_tree)))
    # a modified tree scattered back over the arena, functionally
    rng = np.random.default_rng(8)
    mod = dict(tree, a=rng.standard_normal((5, 3)).astype(np.float32))
    r_new = r_engine.repack_traced(r_bufs, r_layout, jax.tree_util.tree_map(
        jnp.asarray, mod))
    before = {b: t.clone() for b, t in p_bufs.items()}
    p_new = p_engine.repack_traced(p_bufs, p_layout, from_reference_tree(mod))
    _bufs_equal(p_new, r_new)
    assert all(torch.equal(before[b], p_bufs[b]) for b in before)
    _bufs_equal(p_arena.repack_into(p_bufs, p_layout, from_reference_tree(mod)),
                r_arena.repack_into(r_bufs, r_layout, jax.tree_util.tree_map(
                    jnp.asarray, mod)))
    entry = TransferSession().get_entry(p_tree, align)
    r_entry = r_engine.get_entry(jax.tree_util.tree_map(jnp.asarray, tree),
                                 align)
    _bufs_equal(entry.repack(p_bufs, from_reference_tree(mod)),
                r_entry.repack(r_bufs, jax.tree_util.tree_map(jnp.asarray,
                                                              mod)))


# ------------------------------------------------------------- mark_dirty

def _ledgers(program):
    return {k: (l.h2d_bytes, l.h2d_calls, l.skipped_bytes, l.delta_calls)
            for k, l in program.ledgers.items()}


@pytest.mark.parametrize("paths", [(), ("opt.mu",), ("opt",), ("opt.mu.w",),
                                   ("params.w", "opt.nu")])
def test_mark_dirty_ledgers_equal_the_reference(paths):
    """An in-place host edit the delta region cannot see by identity is
    flagged with ``mark_dirty``; the next pass re-ships exactly the
    reference's buckets."""
    rng = np.random.default_rng(9)
    host = {"params": {"w": rng.standard_normal((8, 16)).astype(np.float32)},
            "opt": {"mu": {"w": rng.standard_normal((8, 16)).astype(np.float32)},
                    "nu": {"w": rng.standard_normal((8, 16)).astype(np.float32)},
                    "count": np.int32(3)},
            "step": np.int32(3)}
    p_host = from_reference_tree(host)
    policy = "params/**=marshal+align128; opt/**=marshal+delta; **=marshal"
    r_prog = RTransferSessionFactory().compile(host, policy)
    p_prog = TransferSession().compile(p_host, policy, device=CPU)
    for _ in range(2):
        r_prog.to_device(host)
        p_prog.to_device(p_host)
    host["opt"]["mu"]["w"][0, 0] += 1.0          # in place, same objects
    p_host["opt"]["mu"]["w"][0, 0] += 1.0
    r_prog.mark_dirty(host, *paths)
    p_prog.mark_dirty(p_host, *paths)
    r_prog.reset_ledgers()
    p_prog.reset_ledgers()
    r_out = r_prog.to_device(host)
    p_out = p_prog.to_device(p_host)
    assert _ledgers(p_prog) == _ledgers(r_prog)
    np.testing.assert_array_equal(p_out["opt"]["mu"]["w"].numpy(),
                                  np.asarray(r_out["opt"]["mu"]["w"]))


def RTransferSessionFactory():
    from repro.core import TransferSession as RTransferSession
    return RTransferSession()


def test_state_prefetcher_stages_the_train_state():
    _, api = _pair("llama3.2-1b")
    opt = make_optimizer("adamw")
    state = p_train.train_state(api, opt, torch.Generator().manual_seed(0),
                                device=CPU)
    program = p_train.compile_state_program(state, session=TransferSession(),
                                            device=CPU)
    pf = p_train.StatePrefetcher(program)
    with pytest.raises(RuntimeError, match="schedule"):
        pf.take()
    pf.schedule(state)
    assert pf.scheduled
    out = pf.take()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                 tree_leaves(state)))
    assert sorted(program.ledgers) == ["**", "opt/**", "params/**"]
