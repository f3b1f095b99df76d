"""The data-parallel train step at dp > 1 on the port, held to the JAX
package's own run on a forced 4-device host.

The reference's ``shard_map`` step needs several devices, so it runs once
per module in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (set in the child
only): llama3.2-1b smoke, sgdm, ``constant(1e-2)``, ``SyntheticLM(vocab,
16, 8)``, four steps from ``PRNGKey(0)`` on meshes (4, 1) (dp 4) and (2,
2) (dp 2) under pertensor, arena and arena + int8.  The child writes each
step's input and output state (one copy: every device's is equal), each
device's error-feedback buffers and the loss to an ``.npz``, and the
emitted collectives of its step (``jax.make_jaxpr``: ``psum``,
``reduce_scatter``, ``pmax``).

The port runs on four CPU positions (``make_debug_mesh(..., device=
"cpu")``).  Each step starts from the reference's state and error buffers
of that step (``train_state_from_reference``; free-running float32
trajectories of this model part within three steps, in either package
alone: tests/test_torch_train.py), and is held, f32:

  * the loss within rtol 1e-5;
  * without compression, each param leaf's update and the momentum within
    2e-4 of the leaf's largest element (``GRAD_RTOL``: two float32
    implementations summing in different orders);
  * with int8: the delivered gradient (the momentum's increment) and each
    position's new error buffer against the reference's elementwise
    within float32 noise except where the int8 rounding went the other
    way (the gradients differ by float32 noise), there by at most one
    quantum of the chunk's shared scale (K quanta for the sum of K
    positions), at under 5 % of the elements; and the error-feedback
    invariant within float32 noise: delivered + the positions' new
    errors == the positions' gradients + their old errors;
  * arena's new state bit-equal to pertensor's from the same inputs (the
    collectives sum in position order), every position's copy of the
    params and optimizer state equal bit for bit;
  * the collectives a step emits: under pertensor ``psum`` + ``pmean``
    calls == the reference's emitted ``psum``s (one a gradient leaf and
    the loss's, 12 at smoke), under arena ``psum_scatter`` == its
    ``reduce_scatter``s (one a bucket) and as many ``all_gather``s, under
    int8 ``pmax`` == its ``pmax``s and ``psum`` + ``pmean`` == its
    ``psum``s.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import NoCudaDeviceError
from repro_torch.convert import train_state_from_reference
from repro_torch.core import collectives as C
from repro_torch.core import (get_session, pack_traced, tree_flatten,
                              tree_leaves)
from repro_torch.core.sharded import ShardedTensor, replica
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import registry as p_registry
from repro_torch.optim import compression as p_comp
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import train as p_train

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL, ATOL = 2e-4, 1e-6
STEPS = 4
MESHES = ((4, 1), (2, 2))
SCHEMES = (("pertensor", False), ("arena", False), ("arena", True))

_CHILD = r'''
import os, re, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.data import SyntheticLM
from repro.launch.mesh import make_debug_mesh
from repro.models import registry
from repro.optim import constant, make_optimizer
from repro.runtime.train import (init_error_state, make_dp_train_step,
                                 train_state)

api = registry.get("llama3.2-1b", smoke=True)
opt = make_optimizer("sgdm")
data = SyntheticLM(api.cfg.vocab_size, 16, 8)
out = {}
for d, m in %(meshes)r:
    mesh = make_debug_mesh(data=d, model=m)
    for scheme, compress in %(schemes)r:
        tag = "%%d%%d_%%s%%s" %% (d, m, scheme, "_int8" if compress else "")
        raw = make_dp_train_step(api, opt, constant(1e-2), mesh,
                                 grad_scheme=scheme, compress=compress)
        step = jax.jit(raw)
        state = train_state(api, opt, jax.random.PRNGKey(0))
        err = init_error_state(api, compress, mesh=mesh)

        def dump(prefix, state, err):
            for i, l in enumerate(jax.tree_util.tree_leaves(state)):
                out["%%s/state/%%d" %% (prefix, i)] = np.asarray(l)
            for b, v in err.items():
                for j, s in enumerate(v.addressable_shards):
                    out["%%s/err/%%s/%%d" %% (prefix, b, j)] = \
                        np.asarray(s.data)

        for s in range(%(steps)d):
            batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            dump("%%s/%%d/in" %% (tag, s), state, err)
            if s == 0:
                jaxpr = str(jax.make_jaxpr(raw)(state, batch, err))
                for prim in ("psum", "reduce_scatter", "all_gather",
                             "pmax"):
                    out["%%s/emitted/%%s" %% (tag, prim)] = np.array(
                        len(re.findall(r"\b%%s\[" %% prim, jaxpr)))
            state, metrics, err = step(state, batch, err)
            out["%%s/%%d/loss" %% (tag, s)] = np.asarray(metrics["loss"])
            dump("%%s/%%d/out" %% (tag, s), state, err)
np.savez(sys.argv[1], **out)
print("ok")
'''


@functools.lru_cache(maxsize=None)
def reference_four_devices(path: str) -> dict:
    """The reference's dp runs on a forced 4-device host, run once per
    process, as a dict of numpy arrays."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    code = _CHILD % {"meshes": MESHES, "schemes": SCHEMES, "steps": STEPS}
    proc = subprocess.run([sys.executable, "-c", code, path], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    return reference_four_devices(
        str(tmp_path_factory.mktemp("dp_reference") / "dp.npz"))


@functools.lru_cache(maxsize=None)
def _api():
    return p_registry.get("llama3.2-1b", smoke=True)


def _tag(shape, scheme, compress):
    return f"{shape[0]}{shape[1]}_{scheme}" + ("_int8" if compress else "")


def _ref_state(ref4, prefix):
    """The reference's state at ``prefix`` as the port's (one copy)."""
    template = p_train.abstract_train_state(_api(), make_optimizer("sgdm"))
    leaves_t, treedef = tree_flatten(template)
    leaves = [ref4[f"{prefix}/state/{i}"] for i in range(len(leaves_t))]
    return train_state_from_reference(treedef.unflatten(leaves), CPU)


def _ref_err(ref4, prefix, k):
    """The reference's per-device error buffers at ``prefix`` as the
    port's replicated error state (one piece a position).  Its first
    buffers are one single-device array, which ``shard_map`` hands every
    device."""
    buckets = sorted({key.split("/")[-2] for key in ref4
                      if key.startswith(f"{prefix}/err/")})
    def on(b, j):
        key = f"{prefix}/err/{b}/{j}"
        return ref4[key] if key in ref4 else ref4[f"{prefix}/err/{b}/0"]
    return {b: p_train.from_positions(
        [torch.from_numpy(np.array(on(b, j))) for j in range(k)])
        for b in buckets}


def _copies(tree, k):
    """Each position's copy of a replicated tree's leaves."""
    return [[replica(leaf, p) for leaf in tree_leaves(tree)]
            for p in range(k)]


def _step(shape, scheme, compress):
    mesh = make_debug_mesh(*shape, device=CPU)
    return mesh, p_train.make_dp_train_step(
        _api(), make_optimizer("sgdm"), constant(1e-2), mesh,
        grad_scheme=scheme, compress=compress)


def _leaf_close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max(initial=0.0))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= ATOL + GRAD_RTOL * top, f"{what}: {err} vs max {top}"


def _chunked(a):
    n = a.shape[0]
    return np.pad(a, (0, (-n) % p_comp.CHUNK)).reshape(-1, p_comp.CHUNK)


def _quantum_close(port, ref, quantum, what):
    """Elementwise within float32 noise except, at under 5 % of the
    elements, by at most ``quantum`` (per chunk) where the int8 rounding
    went the other way."""
    err = np.abs(_chunked(port) - _chunked(ref))
    top = float(np.abs(ref).max(initial=0.0))
    assert (err <= 1.01 * quantum + ATOL).all(), what
    assert (err > ATOL + GRAD_RTOL * top).mean() < 0.05, what


def _per_position_grads(state, batch, mesh):
    """Each position's own gradients (before the collective), packed by
    the gradient arena's plan: the port's ``value_and_grad`` on each
    position's slice of the batch."""
    states = p_train.per_position(state, mesh)
    batches = p_train._split_batch(batch, mesh)
    grads = [p_train.value_and_grad(_api().loss_fn, st["params"], b)[2]
             for st, b in zip(states, batches)]
    layout = get_session().plan(grads[0],
                                p_train.grad_arena_spec(mesh.shape["data"]))
    return [pack_traced(g, layout) for g in grads], layout


@pytest.mark.parametrize("scheme,compress", SCHEMES)
@pytest.mark.parametrize("shape", MESHES)
def test_dp_step_equals_the_reference_four_device_run(ref4, shape, scheme,
                                                      compress):
    mesh, step = _step(shape, scheme, compress)
    k = mesh.size
    tag = _tag(shape, scheme, compress)
    data = SyntheticLM(_api().cfg.vocab_size, 16, 8)
    for s in range(STEPS):
        p_in = _ref_state(ref4, f"{tag}/{s}/in")
        r_out = _ref_state(ref4, f"{tag}/{s}/out")
        err_in = _ref_err(ref4, f"{tag}/{s}/in", k)
        C.STATS.reset()
        p_out, met, err_out = step(p_in, data.batch(s), err_in)
        calls = C.STATS.snapshot()
        np.testing.assert_allclose(float(met["loss"]),
                                   float(ref4[f"{tag}/{s}/loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"{tag} step {s}")
        copies = _copies(p_out, k)
        for p in range(1, k):
            assert all(torch.equal(a, b) for a, b in zip(copies[0],
                                                         copies[p])), p
        assert int(replica(p_out["step"], 0)) == s + 1
        got_p = [replica(l, 0) for l in tree_leaves(p_out["params"])]
        old_p = tree_leaves(p_in["params"])
        want_p = tree_leaves(r_out["params"])
        got_mu = [replica(l, 0) for l in tree_leaves(p_out["opt"]["mu"])]
        old_mu = tree_leaves(p_in["opt"]["mu"])
        want_mu = tree_leaves(r_out["opt"]["mu"])
        if not compress:
            for i, (g, o, w) in enumerate(zip(got_p, old_p, want_p)):
                _leaf_close(g - o, w - o, f"{tag} step {s} update {i}")
            for i, (g, w) in enumerate(zip(got_mu, want_mu)):
                _leaf_close(g, w, f"{tag} step {s} momentum {i}")
        else:
            _int8_checks(ref4, tag, s, mesh, p_in, err_in, data.batch(s),
                         got_mu, old_mu, want_mu, err_out)
        n_leaves = len(old_p)
        emitted = {prim: int(ref4[f"{tag}/emitted/{prim}"])
                   for prim in ("psum", "reduce_scatter", "pmax")}
        assert calls.get("psum", 0) + calls.get("pmean", 0) == \
            emitted["psum"], (calls, emitted)
        assert calls.get("psum_scatter", 0) == emitted["reduce_scatter"]
        assert calls.get("pmax", 0) == emitted["pmax"]
        if scheme == "pertensor":
            assert calls == {"psum": n_leaves, "pmean": 1}
            assert emitted["psum"] == n_leaves + 1 == 12
        elif not compress:
            assert calls == {"psum_scatter": 1, "all_gather": 1, "pmean": 1}
        else:
            assert calls == {"pmax": 1, "psum": 1, "pmean": 1}


def _int8_checks(ref4, tag, s, mesh, p_in, err_in, batch, got_mu, old_mu,
                 want_mu, err_out):
    k = mesh.size
    groups = mesh.groups("data")
    flat = lambda leaves: torch.cat([t.reshape(-1) for t in leaves])
    got_d = flat([g - 0.9 * o for g, o in zip(got_mu, old_mu)]).numpy()
    want_d = flat([torch.from_numpy(np.asarray(w)) - 0.9 * o
                   for w, o in zip(want_mu, old_mu)]).numpy()
    grads, layout = _per_position_grads(p_in, batch, mesh)
    (bucket,) = layout.bucket_sizes
    n = grads[0][bucket].shape[0]
    corrected = [_chunked(grads[p][bucket].numpy())
                 + replica(err_in[bucket], p).numpy().reshape(
                     -1, p_comp.CHUNK) for p in range(k)]
    dp = len(groups[0])
    for g in groups:
        scale = np.max([np.abs(corrected[p]).max(axis=1) for p in g],
                       axis=0)[:, None] / 127.0
        # the leaves' flat order equals the bucket's (128-aligned slots)
        slots = layout.slots
        idx = np.concatenate([np.arange(sl.offset, sl.offset + sl.size)
                              for sl in slots])
        q_full = np.repeat(scale.reshape(-1), p_comp.CHUNK)[:n][idx]
        _quantum_close(got_d, want_d, np.pad(
            q_full * dp, (0, (-len(q_full)) % p_comp.CHUNK)).reshape(
                -1, p_comp.CHUNK), f"{tag} step {s} delivered gradient")
        for p in g:
            _quantum_close(
                replica(err_out[bucket], p).numpy(),
                np.asarray(ref4[f"{tag}/{s}/out/err/{bucket}/{p}"]),
                scale, f"{tag} step {s} error buffer of position {p}")
        # delivered + new errors == gradients + old errors, in the bucket
        delivered = np.zeros(corrected[0].size, np.float32)
        delivered[idx] = got_d
        lhs = delivered.reshape(-1, p_comp.CHUNK) + sum(
            replica(err_out[bucket], p).numpy().reshape(-1, p_comp.CHUNK)
            for p in g)
        rhs = sum(corrected[p] for p in g)
        top = float(np.abs(rhs).max())
        assert float(np.abs(lhs - rhs).max()) <= ATOL + GRAD_RTOL * top, \
            f"{tag} step {s} error-feedback invariant"


@pytest.mark.parametrize("shape", MESHES)
def test_dp_arena_is_bit_equal_to_pertensor(ref4, shape):
    """From the same state and batch, the arena's reduce-scatter +
    all-gather gives the same bits as one all-reduce a leaf."""
    data = SyntheticLM(_api().cfg.vocab_size, 16, 8)
    tag = _tag(shape, "pertensor", False)
    outs = {}
    for scheme in ("pertensor", "arena"):
        mesh, step = _step(shape, scheme, False)
        state = _ref_state(ref4, f"{tag}/0/in")
        for s in range(STEPS):
            state, _, _ = step(state, data.batch(s), {})
        outs[scheme] = _copies(state, mesh.size)
    for a, b in zip(outs["pertensor"], outs["arena"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dp_state_is_replicated_and_accepts_replicated_input():
    """A plain state in, a replicated state out (one ShardedTensor a leaf,
    a whole piece a position); fed back, the step takes it as it is; the
    error state from ``init_error_state`` on the mesh is replicated too."""
    mesh, step = _step((2, 2), "arena", True)
    api = _api()
    opt = make_optimizer("sgdm")
    state = p_train.train_state(api, opt, torch.Generator().manual_seed(0),
                                device=CPU)
    err = p_train.init_error_state(api, True, mesh, device=CPU)
    assert all(isinstance(v, ShardedTensor) and len(v.pieces) == 4
               for v in err.values())
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    one, _, err1 = step(state, data.batch(0), err)
    rep = p_train.replicate_state(state, 4, device=CPU)
    two, _, err2 = step(rep, data.batch(0), err)
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        assert isinstance(a, ShardedTensor) and len(a.pieces) == 4
        assert all(torch.equal(replica(a, p), replica(b, p))
                   for p in range(4))
    for b in err1:
        assert all(torch.equal(replica(err1[b], p), replica(err2[b], p))
                   for p in range(4))


def test_dp_entry_points_raise_without_a_card(monkeypatch):
    """No fallback: at dp > 1 the default mesh is the cards, so without
    one the step and the error state raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = _api()
    with pytest.raises(NoCudaDeviceError):
        p_train.make_dp_train_step(api, make_optimizer("sgdm"),
                                   constant(1e-2), 2)
    with pytest.raises(NoCudaDeviceError):
        p_train.init_error_state(api, True, 2)
    with pytest.raises(NoCudaDeviceError):
        make_debug_mesh(2, 1)


def test_dp_step_releases_the_state_it_is_handed():
    """Handed its only references, the step frees every position's old
    params, optimizer state and error buffers by the time it returns
    (held, the caller keeps them)."""
    import gc
    import weakref

    mesh, step = _step((4, 1), "arena", True)
    api = _api()
    state = p_train.replicate_state(p_train.train_state(
        api, make_optimizer("sgdm"), torch.Generator().manual_seed(0),
        device=CPU), 4, device=CPU)
    err = p_train.init_error_state(api, True, mesh)
    refs = [weakref.ref(p.tensor) for leaf in tree_leaves(state)
            for p in leaf.pieces]
    refs += [weakref.ref(p.tensor) for v in err.values() for p in v.pieces]
    box = {"state": state, "err": err}
    del state, err
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    box["state"], _, box["err"] = step(box.pop("state"), data.batch(0),
                                       box.pop("err"))
    gc.collect()
    assert all(r() is None for r in refs)
