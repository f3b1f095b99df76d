"""Expert-parallel MoE (``apply_moe_sharded``) on the port, held to the JAX
package's own run on a forced 4-device host.

The reference's ``shard_map`` path needs four devices, so it runs once per
module in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (set in the child
only).  The port runs the same computation on four CPU positions
(``make_debug_mesh(..., device="cpu")``).  Held here, on the smoke
moonshot-v1-16b-a3b (4 experts, top 2, d 64, d_ff 96) with seeded numpy
weights and x (4, 8, 64), f32:

  * meshes (4, 1) (expert parallelism over ``data``) and (2, 2) (and the
    experts' d_ff split over ``model``, one ``psum``): the output within
    2e-4, the aux loss (the ``pmean`` of the local aux losses over the ep
    axes, not the global one) within rtol 1e-5, and the gradients of
    ``sum(out)`` with respect to x and the three expert weights (and the
    router) within 2e-4 of each one's largest element, against
    ``jax.grad`` in the child;
  * the dispatch rule: under ``pspec.activate(mesh, rules)``
    ``_sharded_config`` equals the reference's over meshes (4, 1), (2, 2),
    (1, 4), rule tables with and without an ``expert`` rule, batches that
    do and do not divide and configs whose experts or d_ff do not divide;
    ``apply_moe`` calls ``apply_moe_sharded`` exactly where it is not None.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.launch.mesh import default_rules, make_debug_mesh
from repro_torch.models import moe as p_moe
from repro_torch.models import pspec
from repro_torch.models import registry as p_registry

ROOT = Path(__file__).resolve().parent.parent
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_RTOL = 2e-4          # of each gradient's largest element (f32)
MESHES = ((4, 1), (2, 2))
# the dispatch rule's cases: (experts, d_ff), mesh, batch, rule table
DISPATCH = [((e, f), mesh, b, rules)
            for e, f in ((4, 96), (2, 96), (4, 90))
            for mesh in ((4, 1), (2, 2), (1, 4))
            for b in (4, 2, 3)
            for rules in ("default", "no_expert")]

_CHILD = r'''
import dataclasses, json
import jax, jax.numpy as jnp
import numpy as np
from repro.launch.mesh import default_rules, make_debug_mesh
from repro.models import moe, pspec, registry

cfg = registry.get("moonshot-v1-16b-a3b", smoke=True).cfg
rng = np.random.default_rng(0)
p = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
     for k, s in moe.moe_specs(cfg).items()}
x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
out = {"runs": {}, "dispatch": []}
for d, m in %(meshes)r:
    mesh = make_debug_mesh(data=d, model=m)
    f = lambda p, x: moe.apply_moe_sharded(cfg, p, x, mesh, ("data",),
                                           ("model",))
    o, aux = jax.jit(f)(p, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x)[0]),
                              argnums=(0, 1)))(p, x)
    out["runs"]["%%d,%%d" %% (d, m)] = {
        "out": np.asarray(o).tolist(),
        "aux": float(aux["moe_aux_loss"]),
        "grads": {k: np.asarray(v).tolist() for k, v in gp.items()},
        "gx": np.asarray(gx).tolist()}
for (e, ff), (d, m), b, rules in %(dispatch)r:
    c = dataclasses.replace(cfg, num_experts=e, d_ff=ff)
    mesh = make_debug_mesh(data=d, model=m)
    r = default_rules(mesh)
    if rules == "no_expert":
        r["expert"] = None
    with pspec.activate(mesh, r):
        got = moe._sharded_config(c, np.zeros((b, 8, c.d_model), np.float32))
    out["dispatch"].append(None if got is None else
                           [list(got[1]), list(got[2]) if got[2] else None])
print(json.dumps(out))
'''


@functools.lru_cache(maxsize=None)
def reference_four_devices() -> dict:
    """The reference on a forced 4-device host, run once per process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    code = _CHILD % {"meshes": MESHES, "dispatch": DISPATCH}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref4():
    return reference_four_devices()


def _inputs():
    """The child's seeded weights and x, as torch tensors."""
    cfg = p_registry.get("moonshot-v1-16b-a3b", smoke=True).cfg
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy((rng.standard_normal(s.shape) * 0.1)
                             .astype(np.float32))
         for k, s in p_moe.moe_specs(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((4, 8, cfg.d_model))
                         .astype(np.float32))
    return cfg, p, x


def _grad_close(got, want, what):
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= 1e-6 + GRAD_RTOL * top, f"{what}: {err} vs max {top}"


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_moe_equals_the_reference_four_device_run(ref4, shape):
    cfg, p, x = _inputs()
    mesh = make_debug_mesh(*shape, device="cpu")
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = x.requires_grad_()
    C.STATS.reset()
    out, aux = p_moe.apply_moe_sharded(cfg, p, x, mesh, ("data",),
                                       ("model",))
    calls = C.STATS.snapshot()
    assert calls == {"all_to_all": 2, "psum": 1, "pmean": 1}
    want = ref4["runs"][f"{shape[0]},{shape[1]}"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want["out"]),
                               **OUT_TOL)
    np.testing.assert_allclose(float(aux["moe_aux_loss"].detach()),
                               want["aux"], rtol=1e-5)
    out.sum().backward()
    _grad_close(x.grad, want["gx"], f"d sum(out) / dx at {shape}")
    for k in ("w_gate", "w_up", "w_down", "router"):
        _grad_close(p[k].grad, want["grads"][k], f"d sum(out) / d{k} at "
                    f"{shape}")


def test_sharded_moe_aux_is_the_pmean_of_local_losses():
    """At (4, 1) each position routes 8 tokens: the aux loss is the mean of
    the four local Switch losses, which differs from the global one."""
    cfg, p, x = _inputs()
    mesh = make_debug_mesh(4, 1, device="cpu")
    _, aux = p_moe.apply_moe_sharded(cfg, p, x, mesh, "data", None)
    local = [p_moe.apply_moe(cfg, p, x[i:i + 1])[1]["moe_aux_loss"]
             for i in range(4)]
    torch.testing.assert_close(aux["moe_aux_loss"], sum(local) / 4)
    glob = p_moe.apply_moe(cfg, p, x)[1]["moe_aux_loss"]
    assert not torch.allclose(aux["moe_aux_loss"], glob)


@pytest.mark.parametrize("case", range(len(DISPATCH)))
def test_apply_moe_dispatches_exactly_where_the_reference_would(
        ref4, case, monkeypatch):
    (e, ff), shape, b, rules = DISPATCH[case]
    cfg = dataclasses.replace(
        p_registry.get("moonshot-v1-16b-a3b", smoke=True).cfg,
        num_experts=e, d_ff=ff)
    mesh = make_debug_mesh(*shape, device="cpu")
    r = default_rules(mesh)
    if rules == "no_expert":
        r["expert"] = None
    x = torch.zeros(b, 8, cfg.d_model)
    with pspec.activate(mesh, r):
        got = p_moe._sharded_config(cfg, x)
    want = ref4["dispatch"][case]
    assert (None if got is None else
            [list(got[1]), list(got[2]) if got[2] else None]) == want
    calls = []
    monkeypatch.setattr(p_moe, "apply_moe_sharded",
                        lambda *a: calls.append(a[3:]) or (x, {}))
    p = {k: torch.zeros(s.shape) for k, s in p_moe.moe_specs(cfg).items()}
    with pspec.activate(mesh, r):
        p_moe.apply_moe(cfg, p, x)
    assert len(calls) == (0 if want is None else 1)
    p_moe.apply_moe(cfg, p, x)               # no context: the plain path
    assert len(calls) == (0 if want is None else 1)
