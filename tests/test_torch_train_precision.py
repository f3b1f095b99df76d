"""How close the training gradients are to float64 ones, in both packages.

The port and the reference both compute the loss's gradients in float32,
but round differently (XLA fuses and contracts elementwise chains, eager
PyTorch rounds every op).  These tests hold each package's float32
gradients against the reference's at float64 params and compute, which
bounds how far the two packages may be from each other: the basis of
``GRAD_RTOL`` in ``tests/test_torch_train.py``.  They also show that the
growth of the gradient norm at init with depth (the reference's init takes
the head count as the fan-in of wq / wk / wv) is the reference's own, at
the depth of llama3.2-1b.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import train_state_from_reference
from repro_torch.core import tree_leaves
from repro_torch.runtime import train as p_train
from test_torch_train import CPU, GRAD_RTOL, _batch, _pair

# llama3.2-1b's heads at a smoke width (32/8 heads of 16, d 256)
WIDTH = dict(d_model=256, num_heads=32, num_kv_heads=8, head_dim=16,
             d_ff=1024, vocab_size=1024)
F64 = dict(param_dtype="float64", compute_dtype="float64")
# at 16 layers the norm at init is hundreds of times the 2-layer one, and the
# growth amplifies float32 rounding: each package's float32 norm is held
# within 2 % of the reference's at float64 (the float32 softmax, norms and
# loss that both keep at float64 params bound how close that one can be)
DEEP_NORM_RTOL = 2e-2


def _ref_grads(api, params, batch):
    feed = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.grad(lambda p: api.loss_fn(p, feed)[0])(params)


def _port_grads(api, params, batch):
    _, _, grads = p_train.value_and_grad(
        api.loss_fn, train_state_from_reference(jax.device_get(params), CPU),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return [g.numpy() for g in tree_leaves(grads)]


def _norm(leaves) -> float:
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in leaves)))


def test_float32_gradients_are_within_half_the_tolerance_of_float64():
    """Smoke llama3.2-1b, one batch: every leaf of each package's float32
    gradient is within GRAD_RTOL / 2 of the leaf's largest float64
    element, so the two packages are within GRAD_RTOL of each other."""
    r_api, p_api = _pair("llama3.2-1b")
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    r_api.init(jax.random.PRNGKey(1)))
    batch = _batch(257, seed=10)
    g32 = jax.tree_util.tree_leaves(_ref_grads(r_api, params, batch))
    pg = _port_grads(p_api, params, batch)
    with jax.enable_x64(True):
        r64, _ = _pair("llama3.2-1b", **F64)
        g64 = jax.tree_util.tree_leaves(_ref_grads(r64, jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params), batch))
        g64 = [np.asarray(g) for g in g64]
    assert len(pg) == len(g32) == len(g64)
    for i, (p, r, t) in enumerate(zip(pg, g32, g64)):
        top = float(np.abs(t).max())
        assert top > 0, f"leaf {i}: zero gradient"
        port = float(np.abs(p - t).max()) / top
        ref = float(np.abs(np.asarray(r) - t).max()) / top
        assert port <= GRAD_RTOL / 2, f"port leaf {i}: {port}"
        assert ref <= GRAD_RTOL / 2, f"reference leaf {i}: {ref}"


@pytest.mark.parametrize("layers", [16])
def test_grad_norm_at_init_grows_with_depth_as_in_the_reference(layers):
    """At llama3.2-1b's depth the gradient norm at init is the reference's:
    hundreds of times the 2-layer norm in both packages, and each
    package's float32 norm within DEEP_NORM_RTOL of the reference's at
    float64."""
    batch = _batch(1024, 4, 64)
    r2, _ = _pair("llama3.2-1b", num_layers=2, **WIDTH)
    shallow = _norm(jax.tree_util.tree_leaves(
        _ref_grads(r2, r2.init(jax.random.PRNGKey(0)), batch)))
    r_api, p_api = _pair("llama3.2-1b", num_layers=layers, **WIDTH)
    params = r_api.init(jax.random.PRNGKey(0))
    ref32 = _norm(jax.tree_util.tree_leaves(
        _ref_grads(r_api, params, batch)))
    port32 = _norm(_port_grads(p_api, params, batch))
    with jax.enable_x64(True):
        r64, _ = _pair("llama3.2-1b", num_layers=layers, **WIDTH, **F64)
        ref64 = _norm(jax.tree_util.tree_leaves(_ref_grads(
            r64, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        params), batch)))
    assert ref64 > 300 * shallow, (ref64, shallow)
    assert port32 > 300 * shallow, (port32, shallow)
    np.testing.assert_allclose(ref32, ref64, rtol=DEEP_NORM_RTOL)
    np.testing.assert_allclose(port32, ref64, rtol=DEEP_NORM_RTOL)
