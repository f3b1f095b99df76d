"""The port's MoE layer and MoE models, held against the JAX package on the
CPU.

  * ``capacity`` equals the reference's, 8 slots at a decode step of 8
    tokens and 112 at a 938-token prefill of moonshot-v1-16b-a3b;
  * ``apply_moe`` at the smoke moonshot's and arctic's widths (f32) gives
    the reference's output and Switch aux loss within 2e-4, also on a
    router biased to one expert, so tokens overflow its capacity and the
    drop rule (a stable sort's rank ``>= C`` is dropped) is held;
  * arctic's dense residual: a block's output is the experts' plus the dense
    MLP's, as the reference's;
  * no host read: ``apply_moe`` and a whole MoE decode step run on meta
    tensors, which have no values to read;
  * the smoke MoE models and starcoder2 (LayerNorm, GeLU, qkv biases)
    served by the port's ``Server`` give the reference server's tokens,
    stats and install ledgers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.models import lm as r_lm
from repro.models import moe as r_moe
from repro.models import registry as r_registry
from repro.runtime import Request as RRequest
from repro.runtime import Server as RServer

from repro_torch.convert import params_from_reference
from repro_torch.core import tree_map
from repro_torch.models import layers as p_layers
from repro_torch.models import lm as p_lm
from repro_torch.models import moe as p_moe
from repro_torch.models import registry as p_registry
from repro_torch.runtime import Request, Server

CPU = "cpu"
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
MOE_ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")


def _cfgs(arch, smoke=True):
    return (r_registry.get(arch, smoke=smoke).cfg,
            p_registry.get(arch, smoke=smoke).cfg)


def _layer_params(arch, seed=0):
    """Layer 0's MoE params of the reference's smoke init, and the same
    values as the port's tree."""
    api = r_registry.get(arch, smoke=True)
    params = jax.device_get(api.init(jax.random.PRNGKey(seed)))
    block = jax.tree_util.tree_map(lambda t: t[0], params["blocks"])
    return block, params_from_reference(block, CPU)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("tokens", [1, 8, 26, 64, 100, 938, 4096])
def test_capacity_equals_the_reference(arch, smoke, tokens):
    r_cfg, p_cfg = _cfgs(arch, smoke)
    assert p_moe.capacity(p_cfg, tokens) == r_moe.capacity(r_cfg, tokens)


def test_moonshot_capacity_at_the_serve_shapes():
    cfg = p_registry.get("moonshot-v1-16b-a3b").cfg
    assert (cfg.num_experts, cfg.experts_per_token, cfg.d_ff) == (64, 6, 1408)
    assert p_moe.capacity(cfg, 8) == 8           # a decode step: no drops
    assert p_moe.capacity(cfg, 938) == 112


def _run_both(arch, x, bias_expert=None):
    r_block, p_block = _layer_params(arch)
    r_p, p_p = r_block["moe"], p_block["moe"]
    if bias_expert is not None:
        # every token's logit for one expert far above the others'
        router = np.array(r_p["router"])
        router[:, bias_expert] = 0.5
        r_p = dict(r_p, router=router)
        p_p = dict(p_p, router=torch.from_numpy(router.copy()))
    r_cfg, p_cfg = _cfgs(arch)
    want, want_aux = r_moe.apply_moe(
        r_cfg, jax.tree_util.tree_map(jnp.asarray, r_p), jnp.asarray(x))
    got, got_aux = p_moe.apply_moe(p_cfg, p_p, torch.from_numpy(x))
    return (got, got_aux["moe_aux_loss"]), (np.asarray(want),
                                            float(want_aux["moe_aux_loss"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("B,S", [(1, 1), (8, 1), (2, 13), (1, 40)])
def test_apply_moe_equals_the_reference(arch, B, S):
    cfg = p_registry.get(arch, smoke=True).cfg
    x = np.random.default_rng(B * 100 + S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    (got, aux), (want, want_aux) = _run_both(arch, x)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(float(aux), want_aux, **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_drops_what_overflows_capacity_as_the_reference(arch):
    """A router biased to expert 1: all 26 tokens choose it first, its
    capacity is 16 (smoke: 4 experts, top 2), so 10 are dropped there, the
    latest in token order, and their output is their second choice's
    share alone."""
    cfg = p_registry.get(arch, smoke=True).cfg
    B, S = 2, 13
    C = p_moe.capacity(cfg, B * S)
    assert C < B * S
    x = (np.random.default_rng(3).standard_normal((B, S, cfg.d_model))
         + 1.0).astype(np.float32)
    (got, aux), (want, want_aux) = _run_both(arch, x, bias_expert=1)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(float(aux), want_aux, **MODEL_TOL)
    # the bias holds: every token's first choice is expert 1
    _, p_block = _layer_params(arch)
    router = p_block["moe"]["router"].clone()
    router[:, 1] = 0.5
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model)
                          @ router, -1)
    assert bool((probs.argmax(-1) == 1).all())
    # every first choice on expert 1: the aux loss is E · mean(probs)_1
    assert float(aux) == pytest.approx(cfg.num_experts
                                       * float(probs.mean(0)[1]), rel=1e-5)


def test_arctic_block_adds_the_dense_residual_as_the_reference():
    """One arctic block (smoke, f32): the port's equals the reference's,
    and removing the dense MLP from it changes the output by exactly that
    MLP's output."""
    arch = "arctic-480b"
    r_block, p_block = _layer_params(arch)
    r_cfg, p_cfg = _cfgs(arch)
    assert p_cfg.moe_dense_residual and "mlp" in p_block and "moe" in p_block
    x = np.random.default_rng(5).standard_normal(
        (2, 6, p_cfg.d_model)).astype(np.float32)
    pos = np.arange(6)[None, :]
    want, _, want_aux = r_lm._attn_block(
        r_cfg, jax.tree_util.tree_map(jnp.asarray, r_block), jnp.asarray(x),
        positions=jnp.asarray(pos), cache=None, kv_valid_len=None,
        aux=jnp.zeros((), jnp.float32))
    xt = torch.from_numpy(x)
    got, aux = p_lm._attn_block(p_cfg, p_block, xt,
                                positions=torch.from_numpy(pos), cache=None,
                                kv_valid_len=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)
    no_res, _ = p_lm._attn_block(
        dataclasses.replace(p_cfg, moe_dense_residual=False), p_block, xt,
        positions=torch.from_numpy(pos), cache=None, kv_valid_len=None)
    h = p_layers.apply_norm(p_cfg, p_block["ln2"], xt + p_layers.
                            multihead_attention(
                                p_cfg, p_block["attn"],
                                p_layers.apply_norm(p_cfg, p_block["ln1"],
                                                    xt),
                                positions=torch.from_numpy(pos))[0])
    torch.testing.assert_close(got - no_res,
                               p_layers.apply_mlp(p_cfg, p_block["mlp"], h),
                               rtol=1e-5, atol=1e-5)


def test_sharded_moe_is_not_ported():
    """The expert-parallel path is ported (this test pinned its refusal):
    on a (2, 1) CPU mesh without expert TP, each position routes its own
    batch slice with the local capacity and the all-to-alls only move its
    slots, so its output slice equals the plain layer on that slice; the
    aux loss is the mean of the two slices'.  The reference is held in
    tests/test_torch_moe_sharded.py."""
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = p_registry.get("moonshot-v1-16b-a3b", smoke=True).cfg
    p = _layer_params("moonshot-v1-16b-a3b")[1]["moe"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32))
    mesh = make_debug_mesh(2, 1, device=CPU)
    out, aux = p_moe.apply_moe_sharded(cfg, p, x, mesh, "data", None)
    halves = [p_moe.apply_moe(cfg, p, x[i:i + 2]) for i in (0, 2)]
    torch.testing.assert_close(out, torch.cat([h[0] for h in halves]),
                               **MODEL_TOL)
    torch.testing.assert_close(
        aux["moe_aux_loss"],
        (halves[0][1]["moe_aux_loss"] + halves[1][1]["moe_aux_loss"]) / 2)


# ------------------------------------------------------------ no host read

def test_apply_moe_reads_nothing_on_the_host():
    """Meta tensors have no values: a host read (bincount's maximum, a
    boolean mask's count, ``.item()``) would raise."""
    cfg = p_registry.get("moonshot-v1-16b-a3b").cfg
    p = {k: torch.empty(s.shape, device="meta")
         for k, s in p_moe.moe_specs(cfg).items()}
    x = torch.empty(8, 1, cfg.d_model, device="meta", dtype=torch.bfloat16)
    out, aux = p_moe.apply_moe(cfg, p, x)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert aux["moe_aux_loss"].shape == ()


@pytest.mark.parametrize("S", [1, 5])
def test_a_moe_step_makes_no_host_synchronize(S, monkeypatch):
    """A whole smoke moonshot decode step (S = 1) and multi-token prefill
    (S = 5) at a nonzero position on meta tensors: the kernels' wrappers
    are replaced by shape-only stand-ins (they raise on meta), everything
    else, the router and dispatch included, runs as it does on the card."""
    api = p_registry.get("moonshot-v1-16b-a3b", smoke=True)
    monkeypatch.setattr(p_layers, "rmsnorm", lambda x, w, eps: x)
    monkeypatch.setattr(p_layers, "mha", lambda q, k, v, **kw:
                        torch.empty(q.shape, device="meta"))
    monkeypatch.setattr(p_layers, "decode_mha", lambda q, k, v, valid:
                        torch.empty(q.shape, device="meta"))
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    params = tree_map(lambda t: t.to("meta"), params)
    cache = {k: v.to("meta") for k, v in api.init_cache(2, 16,
                                                        device=CPU).items()}
    toks = torch.zeros(2, S, dtype=torch.int32, device="meta")
    step = api.decode_step if S == 1 else api.prefill
    logits, new = step(params, toks, cache)
    assert logits.shape == (2, 1, api.cfg.vocab_size)
    assert new["pos"].device.type == "meta"


# ------------------------------------------------------------------ serving

SERVE_ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b", "starcoder2-3b")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_server_serves_like_the_reference(arch):
    """The port's Server, unchanged, on the smoke MoE models and
    starcoder2: the reference server's tokens, terminal states, stats and
    install ledgers on the same requests."""
    api = r_registry.get(arch, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    port = p_registry.get(arch, smoke=True)
    pp = params_from_reference(jax.device_get(params), CPU)
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
