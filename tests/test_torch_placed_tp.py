"""Tensor-parallel placed prefill and decode (``runtime.placed.PlacedServe``
over a model group, ``lm.serve_tp`` and ``encdec.serve_tp``) held to the
JAX package's jitted ``api.prefill`` / ``api.decode_step`` under
``tree_shardings``.

The reference runs once per module in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (set in the child
only), on ``Auto`` meshes (ROADMAP R3), for the smoke configs of
llama3.2-1b, phi-3-vision-4.2b (with patches), moonshot-v1-16b-a3b,
mamba2-1.3b, zamba2-2.7b and seamless-m4t-medium (with frames) at vocab
256 (so the vocab splits over a model axis of 2 or 4; 257 does not),
float32, on (2, 2) and (1, 4) meshes; seamless on (1, 4) at vocab 258,
which splits over 2 but not over 4, so its vocab stays whole there as
its 256206 does over the full-size mesh's 16.  For each: params from
``PRNGKey(0)``, a batch prefill of 4 rows under the prefill rules
(``rules_for(..., "prefill")``, the batch rule
adapted to the batch), then the cache put under the decode rules (its
``kv_seq`` over ``model``) and two decode steps, then two slot prefills
(the reference prefills the row at batch 1, as the server fills a slot):
one whose prompt straddles a ``kv_seq`` block boundary and one whose
prompt runs past ``S_max``, each given frames for the encoder-decoder,
which also prefills row 0 without frames (its decoder reads the row's
``enc_out``).  The child writes its inputs, its params and every
output.

The port takes the reference's params (``convert.params_from_reference``)
and inputs on CPU positions and is held:

  * the logits and every cache leaf within ``MODEL_TOL`` (rtol = atol =
    2e-4, ``tests/test_torch_models.py``), the encoder-decoder's with
    the rtol of each leaf's largest element added to the atol
    (:func:`_close`);
  * every block of every placed value (the logits, the cache) equal to
    its block of the gathered value, so positions that share a block
    (replicas over ``model``: ``pos``, a cache leaf the rules do not
    split) hold it bit for bit;
  * the plan splits what the serve rules put on ``model``.

And on their own: ``traced=True`` computes member 0 alone (one position's
ops: the whole run's over the mesh's size); the encoder-decoder's serve
plan splits what the rules put on ``model``; the gathered param bytes are
the plan's.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_reference
from repro_torch.core.placement import PlacedTensor
from repro_torch.core.treepath import tree_flatten, tree_leaves
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import registry as p_registry
from repro_torch.models import tp as TP
from repro_torch.runtime.placed import PlacedServe

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
VOCAB = 256
B, S, MAX_SEQ, DECODE = 4, 8, 32, 2
# (row, prompt length): at pos S + DECODE = 10, 10 tokens straddle the
# kv_seq block boundary at 16 (blocks of 16 on (2, 2), of 8 on (1, 4)),
# and 30 run past S_max = 32
SLOTS = ((1, 10), (2, 30))
# the encoder-decoder's slot prefills: SLOTS with frames, then row 0's
# without (True: given frames)
ENC_SLOTS = tuple((r, n, True) for r, n in SLOTS) + ((0, 6, False),)
CASES = (("llama3.2-1b", (2, 2)), ("llama3.2-1b", (1, 4)),
         ("phi-3-vision-4.2b", (2, 2)), ("phi-3-vision-4.2b", (1, 4)),
         ("moonshot-v1-16b-a3b", (2, 2)), ("moonshot-v1-16b-a3b", (1, 4)),
         ("mamba2-1.3b", (2, 2)), ("mamba2-1.3b", (1, 4)),
         ("zamba2-2.7b", (2, 2)), ("zamba2-2.7b", (1, 4)),
         ("seamless-m4t-medium", (2, 2)), ("seamless-m4t-medium", (1, 4)))
# a case's vocab where it is not VOCAB
VOCABS = {("seamless-m4t-medium", (1, 4)): 258}
# the cache leaves whose batch dim is 0 (the others': 1)
ROW_FIRST = ("pos", "enc_out")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several processes on one host, and more threads than cores spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)


_CHILD = r'''
import dataclasses, sys, time
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs.base import InputShape
from repro.launch.mesh import adapt_batch_rule, rules_for, tree_shardings
from repro.models import pspec, registry

CASES, B, S, MAX_SEQ, DECODE, SLOTS, ENC_SLOTS, ROW_FIRST = ARGS
out = {}
t0 = time.perf_counter()


def jitted(api, mesh, mode, batch, fn, axes, args):
    """``fn`` jitted with ``in_shardings`` from ``tree_shardings`` of
    ``axes`` under the ``mode`` rules (the batch rule adapted to
    ``batch``), called on ``args`` put there."""
    rules = adapt_batch_rule(rules_for(api.cfg, mesh, mode), mesh, batch)
    with pspec.activate(mesh, rules):
        shs = tuple(tree_shardings(mesh, ax, rules, a)
                    for ax, a in zip(axes, args))
        f = jax.jit(fn, in_shardings=shs)
        return f(*[jax.device_put(a, s) for a, s in zip(args, shs)])


def save(key, tree):
    for k, v in tree.items():
        out["%s/%s" % (key, k)] = np.asarray(v)


for arch, shape, VOCAB in CASES:
    api = registry.get_model(dataclasses.replace(
        registry.get(arch, smoke=True).cfg, vocab_size=VOCAB))
    cfg = api.cfg
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    tag = "%s|%dx%d" % (arch, shape[0], shape[1])
    params = api.init(jax.random.PRNGKey(0))
    for i, l in enumerate(jax.tree_util.tree_leaves(params)):
        out["%s/param/%d" % (tag, i)] = np.asarray(l)
    rng = np.random.default_rng(0)
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    M = MAX_SEQ + P
    tok = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    out[tag + "/tokens"] = tok
    p_axes, c_axes = api.axes(), api.cache_axes(
        InputShape("c", seq_len=M, global_batch=B, mode="decode"))
    cache = api.init_cache(B, M)
    # the vlm's patches or the encoder-decoder's frames: (rows, n, d_model)
    name, n_in = (("patches", P) if P else ("frames", M // cfg.src_ratio)
                  if cfg.is_encdec else (None, 0))

    def with_input(rows):
        x = rng.standard_normal((rows, n_in, cfg.d_model)).astype(np.float32)
        return lambda p, t, c, x_: api.prefill(p, t, c, **{name: x_}), x

    if name:
        fn, x = with_input(B)
        out["%s/%s" % (tag, name)] = x
        logits, cache = jitted(
            api, mesh, "prefill", B, fn,
            (p_axes, ("batch", None), c_axes, ("batch", None, None)),
            (params, tok, cache, x))
    else:
        logits, cache = jitted(api, mesh, "prefill", B, api.prefill,
                               (p_axes, ("batch", None), c_axes),
                               (params, tok, cache))
    out[tag + "/prefill/logits"] = np.asarray(logits)
    save(tag + "/prefill/cache", cache)
    for s in range(DECODE):
        nxt = rng.integers(0, VOCAB, (B, 1)).astype(np.int32)
        out["%s/decode%d/tokens" % (tag, s)] = nxt
        logits, cache = jitted(api, mesh, "decode", B, api.decode_step,
                               (p_axes, ("batch", None), c_axes),
                               (params, nxt, cache))
        out["%s/decode%d/logits" % (tag, s)] = np.asarray(logits)
        save("%s/decode%d/cache" % (tag, s), cache)
    host = {k: np.asarray(v) for k, v in cache.items()}
    slots = ENC_SLOTS if cfg.is_encdec else [(r, n, False) for r, n in SLOTS]
    for r, n, framed in slots:
        t = rng.integers(0, VOCAB, (1, n)).astype(np.int32)
        out["%s/slot%d/tokens" % (tag, r)] = t
        row = {k: v[r:r + 1] if k in ROW_FIRST else v[:, r:r + 1]
               for k, v in host.items()}
        axes1 = api.cache_axes(InputShape("c", seq_len=M, global_batch=1,
                                          mode="decode"))
        if framed:
            fn, x = with_input(1)
            out["%s/slot%d/frames" % (tag, r)] = x
            logits, c1 = jitted(
                api, mesh, "decode", 1, fn,
                (p_axes, ("batch", None), axes1, ("batch", None, None)),
                (params, t, row, x))
        else:
            logits, c1 = jitted(api, mesh, "decode", 1, api.prefill,
                                (p_axes, ("batch", None), axes1),
                                (params, t, row))
        out["%s/slot%d/logits" % (tag, r)] = np.asarray(logits)
        save("%s/slot%d/cache" % (tag, r), c1)
np.savez(sys.argv[1], **out)
print("ok %.2f s" % (time.perf_counter() - t0))
'''


@functools.lru_cache(maxsize=None)
def reference(path: str) -> dict:
    """The reference's inputs, params and outputs for every case, from a
    child process with four forced host devices, run once a process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    args = (tuple((a, tuple(s), _vocab(a, s)) for a, s in CASES), B, S,
            MAX_SEQ, DECODE, SLOTS, ENC_SLOTS, ROW_FIRST)
    code = _CHILD.replace("ARGS", repr(args))
    proc = subprocess.run([sys.executable, "-c", code, path], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(str(tmp_path_factory.mktemp("placed_tp") / "ref.npz"))


def _vocab(arch, shape=None):
    return VOCABS.get((arch, tuple(shape or ())), VOCAB)


def _api(arch, shape=None):
    return p_registry.get_model(dataclasses.replace(
        p_registry.get(arch, smoke=True).cfg, vocab_size=_vocab(arch, shape)))


def _serve(api, mesh, mode, batch=B):
    return PlacedServe(api, mesh, p_mesh.adapt_batch_rule(
        p_mesh.rules_for(api.cfg, mesh, mode), mesh, batch))


def _check_blocks(value):
    """Every block of a placed value equals its block of the gathered
    value: positions that share a block hold it bit for bit."""
    whole = value.gather()
    for p, block in enumerate(value.blocks):
        idx = value.placement.index(p, value.shape)
        assert torch.equal(block, whole[idx]), (value, p)


def _close(got, want, what, of_largest=False):
    """``got`` within MODEL_TOL of ``want``; ``of_largest`` (the
    encoder-decoder) adds MODEL_TOL's rtol of ``want``'s largest element
    to the atol: its smoke model is ill-conditioned in float32, and the
    port's one-position prefill lies as far from the reference as the
    placed one (up to 1.3e-3 of 22 in the second layer's v on (1, 4),
    the placed within 7.4e-5 of the one-position)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = dict(MODEL_TOL)
    if of_largest:
        tol["atol"] += tol["rtol"] * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, **tol, err_msg=what)


def _hold(placed, key, ref, of_largest=False):
    """Every leaf of the placed cache within MODEL_TOL of the reference's
    (``pos`` exactly; :func:`_close`), every block its block of the
    whole."""
    for k, v in placed.items():
        _check_blocks(v)
        got = v.gather()
        if k == "pos":
            np.testing.assert_array_equal(got.numpy(), ref[f"{key}/{k}"])
        else:
            _close(got.numpy(), ref[f"{key}/{k}"], f"{key}/{k}", of_largest)


@pytest.mark.parametrize("arch,shape", CASES)
def test_placed_tp_matches_the_reference(ref, arch, shape):
    api = _api(arch, shape)
    cfg = api.cfg
    enc = cfg.is_encdec
    tag = f"{arch}|{shape[0]}x{shape[1]}"
    leaves, treedef = tree_flatten(api.abstract())
    params = params_from_reference(treedef.unflatten(
        [ref[f"{tag}/param/{i}"] for i in range(len(leaves))]), CPU)
    mesh = p_mesh.make_debug_mesh(*shape, device=CPU)
    pre, dec = _serve(api, mesh, "prefill"), _serve(api, mesh, "decode")
    plan = pre.plan
    # the serve rules' regions split as the train step's: every family's
    # vocab (256; 258 not over 4), the heads of every attention, the
    # dense d_ff, each expert's d_ff, each Mamba2 mixer's heads
    attn = cfg.family != "ssm"
    assert (plan.heads, plan.vocab, plan.experts, plan.ssm) == (
        attn, cfg.vocab_size % shape[1] == 0, cfg.family == "moe",
        cfg.family in ("ssm", "hybrid"))
    assert plan.mlp == (attn and cfg.family != "moe")
    assert dec.plan == plan
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    M = MAX_SEQ + P
    name = "patches" if P else "frames" if cfg.is_encdec else None
    extra = {name: torch.from_numpy(ref[f"{tag}/{name}"])} if name else {}
    cache = pre.place_cache(api.init_cache(B, M, device=CPU))
    logits, cache = pre.prefill(params, torch.from_numpy(ref[f"{tag}/tokens"]),
                                cache, **extra)
    assert logits.placement.spec == (("data", None, "model") if plan.vocab
                                     else ("data",))
    _check_blocks(logits)
    _close(logits.gather().numpy(), ref[f"{tag}/prefill/logits"], "prefill",
           enc)
    _hold(cache, f"{tag}/prefill/cache", ref, enc)
    cache = dec.place_cache({k: v.gather() for k, v in cache.items()})
    if "k" in cache:
        assert cache["k"].placement.spec[2] == "model"
    for s in range(DECODE):
        logits, cache = dec.decode_step(
            params, torch.from_numpy(ref[f"{tag}/decode{s}/tokens"]), cache)
        _check_blocks(logits)
        _close(logits.gather().numpy(), ref[f"{tag}/decode{s}/logits"],
               f"decode {s}", enc)
        _hold(cache, f"{tag}/decode{s}/cache", ref, enc)
    slots = ENC_SLOTS if enc else [(r, n, False) for r, n in SLOTS]
    for r, n, framed in slots:
        before = {k: v.gather() for k, v in cache.items()}
        extra = {"frames": torch.from_numpy(ref[f"{tag}/slot{r}/frames"])} \
            if framed else {}
        logits, cache = dec.prefill(
            params, torch.from_numpy(ref[f"{tag}/slot{r}/tokens"]), cache,
            slot=r, **extra)
        _close(logits.numpy(), ref[f"{tag}/slot{r}/logits"], f"slot {r}",
               enc)
        for k, v in cache.items():
            _check_blocks(v)
            got = v.gather()
            d = 0 if k in ROW_FIRST else 1
            row, rest, old = got.narrow(d, r, 1), got.tensor_split(
                [r, r + 1], d), before[k].tensor_split([r, r + 1], d)
            if k == "pos":
                np.testing.assert_array_equal(
                    row.numpy(), ref[f"{tag}/slot{r}/cache/{k}"])
            else:
                _close(row.numpy(), ref[f"{tag}/slot{r}/cache/{k}"],
                       f"slot {r} {k}", enc)
            # the other rows are untouched
            assert torch.equal(rest[0], old[0])
            assert torch.equal(rest[2], old[2])


def test_traced_computes_member_zero_alone():
    """``traced=True`` runs position 0's model group with member 0 alone
    computed (``Plan.stand_in``): its ops are one position's share of a
    whole call's, whose positions all do the same work."""
    api = _api("zamba2-2.7b")
    mesh = p_mesh.make_debug_mesh(2, 2, device=CPU)
    serve = _serve(api, mesh, "decode")
    params = serve.place_params(api.init(torch.Generator().manual_seed(0),
                                         device=CPU))
    tok = torch.randint(0, VOCAB, (B, 1), generator=torch.Generator()
                        .manual_seed(1))

    def flops(traced):
        counter, entered = hlo_analysis.OpCounter(), []

        def count():
            entered.append(1)
            return counter
        cache = serve.place_cache(api.init_cache(B, MAX_SEQ, device=CPU))
        before = hlo_analysis.stats_snapshot()
        logits, new = serve.decode_step(params, tok, cache, traced=traced,
                                        count=count)
        coll = hlo_analysis.collective_stats(before)["per_op"]
        return counter, len(entered), logits, new, coll

    one, n_one, logits, new, coll_one = flops(True)
    whole, n_whole, _, placed, coll = flops(False)
    # traced: position 0's logits and its new blocks of the cache, tensors
    assert isinstance(logits, torch.Tensor) and set(new) == set(placed)
    assert all(t.shape == placed[k].blocks[0].shape for k, t in new.items())
    assert logits.shape == (B // 2, 1, VOCAB // 2)
    assert (n_one, n_whole) == (1, 2)
    assert one.total_flops > 0
    assert one.total_flops * mesh.size == whole.total_flops
    assert one.calls["aten.mm"] * mesh.size == whole.calls["aten.mm"]
    # one group's collectives (two members' sums) and the other's too
    assert 2 * coll_one["all-reduce"]["count"] == coll["all-reduce"]["count"]


@pytest.mark.parametrize("mode", ("prefill", "decode"))
def test_the_encdec_serve_plan_splits_heads_mlp_and_a_dividing_vocab(mode):
    """seamless-m4t-medium's placed prefill and decode split over
    ``model`` as its train step: the heads and d_ff of both stacks, and
    the vocab where it divides the axis (the smoke model's 256 over 2,
    not 258 over 4; at full size 256206 over 2, not over 4 or 16).  At
    full size a position gathers 690,575,360 B of params on (2, 2),
    814,469,120 B on (1, 4) and 710,623,232 B on the production mesh
    (16, 16), of the whole 1,229,852,672 B."""
    for shape, want in (((2, 2), (True, True, True)),
                        ((1, 4), (True, True, False))):
        api = _api("seamless-m4t-medium", shape)
        mesh = p_mesh.make_debug_mesh(*shape, device=CPU)
        plan = _serve(api, mesh, mode).plan
        assert (plan.heads, plan.mlp, plan.vocab, plan.experts,
                plan.ssm) == want + (False, False)
    api = p_registry.get("seamless-m4t-medium")
    assert TP.gathered_param_bytes(api.abstract(), None, None) \
        == 1_229_852_672
    meshes = ((p_mesh.make_debug_mesh(2, 2, device="meta"), 690_575_360,
               True),
              (p_mesh.make_debug_mesh(1, 4, device="meta"), 814_469_120,
               False),
              (p_mesh.make_production_mesh(device="meta"), 710_623_232,
               False))
    for mesh, want, vocab in meshes:
        serve = _serve(api, mesh, mode, batch=mesh.shape["data"])
        plan = serve.plan
        assert (plan.heads, plan.mlp, plan.vocab) == (True, True, vocab)
        assert serve.gathered_param_bytes() == want


@pytest.mark.parametrize("arch", ("llama3.2-1b", "zamba2-2.7b",
                                  "seamless-m4t-medium"))
def test_gathered_param_bytes_are_the_plans_blocks(arch):
    """A position gathers its model block of each split leaf (whole over
    the data axes) and the other leaves whole, as the train step."""
    api = _api(arch)
    mesh = p_mesh.make_debug_mesh(2, 2, device=CPU)
    serve = _serve(api, mesh, "decode")
    want = 0
    for v, pl in zip(tree_leaves(api.abstract()),
                     tree_leaves(serve.param_shardings)):
        n = v.numel() if hasattr(v, "numel") else int(np.prod(v.shape))
        if "model" in pl.spec:
            n //= mesh.shape["model"]
        want += n * torch.empty((), dtype=v.dtype).element_size()
    assert serve.gathered_param_bytes() == want
    assert want < sum(int(np.prod(v.shape)) * 4
                      for v in tree_leaves(api.abstract()))
    placed = serve.place_params(api.init(torch.Generator().manual_seed(0),
                                         device=CPU))
    leaves = tree_leaves(placed)
    got = TP.gather_params(leaves, serve.plan)
    assert sum(g[0].numel() * g[0].element_size() for g in got) == want
    assert all(isinstance(x, PlacedTensor) for x in leaves)
