"""The port's dry run (``python -m repro_torch.launch.dryrun``) over every
arch x shape x mesh at ``--smoke`` on meta positions, and its op counter.

One child process with ``XLA_FLAGS=--xla_force_host_platform_device_count=
512`` (set in the child only) gives the oracle values: for every cell, the
reference's skip reason, and the bytes one device holds of the cell's
arguments, the sum over the argument leaves of their ``NamedSharding``'s
``shard_shape`` bytes under the reference's ``tree_shardings`` (the train
state and batch; the params, cache and inputs of a prefill or decode).
The reference's own dry run fails on this JAX version (ROADMAP R3), so its
output is not an oracle.

The port's grid runs once per module in this process (about 50 s).  Per
cell, exactly:

  * ok, or skipped with the reference's reason;
  * ``memory.argument_size_in_bytes`` equal to the reference child's sum;
  * the probe identity in FLOPs: the step's count equals the sum over the
    layer bodies of trips times the body's count plus the count of the
    same step with the layers removed;
  * a train cell's FLOPs, times the position's share of the batch, inside
    ``test_launch.py::test_model_flops_sane``'s band, 0.5x to 3x
    ``benchmarks.roofline.model_flops``;
  * the collectives: one all-gather a sharded dim of each param leaf, and
    on a train cell whose batch splits, one all-reduce a gradient leaf and
    the loss's, plus, where the step is tensor-parallel (every family,
    the encoder-decoder since it splits too), its model group's sums;
  * the memory keys: the peak holds the arguments and the outputs that
    are not aliases, a serve cell's aliases are its k / v blocks (and a
    decode's encoder memory), a train cell's outputs its blocks of the
    new state and the metrics; the op counts are the same with the
    memory counter as without it.

And the op counter on its own: a matmul's FLOPs are 2MNK and its bytes
its operands' and output's; the collectives' kinds map onto the
reference's names; the kernel wrappers take their plain path on meta
tensors (and launch nothing), and ``"meta"`` resolves only when passed.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks.roofline import model_flops
from repro.configs.shapes import SHAPES as R_SHAPES
from repro.models import registry as r_registry

from repro_torch import resolve_device
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import collectives as C
from repro_torch.core.placement import entry_axes
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import registry as p_registry
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import train as p_train
from repro_torch.runtime.placed import PlacedServe

ROOT = Path(__file__).resolve().parent.parent
ARCHS = p_registry.ARCH_IDS
MESHES = ("single", "multi")
CELLS = [(a, s, m) for m in MESHES for a in ARCHS for s in SHAPES]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several processes on one host, and more threads than cores spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)

_CHILD = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from repro.configs.shapes import SHAPES, skip_reason
from repro.launch.mesh import (adapt_batch_rule, make_production_mesh,
                               rules_for, tree_shardings)
from repro.models import registry
from repro.optim import make_optimizer
from repro.runtime.train import abstract_train_state, train_state_axes

def nbytes(axes, abs_tree, mesh, rules):
    shs = tree_shardings(mesh, axes, rules, abs_tree)
    return sum(int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
               for sh, a in zip(jax.tree_util.tree_leaves(shs),
                                jax.tree_util.tree_leaves(abs_tree)))

out = {}
for mname in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mname == "multi")
    for arch in registry.ARCH_IDS:
        api = registry.get(arch, smoke=True)
        cfg = api.cfg
        for sname, full in SHAPES.items():
            key = "%s|%s|%s" % (arch, sname, mname)
            reason = skip_reason(cfg, sname)
            if reason:
                out[key] = {"skipped": reason}
                continue
            shape = full.smoke()
            rules = adapt_batch_rule(rules_for(cfg, mesh, shape.mode), mesh,
                                     shape.global_batch)
            total = nbytes(api.input_axes(shape), api.input_specs(shape),
                           mesh, rules)
            if shape.mode == "train":
                opt = make_optimizer(cfg.optimizer)
                total += nbytes(train_state_axes(api, opt),
                                abstract_train_state(api, opt), mesh, rules)
            else:
                total += nbytes(api.axes(), api.abstract(), mesh, rules)
                total += nbytes(api.cache_axes(shape),
                                api.abstract_cache(shape), mesh, rules)
            out[key] = {"argument_bytes": total}
json.dump(out, open(sys.argv[1], "w"))
print("ok")
'''


@functools.lru_cache(maxsize=None)
def reference_arguments(path: str) -> dict:
    """The reference's skip reasons and per-device argument bytes on a
    forced 512-device host, run once per process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD, path], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arguments(
        str(tmp_path_factory.mktemp("dryrun_reference") / "ref.json"))


@functools.lru_cache(maxsize=None)
def _grid():
    results = dryrun.run_grid(list(ARCHS), list(SHAPES), list(MESHES), None,
                              smoke=True)
    return {f"{r['arch']}|{r['shape']}|{r['mesh_name']}": r
            for r in results}


def test_the_entry_point_prints_the_references_lines(capsys):
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--mesh", "both", "--smoke"])
    out = capsys.readouterr().out
    assert "[dryrun] llama3.2-1b|decode_32k|single: ok" in out
    assert "[dryrun] llama3.2-1b|decode_32k|multi: ok" in out
    assert "[dryrun] 2/2 cells ok" in out


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_every_cell_against_the_reference(ref, arch, shape, mesh):
    key = f"{arch}|{shape}|{mesh}"
    res, want = _grid()[key], ref[key]
    assert "error" not in res, res.get("traceback")
    if "skipped" in want:
        assert res["skipped"] == want["skipped"]
        return
    assert res["memory"]["argument_size_in_bytes"] == want["argument_bytes"]
    check = res["probe_check"]
    assert check["exact"], check
    assert check["step_flops"] == check["layer_free_flops"] + \
        sum(b["trips"] * b["flops"] for b in res["bodies"])
    api = p_registry.get(arch, smoke=True)
    cfg = api.cfg
    full = SHAPES[shape]
    m = p_mesh.make_production_mesh(multi_pod=mesh == "multi",
                                    device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(cfg, m, full.mode), m,
                                    full.smoke().global_batch)
    blocks = m.axis_size(entry_axes(rules["batch"]))
    coll = res["collectives"]["per_op"]
    params = p_mesh.tree_shardings(m, api.axes(), rules, api.abstract())
    gathers = sum(1 for pl in _leaves(params) for e in pl.spec
                  if entry_axes(e))
    if full.mode == "train":
        opt = make_optimizer(cfg.optimizer)
        step = p_train.make_sharded_train_step(api, opt, None, m, rules)
        plan = step.tp
        split = 0 if plan is None else \
            sum(d is not None for d in plan.dims)
        # a split leaf is gathered over the data axes only
        gathers -= split
        if opt.name not in p_train._ELEMENTWISE:
            # the optimizer state is gathered too (updated whole), and a
            # split leaf's params and gradients over the model axis
            gathers += sum(1 for pl in _leaves(step.shardings["opt"])
                           for e in pl.spec if entry_axes(e)) + 2 * split
        r_cfg = r_registry.get(arch, smoke=True).cfg
        mf = model_flops(_member_config(r_cfg, plan, m),
                         R_SHAPES[shape].smoke())
        assert 0.5 * mf < res["flops"] * blocks < 3 * mf
        assert coll["all-gather"]["count"] == gathers
        n_leaves = len(_leaves(params))
        assert coll["all-reduce"]["count"] == \
            ((n_leaves + 1) if blocks > 1 else 0) + \
            _tp_reductions(cfg, plan)
    else:
        serve = PlacedServe(api, m, rules)
        plan = serve.plan
        split = 0 if plan is None else \
            sum(d is not None for d in plan.dims)
        # a split leaf keeps its model block: gathered over the data axes
        # only; a cache leaf is gathered over every axis of its spec but
        # the batch's, and under the plan but model for k / v (the
        # attention exchanges what it reads) and for state / conv where
        # the mixers split
        gathers -= split
        sc = full.smoke()
        cache = serve.cache_shardings(sc.global_batch, sc.seq_len)
        keep = set(entry_axes(rules["batch"]))
        for k, pl in cache.items():
            mine = keep | ({"model"} if plan is not None and (
                k in ("k", "v") or plan.ssm and k in ("state", "conv"))
                else set())
            gathers += sum(1 for e in pl.spec
                           if set(entry_axes(e)) - mine)
        assert coll["all-gather"]["count"] == gathers
        assert coll["all-reduce"]["count"] == _tp_serve_reductions(
            cfg, plan, full.mode)
        kv_split = plan is not None and serve.kv_split(sc.global_batch,
                                                       sc.seq_len)
        assert coll["all-to-all"]["count"] == \
            2 * _attention_applications(cfg) * kv_split
        assert res["gathered_param_bytes"] == serve.gathered_param_bytes()
        r_cfg = r_registry.get(arch, smoke=True).cfg
        mf = model_flops(_member_config(r_cfg, plan, m), R_SHAPES[shape]
                         .smoke())
        assert 0.5 * mf < res["flops"] * blocks < 3 * mf
    assert res["corrected"]["flops"] == res["flops"]


MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes",
               "peak_memory_in_bytes"}
# a serve step writes the k / v cache in place and a decode step passes
# the encoder memory on (a prefill given frames writes a new one); pos,
# the Mamba2 state and conv tail are new tensors
IN_PLACE_CACHE = {"prefill": ("k", "v"), "decode": ("k", "v", "enc_out")}
METRICS_BYTES = 3 * 4                  # loss, lr and grad_norm, f32 scalars


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_every_cell_reports_its_steps_memory(arch, shape, mesh):
    """Every cell reports the reference's memory keys but the generated
    code's; the peak holds the arguments and the outputs that are not
    aliases; a serve cell's aliases are its k / v (and encoder memory)
    blocks, a train cell's outputs its blocks of the new state and the
    metrics (the functional step aliases nothing)."""
    res = _grid()[f"{arch}|{shape}|{mesh}"]
    assert "error" not in res, res.get("traceback")
    if "skipped" in res:
        return
    mem = res["memory"]
    assert set(mem) == MEMORY_KEYS
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] \
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]
    assert mem["temp_size_in_bytes"] >= 0
    api = p_registry.get(arch, smoke=True)
    m = p_mesh.make_production_mesh(multi_pod=mesh == "multi",
                                    device="meta")
    sc = SHAPES[shape].smoke()
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, sc.mode),
                                    m, sc.global_batch)
    if sc.mode == "train":
        opt = make_optimizer(api.cfg.optimizer)
        step = p_train.make_sharded_train_step(api, opt, None, m, rules)
        state = dryrun._placed_bytes(p_train.abstract_train_state(api, opt),
                                     step.shardings)
        assert mem["output_size_in_bytes"] == state + METRICS_BYTES
        assert mem["alias_size_in_bytes"] == 0
    else:
        cache = PlacedServe(api, m, rules).cache_shardings(sc.global_batch,
                                                           sc.seq_len)
        abstract = api.abstract_cache(sc)
        assert mem["alias_size_in_bytes"] == sum(
            dryrun._placed_bytes(abstract[k], cache[k])
            for k in IN_PLACE_CACHE[sc.mode] if k in cache)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_the_memory_counter_changes_no_count(shape):
    """A cell's op counts, FLOPs, bytes and collectives are the same
    traced with the memory counter (``dryrun.trace_step``) and without it
    (the step traced under the op counter alone)."""
    from repro_torch.core.placement import place_tree

    api = p_registry.get("llama3.2-1b", smoke=True)
    m = p_mesh.make_production_mesh(device="meta")
    sc = SHAPES[shape].smoke()
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, sc.mode),
                                    m, sc.global_batch)
    both = dryrun.trace_step(api, sc, m, rules)
    alone = hlo_analysis.OpCounter()
    inputs = dryrun._meta_inputs(api.input_specs(sc))
    before = hlo_analysis.stats_snapshot()
    if sc.mode == "train":
        opt = make_optimizer(api.cfg.optimizer)
        step = p_train.ShardedTrainStep(
            api, opt, warmup_cosine(3e-4, 100, 10_000), m, rules)
        step.trace(place_tree(p_train.abstract_train_state(api, opt),
                              step.shardings), inputs, lambda: alone)
    else:
        serve = PlacedServe(api, m, rules)
        cache = place_tree(api.abstract_cache(sc), p_mesh.tree_shardings(
            m, api.cache_axes(sc), rules, api.abstract_cache(sc)))
        serve.decode_step(place_tree(api.abstract(), serve.param_shardings),
                          inputs["tokens"], cache, traced=True,
                          count=lambda: alone)
    coll = hlo_analysis.collective_stats(before)
    got = both["counter"]
    assert (got.calls, got.flops, got.bytes) == (alone.calls, alone.flops,
                                                 alone.bytes)
    assert both["collectives"] == coll
    assert both["memory"].peak > 0


def _attention_applications(cfg):
    """The self-attention blocks a forward runs: every layer of an
    attention stack, each application of the hybrid's shared block."""
    if cfg.family == "hybrid":
        return -(-cfg.num_layers // cfg.attn_every)
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _tp_serve_reductions(cfg, plan, mode):
    """The all-reduces a tensor-parallel placed prefill or decode adds
    (position 0's group, forward only): per attention block the
    attention's exit psum where the heads split and the MLP sublayer's
    one exit psum where the MLP or the experts split; per Mamba2 layer
    where its mixer splits, the gated norm's sum and the exit psum; the
    vocab-parallel embedding's exit.  The encoder-decoder's prefill (its
    frames given) adds per encoder block the attention's and the MLP's
    exits; each of its decoder blocks has the self-attention's, the
    cross-attention's and the MLP's.  None without a plan (a config
    whose regions do not divide)."""
    if plan is None:
        return 0
    if cfg.is_encdec:
        enc = cfg.enc_layers if mode == "prefill" else 0
        return (enc * (plan.heads + plan.mlp)
                + cfg.num_layers * (2 * plan.heads + plan.mlp) + plan.vocab)
    mixers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return (_attention_applications(cfg) * (plan.heads + (plan.mlp
                                                          or plan.experts))
            + mixers * 2 * plan.ssm + plan.vocab)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_llama_serve_cells_gather_the_train_cells_blocks(shape):
    """llama3.2-1b at full size on the (16, 16) mesh: its placed prefill
    and decode split the heads, d_ff and vocab over ``model``, so
    position 0 gathers 217,518,080 B of params, the train cell's blocks,
    not the whole 2,471,628,800 B; the probe identity is exact, and the
    collectives are the group's sums and, at decode, the kv exchange."""
    import math

    res, = dryrun.run_grid(["llama3.2-1b"], [shape], ["single"], None,
                           smoke=False)
    assert "error" not in res, res.get("traceback")
    assert res["probe_check"]["exact"], res["probe_check"]
    assert res["gathered_param_bytes"] == 217_518_080 == _grid_full_train()
    api = p_registry.get("llama3.2-1b")
    assert sum(math.prod(v.shape) * v.dtype.itemsize
               for v in _leaves(api.abstract())) == 2_471_628_800
    m = p_mesh.make_production_mesh(device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(
        api.cfg, m, SHAPES[shape].mode), m, SHAPES[shape].global_batch)
    plan = PlacedServe(api, m, rules).plan
    assert (plan.heads, plan.mlp, plan.vocab) == (True, True, True)
    coll = res["collectives"]["per_op"]
    # 16 attention exits, 16 MLP exits, the embedding's
    assert coll["all-reduce"]["count"] == \
        _tp_serve_reductions(api.cfg, plan, SHAPES[shape].mode) == 33
    assert coll["all-gather"]["count"] == 0
    # the decode rules split the cache's sequence: k and v a layer
    assert coll["all-to-all"]["count"] == (32 if shape == "decode_32k"
                                           else 0)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_encdec_serve_cells_gather_the_train_cells_blocks(shape):
    """seamless-m4t-medium at full size on the (16, 16) mesh: its placed
    prefill and decode split the heads of every self- and
    cross-attention and both stacks' d_ff over ``model``, not the vocab
    (256206 % 16 = 14), so position 0 gathers 710,623,232 B of params,
    the train_4k cell's blocks, not the whole 1,229,852,672 B; the probe
    identity is exact, and the collectives are the group's sums (at
    prefill the encoder's too) and, at decode, the kv exchange."""
    res, = dryrun.run_grid(["seamless-m4t-medium"], [shape], ["single"],
                           None, smoke=False)
    assert "error" not in res, res.get("traceback")
    assert res["probe_check"]["exact"], res["probe_check"]
    decode = shape == "decode_32k"
    assert [b["kind"] for b in res["bodies"]] == (
        ["dec_block"] if decode else ["enc_block", "dec_block"])
    api = p_registry.get("seamless-m4t-medium")
    m = p_mesh.make_production_mesh(device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(
        api.cfg, m, SHAPES[shape].mode), m, SHAPES[shape].global_batch)
    plan = PlacedServe(api, m, rules).plan
    assert (plan.heads, plan.mlp, plan.vocab) == (True, True, False)
    step = p_train.make_sharded_train_step(
        api, make_optimizer(api.cfg.optimizer), None, m,
        p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, "train"), m,
                                SHAPES["train_4k"].global_batch))
    assert res["gathered_param_bytes"] == 710_623_232 \
        == step.gathered_param_bytes()
    coll = res["collectives"]["per_op"]
    # 12 decoder blocks' three exits each, at prefill 12 encoder blocks'
    # two
    assert coll["all-reduce"]["count"] == \
        _tp_serve_reductions(api.cfg, plan, SHAPES[shape].mode) == \
        (36 if decode else 60)
    assert coll["all-gather"]["count"] == 0
    # the decode rules split the cache's sequence: k and v a layer
    assert coll["all-to-all"]["count"] == (24 if decode else 0)


@functools.lru_cache(maxsize=None)
def _grid_full_train():
    api = p_registry.get("llama3.2-1b")
    m = p_mesh.make_production_mesh(device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, "train"),
                                    m, SHAPES["train_4k"].global_batch)
    return p_train.make_sharded_train_step(
        api, make_optimizer(api.cfg.optimizer), None, m,
        rules).gathered_param_bytes()


def _member_config(cfg, plan, mesh):
    """``cfg`` cut to the work one member of a tensor-parallel model
    group does (``None``: the whole model): its heads, the kv heads they
    read, its share of d_ff and of the vocab.  The FLOPs band holds a
    position's count, times the batch blocks, against this config's
    ``model_flops``: the work is shared over the positions that split
    it."""
    import dataclasses

    if plan is None:
        return cfg
    t = mesh.shape["model"]
    h, g = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    kw = {"head_dim": cfg.resolved_head_dim}
    if plan.heads:
        kw.update(num_heads=h // t,
                  num_kv_heads=(h // t - 1) // g + 1 if h // t >= g else 1)
    if plan.mlp or plan.experts:
        # the dense MLP and each expert share d_ff
        kw["d_ff"] = cfg.d_ff // t
    if plan.vocab:
        kw["vocab_size"] = cfg.vocab_size // t
    return dataclasses.replace(cfg, **kw)


def _tp_reductions(cfg, plan):
    """The all-reduces a step's tensor parallelism adds (position 0's
    group, each micro-batch): per attention block (each layer of an
    attention stack, each application of the hybrid's shared block), the
    attention's exit psum and, in the backward, its entry's and the kv
    projections' (wk, wv, and bk, bv with qkv biases); the MLP sublayer's
    one exit psum where the MLP or the experts split, and in the backward
    the MLP's entry psum and the experts' two (the dispatched buffer's and
    the gates'); per Mamba2 layer where its mixer splits, the gated norm's
    sum and the exit psum forward, and in the backward the entry's,
    ``wB``'s, ``wC``'s and the norm's sum's; under remat each exit but a
    block's last once more (the recompute stops at the last tensor the
    backward saved); the vocab-parallel embedding's exit, the head's
    entry, the cross-entropy's pmax and its two psums; then the gradient
    norm's psum.  An encoder-decoder's encoder block has one attention
    (its entry sums in the first block too: ``ln1``'s scale and bias read
    the normed input's gradient), a decoder block two (the
    cross-attention's kv projections without biases) before the MLP, and
    the memory enters the decoder's regions once."""
    if plan is None:
        return 0
    redo = cfg.remat != "none"
    kv = 4 if cfg.qkv_bias else 2
    heads = plan.heads * (2 + redo + kv)
    attn = heads + plan.mlp + 2 * plan.experts + (plan.mlp or plan.experts)
    ssm = plan.ssm * (6 + redo)
    head = plan.vocab * 5
    mb = max(1, cfg.micro_batches)
    if cfg.is_encdec:
        cross = plan.heads * (2 + redo + 2)
        return mb * (cfg.enc_layers * attn + cfg.num_layers * (attn + cross)
                     + plan.heads + head) + 1
    if cfg.family == "hybrid":
        apps, mixers = -(-cfg.num_layers // cfg.attn_every), cfg.num_layers
    elif cfg.family == "ssm":
        apps, mixers = 0, cfg.num_layers
    else:
        apps, mixers = cfg.num_layers, 0
    return mb * (apps * attn + mixers * ssm + head) + 1


def test_encdec_full_size_cell_gathers_the_plans_blocks():
    """seamless-m4t-medium at full size, train_4k on the (16, 16) mesh:
    the step splits the heads of every self- and cross-attention (1 of
    16 a member) and both stacks' d_ff, not the vocab (256206 % 16 = 14),
    so position 0 gathers 355,311,616 params (the plan's), not the whole
    614,926,336; the probe identity is exact, and the all-reduces are the
    batch's sums plus what tensor parallelism adds under remat
    ``dots``."""
    import math

    api = p_registry.get("seamless-m4t-medium")
    m = p_mesh.make_production_mesh(device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, "train"),
                                    m, SHAPES["train_4k"].global_batch)
    step = p_train.make_sharded_train_step(
        api, make_optimizer(api.cfg.optimizer), None, m, rules)
    plan = step.tp
    assert (plan.heads, plan.mlp, plan.vocab) == (True, True, False)
    res, = dryrun.run_grid(["seamless-m4t-medium"], ["train_4k"], ["single"],
                           None, smoke=False)
    assert "error" not in res, res.get("traceback")
    assert res["probe_check"]["exact"], res["probe_check"]
    assert [b["kind"] for b in res["bodies"]] == ["enc_block_in",
                                                  "enc_block", "dec_block"]
    whole = sum(math.prod(v.shape) for v in _leaves(api.abstract()))
    assert whole == 614_926_336
    assert res["gathered_param_bytes"] == step.gathered_param_bytes() \
        == 2 * 355_311_616
    n_leaves = len(_leaves(api.abstract()))
    assert res["collectives"]["per_op"]["all-reduce"]["count"] == \
        n_leaves + 1 + _tp_reductions(api.cfg, plan)


def _leaves(tree):
    from repro_torch.core.treepath import tree_leaves
    return tree_leaves(tree)


def test_op_counter_prices_a_matmul_and_its_bytes():
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 16, device="meta")
    counter = hlo_analysis.OpCounter()
    with counter:
        c = a @ b
        d = c + 1
    assert counter.flops["aten.mm"] == 2 * 4 * 8 * 16
    assert counter.bytes["aten.mm"] == (4 * 8 + 8 * 16 + 4 * 16) * 4
    assert counter.calls["aten.add"] == 1 and counter.flops["aten.add"] == 0
    assert hlo_analysis.cost_dict(counter) == {
        "flops": float(2 * 4 * 8 * 16),
        "bytes accessed": float(counter.total_bytes)}
    assert list(hlo_analysis.op_census(counter, top=1)) in (["aten.mm"],
                                                            ["aten.add"])
    assert d.shape == (4, 16)
    assert hlo_analysis.memory_dict(10) == {"argument_size_in_bytes": 10}
    assert hlo_analysis.memory_dict() == {}


def test_collective_stats_map_onto_the_references_names():
    mesh = p_mesh.make_debug_mesh(2, 2, device="cpu")
    xs = [torch.ones(4, 2) for _ in range(4)]
    before = hlo_analysis.stats_snapshot()
    C.psum(xs, mesh, "data")
    C.pmean(xs, mesh, "data")
    C.all_gather(xs, mesh, "model", axis=1)
    C.psum_scatter(xs, mesh, "data")
    C.all_to_all(xs, mesh, "model", 0, 1)
    st = hlo_analysis.collective_stats(before)
    per = st["per_op"]
    assert per["all-reduce"] == {"count": 2, "bytes": 2 * 32}
    assert per["all-gather"] == {"count": 1, "bytes": 32}
    assert per["reduce-scatter"]["count"] == 1
    assert per["all-to-all"]["count"] == 1
    assert per["collective-permute"]["count"] == 0
    assert st["total_count"] == 5 and st["total_bytes"] == 5 * 32
    # meta positions: one result a call, every position given it
    meta = p_mesh.make_debug_mesh(2, 2, device="meta")
    ms = [torch.empty(4, 2, device="meta") for _ in range(4)]
    out = C.all_gather(ms, meta, "data", axis=1)
    assert out[0] is out[2] and out[0].shape == (4, 4)


def test_kernels_take_their_plain_path_on_meta():
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.marshal_pack import kernel as mk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.ssd_scan import kernel as sk

    before = (rk.rmsnorm.launches, fk.flash_attention.launches,
              dk.decode_attention.launches, sk.ssd_chunks.launches,
              mk.gather_tiles.launches)
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    assert rk.rmsnorm(m(2, 8), m(8)).device.type == "meta"
    assert fk.flash_attention(m(1, 4, 2, 16), m(1, 4, 2, 16),
                              m(1, 4, 2, 16)).shape == (1, 4, 2, 16)
    assert dk.decode_attention(m(1, 2, 16), m(1, 2, 8, 16), m(1, 2, 8, 16),
                               m(1, dt=torch.int32)).shape == (1, 2, 16)
    y, states, cum = sk.ssd_chunks(m(1, 2, 2, 4, 8), m(1, 2, 2, 1, 4),
                                   m(1, 2, 2, 1, 4), m(1, 2, 4, 8),
                                   m(1, 2, 4, 8))
    assert y.device.type == "meta"
    assert mk.gather_tiles(m(16, 128), m(2, dt=torch.int32)).shape == \
        (16, 128)
    assert (rk.rmsnorm.launches, fk.flash_attention.launches,
            dk.decode_attention.launches, sk.ssd_chunks.launches,
            mk.gather_tiles.launches) == before
    assert resolve_device("meta").type == "meta"


def test_sharded_step_trace_counts_one_position():
    """The dry run's trace: one position's compute under the counter,
    the collectives over every position."""
    api = p_registry.get("llama3.2-1b", smoke=True)
    opt = make_optimizer("adamw")
    mesh = p_mesh.make_debug_mesh(2, 2, device="meta")
    step = p_train.make_sharded_train_step(api, opt, lambda s: s * 0.0,
                                           mesh)
    state = p_train.abstract_train_state(api, opt)
    batch = {k: torch.empty((4, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    counter = hlo_analysis.OpCounter()
    before = hlo_analysis.stats_snapshot()
    step.trace(step.place(state), batch, lambda: counter)
    one = counter.total_flops
    assert one > 0
    st = hlo_analysis.collective_stats(before)
    assert st["per_op"]["all-reduce"]["count"] > 0


def test_a_dense_cells_gathered_bytes_are_its_model_blocks():
    """A dense or vlm train cell's ``gathered_param_bytes``: each param
    leaf's block over the model axis (where its placement blocks a dim
    over ``model``), whole over the data axes, summed; the whole params
    where nothing splits (an ssm cell)."""
    import math

    def whole_over_data(arch):
        api = p_registry.get(arch, smoke=True)
        m = p_mesh.make_production_mesh(device="meta")
        rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, "train"),
                                        m, SHAPES["train_4k"].smoke()
                                        .global_batch)
        out = 0
        for v, pl in zip(_leaves(api.abstract()), _leaves(
                p_mesh.tree_shardings(m, api.axes(), rules, api.abstract()))):
            n = math.prod(v.shape)
            if any(entry_axes(e) == ("model",) for e in pl.spec):
                n //= m.shape["model"]
            out += n * v.dtype.itemsize
        return out, sum(math.prod(v.shape) * v.dtype.itemsize
                        for v in _leaves(api.abstract()))

    got = _grid()["llama3.2-1b|train_4k|single"]["gathered_param_bytes"]
    want, whole = whole_over_data("llama3.2-1b")
    assert got == want < whole
    got = _grid()["phi-3-vision-4.2b|train_4k|single"]["gathered_param_bytes"]
    want, whole = whole_over_data("phi-3-vision-4.2b")
    assert got == want < whole
    got = _grid()["mamba2-1.3b|train_4k|single"]["gathered_param_bytes"]
    assert got == whole_over_data("mamba2-1.3b")[1]


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "moonshot-v1-16b-a3b",
                                  "arctic-480b"])
@pytest.mark.parametrize("mesh", MESHES)
def test_vlm_and_moe_cells_gather_the_plans_blocks(arch, mesh):
    """A vlm or MoE train cell at smoke size gathers what the step's
    tensor-parallel plan says a position holds
    (``ShardedTrainStep.gathered_param_bytes``): d_ff (96) splits 16 ways,
    the dense MLP's and every expert's, so less than the whole params."""
    import math

    api = p_registry.get(arch, smoke=True)
    m = p_mesh.make_production_mesh(multi_pod=mesh == "multi",
                                    device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, "train"),
                                    m, SHAPES["train_4k"].smoke()
                                    .global_batch)
    step = p_train.make_sharded_train_step(
        api, make_optimizer(api.cfg.optimizer), None, m, rules)
    plan = step.tp
    assert plan is not None and plan.mlp == (arch != "moonshot-v1-16b-a3b")
    assert plan.experts == (api.cfg.family == "moe") and not plan.heads
    whole = sum(math.prod(v.shape) * v.dtype.itemsize
                for v in _leaves(api.abstract()))
    got = _grid()[f"{arch}|train_4k|{mesh}"]["gathered_param_bytes"]
    assert got == step.gathered_param_bytes() < whole


@pytest.mark.parametrize("arch,regions", [
    ("mamba2-1.3b", (False, False, False, True)),
    ("zamba2-2.7b", (True, True, True, True))])
def test_ssm_and_hybrid_full_size_cells_gather_the_plans_blocks(arch,
                                                               regions):
    """mamba2 and zamba2 at full size, train_4k on the (16, 16) mesh: the
    step splits the mixers' heads over the model axis (4 and 5 a member;
    zamba2 also its shared block's heads, d_ff and vocab), so position 0
    gathers what the plan says it holds, less than the whole params; the
    probe identity is exact, and the all-reduces are the batch's sums
    plus what tensor parallelism adds under remat ``dots``."""
    import math

    api = p_registry.get(arch)
    m = p_mesh.make_production_mesh(device="meta")
    rules = p_mesh.adapt_batch_rule(p_mesh.rules_for(api.cfg, m, "train"),
                                    m, SHAPES["train_4k"].global_batch)
    step = p_train.make_sharded_train_step(
        api, make_optimizer(api.cfg.optimizer), None, m, rules)
    plan = step.tp
    assert (plan.heads, plan.mlp, plan.vocab, plan.ssm) == regions
    res, = dryrun.run_grid([arch], ["train_4k"], ["single"], None,
                           smoke=False)
    assert "error" not in res, res.get("traceback")
    assert res["probe_check"]["exact"], res["probe_check"]
    whole = sum(math.prod(v.shape) * v.dtype.itemsize
                for v in _leaves(api.abstract()))
    assert res["gathered_param_bytes"] == step.gathered_param_bytes() < whole
    n_leaves = len(_leaves(api.abstract()))
    assert res["collectives"]["per_op"]["all-reduce"]["count"] == \
        n_leaves + 1 + _tp_reductions(api.cfg, plan)


def test_tensor_parallel_trace_splits_the_matmuls():
    """Position 0's traced step on a (2, 2) CPU mesh, llama3.2-1b smoke at
    vocab 256 (heads, d_ff and vocab split over the model axis): its
    ``aten.mm`` + ``aten.bmm`` FLOPs equal the closed form of a member's
    matmuls (the q / o projections, the attention, the MLP and the head
    at half their width, ``wk`` / ``wv`` at the one kv head its two query
    heads read), each 3x (the forward and the two gradients' products),
    which is half the replicated step's."""
    import dataclasses

    from repro_torch.data import SyntheticLM

    api = p_registry.get_model(dataclasses.replace(
        p_registry.get("llama3.2-1b", smoke=True).cfg, vocab_size=256))
    cfg = api.cfg
    opt = make_optimizer("sgdm")
    mesh = p_mesh.make_debug_mesh(2, 2, device="cpu")
    step = p_train.make_sharded_train_step(api, opt, lambda s: s * 0.0,
                                           mesh)
    state = p_train.train_state(api, opt, torch.Generator().manual_seed(0),
                                device="cpu")
    B, S = 8, 16
    counter = hlo_analysis.OpCounter()
    before = hlo_analysis.stats_snapshot()
    step.trace(step.place(state), SyntheticLM(256, S, B).batch(0),
               lambda: counter)
    got = counter.flops["aten.mm"] + counter.flops["aten.bmm"]

    def closed(heads, kv_heads, d_ff, vocab):
        b = B // mesh.shape["data"]
        n, d, hd = b * S, cfg.d_model, cfg.resolved_head_dim
        proj = 2 * n * d * hd * (2 * heads + 2 * kv_heads)
        attn = 2 * 2 * b * heads * S * S * hd
        mlp = 3 * 2 * n * d * d_ff
        return 3 * (cfg.num_layers * (proj + attn + mlp) + 2 * n * d * vocab)

    assert got == closed(cfg.num_heads // 2, 1, cfg.d_ff // 2,
                         cfg.vocab_size // 2)
    assert 2 * got == closed(cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
                             cfg.vocab_size)
    coll = hlo_analysis.collective_stats(before)["per_op"]
    n_leaves = len(_leaves(api.abstract()))
    assert coll["all-reduce"]["count"] == n_leaves + 1 + \
        _tp_reductions(cfg, step.tp)
