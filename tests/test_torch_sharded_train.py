"""The production-mesh train step (``runtime.train.ShardedTrainStep``), its
loop and its CLI, on CPU positions, held to the JAX package's jitted step
under ``tree_shardings``.

The reference runs once per module in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (set in the child
only): llama3.2-1b smoke (float32), SGD-momentum, ``constant(1e-3)``,
``SyntheticLM(vocab, 16, 8)``, three steps from ``PRNGKey(0)`` of
``jax.jit(make_train_step(...), in_shardings=(tree_shardings(mesh,
train_state_axes, rules, abstract), <the batch's>))`` on a (2, 2) mesh
under ``pspec.activate``.  Its mesh's axes are ``Auto``: ``jax.make_mesh``
makes ``Explicit`` axes in this JAX version, on which the model's
``with_sharding_constraint`` raises (ROADMAP R3).  The child writes each
step's input and output state and the loss.  SGD-momentum, as in
``test_torch_dp.py``: AdamW's first update is ``lr * g / |g|`` an element,
which turns the float32 noise of a near-zero gradient into a difference of
up to ``lr`` between any two implementations (1.1e-4 at lr 1e-3 in a leaf
whose largest element is 0.44); the step updates blocks by the same code
for both elementwise optimizers.

The child also takes one step from the initial state on a batch whose
labels are masked unevenly over the row blocks of a (4, 1) mesh, at
``micro_batches`` 1 and 2 (``dataclasses.replace`` of the smoke config),
then two plain steps on from it, and the same at vocab 256 on the (2, 2)
mesh; it saves the state after every step.

The child also steps, at vocab 256 for two steps each, the tensor-parallel
families: phi-3-vision (with patches), mamba2 and seamless-m4t (with
frames) on (2, 2), moonshot, arctic and zamba2 on (1, 4), and
seamless-m4t at vocab 258 on (1, 4).

The port steps from the reference's input state of each step, on a (2, 2)
mesh of CPU positions (the batch of 8 rows over ``data``), and on the
masked batch on a (4, 1) mesh (then on from its own state through the
plain steps), and is held:

  * the loss within rtol 1e-5;
  * every leaf of the new state, gathered, within 2e-4 of the leaf's
    largest element (two float32 implementations summing in different
    orders);
  * positions that share a data index hold bit-equal blocks of every leaf
    the spec replicates over ``model`` (under deterministic algorithms:
    the embedding's index backward accumulates in a racy order otherwise);
    every block equals its block of the gathered state;
  * Adafactor (not elementwise: updated on the gathered leaves) against
    ``make_train_step`` on one position, within the same tolerances;
  * ``loop.run(state_shardings=)``: a run with a crash and a restore ends
    bit-identical to one without; ``state_policy`` with it raises;
  * ``launch.train --production-mesh --device cpu --smoke`` on a (2, 2)
    mesh (the production mesh patched to that size), and the stale-mesh
    error without the cards;
  * placed prefill and decode (``runtime.placed``) on a (2, 2) mesh equal
    to the model on one position, also a slot prefill a row at a time.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import train_state_from_reference
from repro_torch.core import UnsupportedSpecError, tree_flatten, tree_leaves
from repro_torch.core.placement import PlacedTensor, block_of
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh as p_mesh
from repro_torch.launch import train as p_launch_train
from repro_torch.models import registry as p_registry
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import loop as p_loop
from repro_torch.runtime import train as p_train

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
LOSS_RTOL = 1e-5
STATE_RTOL, ATOL = 2e-4, 1e-6
STEPS = 3
SC2_STEPS = 2
PLAIN_STEPS = 2
LR = 1e-3
OPT = "sgdm"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several processes on one host, and more threads than cores spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)

_CHILD = r'''
import dataclasses
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.data import SyntheticLM
from repro.launch.mesh import rules_for, tree_shardings
from repro.models import pspec, registry
from repro.optim import constant, make_optimizer
from repro.runtime.train import (abstract_train_state, make_train_step,
                                 train_state, train_state_axes)

api = registry.get("llama3.2-1b", smoke=True)
opt = make_optimizer("OPT")
data = SyntheticLM(api.cfg.vocab_size, 16, 8)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}


def patched(api_x, batch, s):
    """``batch`` with a vlm model's patches (8, P, d_model) or an encdec
    model's frames (8, 16 / src_ratio, d_model), float32 from
    ``default_rng(s)``."""
    cfg = api_x.cfg
    if cfg.frontend == "vision":
        key, rows = "patches", cfg.frontend_tokens
    elif cfg.is_encdec:
        key, rows = "frames", max(1, 16 // cfg.src_ratio)
    else:
        return batch
    rng = np.random.default_rng(s)
    return dict(batch, **{key: rng.standard_normal(
        (8, rows, cfg.d_model)).astype(np.float32)})


def jitted(api_x, mesh_x):
    rules_x = rules_for(api_x.cfg, mesh_x, "train")
    batch = patched(api_x, data.batch(0), 0)
    specs = {k: jax.ShapeDtypeStruct(
        v.shape, jnp.float32 if k in ("patches", "frames") else jnp.int32)
        for k, v in batch.items()}
    with pspec.activate(mesh_x, rules_x):
        state_sh = tree_shardings(mesh_x, train_state_axes(api_x, opt),
                                  rules_x, abstract_train_state(api_x, opt))
        batch_sh = tree_shardings(
            mesh_x, {k: ("batch",) + (None,) * (v.ndim - 1)
                     for k, v in batch.items()}, rules_x, specs)
    step = jax.jit(make_train_step(api_x, opt, constant(LR)),
                   in_shardings=(state_sh, batch_sh),
                   out_shardings=(state_sh, None))

    def call(state, batch):
        with pspec.activate(mesh_x, rules_x):
            return step(state, {k: jnp.asarray(v, specs[k].dtype)
                                for k, v in batch.items()})
    return call


def run(tag, api_x, steps, mesh_x=mesh):
    """``steps`` steps from PRNGKey(0) on ``mesh_x`` (the (2, 2) mesh by
    default); returns the initial state."""
    data_x = SyntheticLM(api_x.cfg.vocab_size, 16, 8)
    step = jitted(api_x, mesh_x)
    state = state0 = train_state(api_x, opt, jax.random.PRNGKey(0))
    for s in range(steps):
        for i, l in enumerate(jax.tree_util.tree_leaves(state)):
            out["%s%d/in/%d" % (tag, s, i)] = np.asarray(l)
        state, metrics = step(state, patched(api_x, data_x.batch(s), s))
        out["%s%d/loss" % (tag, s)] = np.asarray(metrics["loss"])
        for i, l in enumerate(jax.tree_util.tree_leaves(state)):
            out["%s%d/out/%d" % (tag, s, i)] = np.asarray(l)
    return state0


def masked_steps(tag, api_x, mesh_x, state0):
    """One step from ``state0`` on a batch whose labels are masked
    unevenly over the row blocks, then PLAIN_STEPS plain steps on the
    batches after it, at 1 and 2 micro-batches."""
    data_x = SyntheticLM(api_x.cfg.vocab_size, 16, 8)
    masked = {k: np.array(v) for k, v in data_x.batch(0).items()}
    masked["labels"][0:2] = -1
    masked["labels"][2, :12] = -1
    masked["labels"][3, :4] = -1
    for m in (1, 2):
        api_m = registry.get_model(dataclasses.replace(api_x.cfg,
                                                       micro_batches=m))
        step = jitted(api_m, mesh_x)
        state = state0
        for j in range(1 + PLAIN_STEPS):
            state, metrics = step(state, data_x.batch(j) if j else masked)
            key = "%s%d" % (tag, m) + ("/plain%d" % j if j else "")
            out[key + "/loss"] = np.asarray(metrics["loss"])
            for i, l in enumerate(jax.tree_util.tree_leaves(state)):
                out["%s/out/%d" % (key, i)] = np.asarray(l)


state0 = run("", api, STEPS)
# labels masked unevenly over the four row blocks of a (4, 1) mesh
mesh4 = jax.make_mesh((4, 1), ("data", "model"),
                      axis_types=(AxisType.Auto, AxisType.Auto))
masked_steps("masked", api, mesh4, state0)
# the vocab split over the model axis too (257 does not divide by 2)
api256 = registry.get_model(dataclasses.replace(api.cfg, vocab_size=256))
masked_steps("v256masked", api256, mesh, run("v256/", api256, STEPS))
# LayerNorm, the GeLU MLP with b_up / b_down, the qkv biases
run("sc2/", registry.get("starcoder2-3b", smoke=True), SC2_STEPS)
# the vlm with its patches on (2, 2); the MoE family on (1, 4), where the
# one row block is the whole batch and so routes as the reference does
# the ssm family on (2, 2), the hybrid on (1, 4)
# the encdec with its frames on (2, 2), and on (1, 4) at vocab 258, which
# splits by 2 but not by 4
for tag, arch, shape, vocab in (
        ("vlm/", "phi-3-vision-4.2b", (2, 2), 256),
        ("moonshot/", "moonshot-v1-16b-a3b", (1, 4), 256),
        ("arctic/", "arctic-480b", (1, 4), 256),
        ("mamba2/", "mamba2-1.3b", (2, 2), 256),
        ("zamba2/", "zamba2-2.7b", (1, 4), 256),
        ("seamless/", "seamless-m4t-medium", (2, 2), 256),
        ("seamless258/", "seamless-m4t-medium", (1, 4), 258)):
    api_x = registry.get_model(dataclasses.replace(
        registry.get(arch, smoke=True).cfg, vocab_size=vocab))
    run(tag, api_x, SC2_STEPS, jax.make_mesh(
        shape, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto)))
np.savez(sys.argv[1], **out)
print("ok")
'''


def _masked_batch(batch):
    """The child's masked batch: of a data axis of 4, row block 0 (rows
    0-1) all masked, block 1 (rows 2-3) half masked and unevenly over its
    two rows, blocks 2 and 3 not masked."""
    masked = {k: np.array(v) for k, v in batch.items()}
    masked["labels"][0:2] = -1
    masked["labels"][2, :12] = -1
    masked["labels"][3, :4] = -1
    return masked


@functools.lru_cache(maxsize=None)
def reference_sharded_steps(path: str) -> dict:
    """The reference's jitted steps under its shardings on a forced
    4-device host, run once per process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    code = _CHILD.replace("SC2_STEPS", str(SC2_STEPS)) \
        .replace("PLAIN_STEPS", str(PLAIN_STEPS)) \
        .replace("STEPS", str(STEPS)).replace("LR", repr(LR)) \
        .replace("OPT", OPT)
    # a guard against a hung child, not a budget: the child takes about
    # 80 s alone and more than twice that beside the rest of the suite on
    # 6 workers
    proc = subprocess.run([sys.executable, "-c", code, path], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_sharded_steps(
        str(tmp_path_factory.mktemp("sharded_reference") / "ref.npz"))


@pytest.fixture(autouse=True)
def deterministic():
    """Positions that share a data index compute the same rows; their
    results are bit-equal only if the backward is deterministic (the
    embedding's index backward accumulates in a racy order otherwise)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@functools.lru_cache(maxsize=None)
def _api():
    return p_registry.get("llama3.2-1b", smoke=True)


def _mesh():
    return p_mesh.make_debug_mesh(2, 2, device=CPU)


def _ref_state(ref, prefix, opt, api=None):
    template = p_train.abstract_train_state(api or _api(), opt)
    leaves_t, treedef = tree_flatten(template)
    return train_state_from_reference(treedef.unflatten(
        [ref[f"{prefix}/{i}"] for i in range(len(leaves_t))]), CPU)


def _close(got, want, what, rtol=STATE_RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max(initial=0.0))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= ATOL + rtol * top, f"{what}: {err} vs max {top}"


def _check_blocks(state, mesh):
    """Blocks equal their block of the gathered state; positions that
    differ only on ``model`` hold equal blocks where the spec replicates
    over it."""
    for leaf in tree_leaves(state):
        assert isinstance(leaf, PlacedTensor)
        whole = leaf.gather()
        for p in range(mesh.size):
            assert torch.equal(leaf.blocks[p],
                               block_of(whole, leaf.placement, p))
        if not any("model" in (e if isinstance(e, tuple) else (e,))
                   for e in leaf.placement.spec):
            for group in mesh.groups("model"):
                for p in group[1:]:
                    assert torch.equal(leaf.blocks[p], leaf.blocks[group[0]])


@pytest.mark.parametrize("s", range(STEPS))
def test_sharded_step_matches_the_references_jitted_step(ref, s):
    opt = make_optimizer(OPT)
    mesh = _mesh()
    step = p_train.make_sharded_train_step(_api(), opt, constant(LR), mesh)
    data = SyntheticLM(_api().cfg.vocab_size, 16, 8)
    state, metrics = step(_ref_state(ref, f"{s}/in", opt), data.batch(s))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref[f"{s}/loss"]), rtol=LOSS_RTOL)
    for i, leaf in enumerate(tree_leaves(state)):
        _close(leaf.gather(), ref[f"{s}/out/{i}"], f"step {s} leaf {i}")
    _check_blocks(state, mesh)
    # the state stays in the step's placements
    assert [x.placement for x in tree_leaves(state)] == \
        tree_leaves(step.shardings)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_sharded_step_matches_the_reference_on_masked_labels(ref,
                                                             micro_batches):
    """Labels masked unevenly over the row blocks of a (4, 1) mesh (one
    block all masked, one half masked, two not): the loss and every leaf
    of the new state equal the reference's jitted step on the whole batch,
    whose loss is the masked mean over the batch (over each of its
    micro-slices at ``micro_batches`` 2), not the blocks' mean."""
    import dataclasses

    opt = make_optimizer(OPT)
    mesh = p_mesh.make_debug_mesh(4, 1, device=CPU)
    api = p_registry.get_model(dataclasses.replace(
        _api().cfg, micro_batches=micro_batches))
    step = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    batch = _masked_batch(SyntheticLM(api.cfg.vocab_size, 16, 8).batch(0))
    assert [int((batch["labels"][r:r + 2] >= 0).sum())
            for r in range(0, 8, 2)] == [0, 16, 32, 32]
    state, metrics = step(_ref_state(ref, "0/in", opt), batch)
    want = ref[f"masked{micro_batches}/loss"]
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=LOSS_RTOL)
    for i, leaf in enumerate(tree_leaves(state)):
        _close(leaf.gather(), ref[f"masked{micro_batches}/out/{i}"],
               f"masked m={micro_batches} leaf {i}")
    _check_blocks(state, mesh)


# the masked step, then the plain ones, on a (4, 1) mesh (llama3.2-1b
# smoke, vocab 257) and on a (2, 2) mesh at vocab 256 (every region split
# over the model axis): (the reference's keys, its input state, the mesh)
MASKED_THEN_PLAIN = {"mesh4": ("masked", "0/in", (4, 1)),
                     "v256": ("v256masked", "v256/0/in", (2, 2))}


@pytest.mark.parametrize("micro_batches", [1, 2])
@pytest.mark.parametrize("case", list(MASKED_THEN_PLAIN))
def test_masked_then_plain_steps_match_the_reference(ref, case,
                                                     micro_batches):
    """The masked batch, then PLAIN_STEPS plain batches: each step taken
    from the reference's state before it (the masked step's output feeds
    the first plain step: its momentum built from the label weights),
    and after it the loss, every leaf of the params and of the optimizer
    state, and every block held to the reference's jitted step on the
    same mesh at the tolerances above.

    Each step starts from the reference's state, as every test of this
    module does, because two float32 trajectories part by rounding that
    the seeded model amplifies step by step, with or without the masked
    step: at vocab 256 on (2, 2), after three plain steps the reference's
    own trajectory jitted on one device ends 2.5e-4 of a leaf's largest
    element from its (2, 2) one, and the port's 2.1e-4; with the masked
    step first 1.7e-4 and 2.5e-4; a step from the reference's state stays
    within 1.2e-4 (``scripts/torch_f32_spread.py``)."""
    import dataclasses

    prefix, start, shape = MASKED_THEN_PLAIN[case]
    opt = make_optimizer(OPT)
    mesh = p_mesh.make_debug_mesh(*shape, device=CPU)
    base = _api() if case == "mesh4" else _tp_api("v256")
    api = p_registry.get_model(dataclasses.replace(
        base.cfg, micro_batches=micro_batches))
    step = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    assert (step.tp is None) == (case == "mesh4")
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    before = start
    for j in range(1 + PLAIN_STEPS):
        batch = data.batch(j) if j else _masked_batch(data.batch(0))
        state, metrics = step(_ref_state(ref, before, opt, api), batch)
        key = f"{prefix}{micro_batches}" + (f"/plain{j}" if j else "")
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref[f"{key}/loss"]), rtol=LOSS_RTOL)
        for i, leaf in enumerate(tree_leaves(state)):
            _close(leaf.gather(), ref[f"{key}/out/{i}"], f"{key} leaf {i}")
        _check_blocks(state, mesh)
        before = f"{key}/out"


@functools.lru_cache(maxsize=None)
def _tp_api(tag):
    """The tensor-parallel cases' models: llama3.2-1b smoke at vocab 256
    (heads, d_ff and vocab all split over a model axis of 2), and
    starcoder2-3b smoke (vocab 257 does not split; LayerNorm, the GeLU
    MLP's b_up / b_down, qkv biases)."""
    import dataclasses

    if tag == "v256":
        return p_registry.get_model(dataclasses.replace(_api().cfg,
                                                        vocab_size=256))
    return p_registry.get("starcoder2-3b", smoke=True)


TP_CASES = [("v256", s) for s in range(STEPS)] + \
    [("sc2", s) for s in range(SC2_STEPS)]


@pytest.mark.parametrize("tag,s", TP_CASES)
def test_tensor_parallel_step_matches_the_references_jitted_step(ref, tag,
                                                                 s):
    """The dense step tensor-parallel over the model axis of a (2, 2)
    mesh (each position computes its heads, its share of d_ff and, at
    vocab 256, of the vocab) against the reference's jitted step under
    its shardings: the loss, every leaf and every block, at the
    tolerances above."""
    api = _tp_api(tag)
    opt = make_optimizer(OPT)
    mesh = _mesh()
    step = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    assert (step.tp.heads, step.tp.mlp, step.tp.vocab) == \
        (True, True, tag == "v256")
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    state, metrics = step(_ref_state(ref, f"{tag}/{s}/in", opt, api),
                          data.batch(s))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref[f"{tag}/{s}/loss"]), rtol=LOSS_RTOL)
    for i, leaf in enumerate(tree_leaves(state)):
        _close(leaf.gather(), ref[f"{tag}/{s}/out/{i}"],
               f"{tag} step {s} leaf {i}")
    _check_blocks(state, mesh)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_tensor_parallel_step_on_masked_labels(ref, micro_batches):
    """The masked batch (its labels masked unevenly over the row blocks)
    at vocab 256 on a (2, 2) mesh, every region split over the model
    axis, against the reference's jitted step on the whole batch."""
    import dataclasses

    opt = make_optimizer(OPT)
    mesh = _mesh()
    api = p_registry.get_model(dataclasses.replace(
        _tp_api("v256").cfg, micro_batches=micro_batches))
    step = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    assert step.tp.vocab
    batch = _masked_batch(SyntheticLM(api.cfg.vocab_size, 16, 8).batch(0))
    state, metrics = step(_ref_state(ref, "v256/0/in", opt, api), batch)
    np.testing.assert_allclose(
        float(metrics["loss"]), float(ref[f"v256masked{micro_batches}/loss"]),
        rtol=LOSS_RTOL)
    for i, leaf in enumerate(tree_leaves(state)):
        _close(leaf.gather(), ref[f"v256masked{micro_batches}/out/{i}"],
               f"v256 masked m={micro_batches} leaf {i}")
    _check_blocks(state, mesh)


# the vlm with its patches on (2, 2); the MoE family on (1, 4), where the
# row block is the whole batch, so routing, capacity and the aux loss are
# the reference's; the regions each splits (heads, mlp, vocab, experts,
# ssm)
VLM_MOE = {"vlm": ("phi-3-vision-4.2b", (2, 2),
                   (True, True, True, False, False)),
           "moonshot": ("moonshot-v1-16b-a3b", (1, 4),
                        (True, False, True, True, False)),
           "arctic": ("arctic-480b", (1, 4),
                      (True, True, True, True, False))}


@functools.lru_cache(maxsize=None)
def _v256(arch, vocab=256):
    import dataclasses

    return p_registry.get_model(dataclasses.replace(
        p_registry.get(arch, smoke=True).cfg, vocab_size=vocab))


def _patched(api, batch, s):
    """The child's batch: a vlm model's patches (8, P, d_model) or an
    encdec model's frames (8, 16 / src_ratio, d_model), float32 from
    ``default_rng(s)``."""
    cfg = api.cfg
    if cfg.frontend == "vision":
        key, rows = "patches", cfg.frontend_tokens
    elif cfg.is_encdec:
        key, rows = "frames", max(1, 16 // cfg.src_ratio)
    else:
        return batch
    rng = np.random.default_rng(s)
    return dict(batch, **{key: rng.standard_normal(
        (8, rows, cfg.d_model)).astype(np.float32)})


@pytest.mark.parametrize("tag,s", [(t, s) for t in VLM_MOE
                                   for s in range(SC2_STEPS)])
def test_vlm_and_moe_tensor_parallel_steps_match_the_reference(ref, tag,
                                                               s):
    """phi-3-vision (with patches) on (2, 2), and moonshot and arctic
    (with its dense residual) on (1, 4), at vocab 256, tensor-parallel
    over the model axis, against the reference's jitted step under its
    shardings on the same mesh: the loss (the aux loss in it), every leaf
    and every block, at the tolerances above."""
    _family_step_matches_the_reference(ref, tag, s, *VLM_MOE[tag])


# mamba2 on (2, 2): its mixers (8 heads, 4 a member) and the vocab split;
# zamba2 on (1, 4): its mixers (2 heads a member), its shared block's
# heads and d_ff and the vocab; the regions each splits (heads, mlp,
# vocab, experts, ssm)
SSM_HYBRID = {"mamba2": ("mamba2-1.3b", (2, 2),
                         (False, False, True, False, True)),
              "zamba2": ("zamba2-2.7b", (1, 4),
                         (True, True, True, False, True))}


@pytest.mark.parametrize("tag,s", [(t, s) for t in SSM_HYBRID
                                   for s in range(SC2_STEPS)])
def test_ssm_and_hybrid_tensor_parallel_steps_match_the_reference(ref, tag,
                                                                  s):
    """mamba2 on (2, 2) and zamba2 on (1, 4) at vocab 256,
    tensor-parallel over the model axis, against the reference's jitted
    step under its shardings on the same mesh: the loss, every leaf, every
    block, and the model axis' replicas bit-equal (``_check_blocks``)."""
    _family_step_matches_the_reference(ref, tag, s, *SSM_HYBRID[tag])


# seamless-m4t-medium with its frames: on (2, 2) at vocab 256 (heads of
# every self- and cross-attention, both stacks' d_ff and the vocab
# split), on (1, 4) at vocab 258 (the vocab whole, as 256206 over 4 at
# full size); the regions each splits (heads, mlp, vocab, experts, ssm)
# and the vocab
ENCDEC = {"seamless": ((2, 2), (True, True, True, False, False), 256),
          "seamless258": ((1, 4), (True, True, False, False, False), 258)}
# the leaves' tolerance for this model and batch: its float32 gradient
# is ill-conditioned (the largest gaps fall on the encoder's leaves and
# enc_norm, which only the memory's gradient reaches), so float32
# implementations part by more than STATE_RTOL: the reference's own
# jitted step on one device and on the mesh by up to 6.4e-4 of a leaf's
# largest element, and each float32 step lies up to 8.1e-4 from the
# float64 value of the same step (``scripts/torch_f32_spread.py``)
ENCDEC_STATE_RTOL = 1e-3


@pytest.mark.parametrize("tag,s", [(t, s) for t in ENCDEC
                                   for s in range(SC2_STEPS)])
def test_encdec_tensor_parallel_step_matches_the_reference(ref, tag, s):
    """seamless-m4t-medium smoke with f32 frames, tensor-parallel over the
    model axis (the encoder's self-attention, the decoder's self- and
    cross-attention, both stacks' MLPs and, at vocab 256, the tied
    vocab), against the reference's jitted step under its shardings on
    the same mesh: the loss, every leaf (within ENCDEC_STATE_RTOL of its
    largest element), every block, and the model axis' replicas
    bit-equal (``_check_blocks``)."""
    shape, regions, vocab = ENCDEC[tag]
    _family_step_matches_the_reference(ref, tag, s, "seamless-m4t-medium",
                                       shape, regions, vocab,
                                       ENCDEC_STATE_RTOL)


def _family_step_matches_the_reference(ref, tag, s, arch, shape, regions,
                                       vocab=256, rtol=STATE_RTOL):
    api = _v256(arch, vocab)
    opt = make_optimizer(OPT)
    mesh = p_mesh.make_debug_mesh(*shape, device=CPU)
    step = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    tp = step.tp
    assert (tp.heads, tp.mlp, tp.vocab, tp.experts, tp.ssm) == regions
    batch = _patched(api, SyntheticLM(vocab, 16, 8).batch(s), s)
    state, metrics = step(_ref_state(ref, f"{tag}/{s}/in", opt, api), batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref[f"{tag}/{s}/loss"]), rtol=LOSS_RTOL)
    for i, leaf in enumerate(tree_leaves(state)):
        _close(leaf.gather(), ref[f"{tag}/{s}/out/{i}"],
               f"{tag} step {s} leaf {i}", rtol)
    _check_blocks(state, mesh)


@pytest.mark.parametrize("tag", ["moonshot", "arctic"])
def test_moe_tensor_parallel_step_matches_replicated_compute(tag):
    """On (2, 2) each row block routes its own rows (the documented
    divergence from the reference), so the MoE step tensor-parallel over
    the model axis is held to the same mesh's step under rules without
    ``model`` on heads, mlp, vocab and expert_mlp (every position computes
    the whole model): 2 steps, the loss, every leaf and every block."""
    arch = VLM_MOE[tag][0]
    api = _v256(arch)
    opt = make_optimizer(OPT)
    mesh = _mesh()
    tp = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    rules = dict(tp.rules, heads=None, mlp=None, vocab=None,
                 expert_mlp=None)
    whole = p_train.make_sharded_train_step(api, opt, constant(LR), mesh,
                                            rules)
    assert tp.tp.experts and whole.tp is None
    data = SyntheticLM(256, 16, 8)
    a = b = p_train.train_state(api, opt, torch.Generator().manual_seed(0),
                                device=CPU)
    for s in range(SC2_STEPS):
        a, ma = whole(a, data.batch(s))
        b, mb = tp(b, data.batch(s))
        np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                                   rtol=LOSS_RTOL)
        _check_blocks(b, mesh)
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        _close(y.gather(), x.gather(), f"{tag} leaf {i}")


def test_adafactor_updates_gathered_leaves_as_one_position():
    """Two Adafactor steps on the (2, 2) mesh, each side from its own
    state, against one position, in float64 (the model's param and
    compute dtypes; the optimizer computes in float32 whatever they are):
    in float32 the two trajectories part by rounding past the bound
    (3.8e-4 of the embedding's row moment's largest element after the
    second step) while each sharded step from the one-position state
    adds at most 5.5e-6: the params' gap after the first step (1.2e-6)
    grows about 200x in the next gradient of the seeded model
    (``scripts/torch_adafactor_spread.py``; 3.6e-5 in float64)."""
    import dataclasses

    api = p_registry.get_model(dataclasses.replace(
        _api().cfg, param_dtype="float64", compute_dtype="float64"))
    opt = make_optimizer("adafactor")
    mesh = _mesh()
    sharded = p_train.make_sharded_train_step(api, opt, constant(LR), mesh)
    plain = p_train.make_train_step(api, opt, constant(LR))
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    a = p_train.train_state(api, opt, torch.Generator().manual_seed(0),
                            device=CPU)
    b = a
    for s in range(2):
        a, ma = plain(a, data.batch(s))
        b, mb = sharded(b, data.batch(s))
        np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                                   rtol=LOSS_RTOL)
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        _close(y.gather(), x, f"adafactor leaf {i}")
    _check_blocks(b, mesh)


def _run(step, tmp=None, injector=None, **kw):
    api = _api()
    opt = make_optimizer("adamw")
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    return p_loop.run(
        step, lambda: p_train.train_state(
            api, opt, torch.Generator().manual_seed(0), device=CPU),
        data.batch, 4, ckpt_dir=tmp, ckpt_every=2,
        failure_injector=injector, device=CPU, **kw)


def test_loop_restores_onto_the_placements_bit_identical(tmp_path):
    step = p_train.make_sharded_train_step(
        _api(), make_optimizer("adamw"), constant(LR), _mesh())
    clean = _run(step, state_shardings=step.shardings)
    fired = []

    def injector(s):
        if s == 3 and not fired:
            fired.append(s)
            raise p_loop.NodeFailure("injected")

    crashed = _run(step, str(tmp_path), injector,
                   state_shardings=step.shardings)
    assert crashed.restarts == 1
    assert crashed.restore_splits[0]["step"] == 2
    for x, y in zip(tree_leaves(clean.state), tree_leaves(crashed.state)):
        assert torch.equal(x.gather(), y.gather())
    with pytest.raises(ValueError, match="exclusive"):
        _run(step, state_shardings=step.shardings,
             state_policy=p_train.state_transfer_policy())


def test_cli_production_mesh_on_cpu_positions(monkeypatch, tmp_path):
    made = []

    def debug_size(*, multi_pod=False, device=None):
        mesh = p_mesh.make_debug_mesh(2, 2, pod=2 if multi_pod else 0,
                                      device=device)
        made.append(mesh)
        return mesh

    monkeypatch.setattr(p_launch_train, "make_production_mesh", debug_size)
    res = p_launch_train.main(["--smoke", "--device", CPU, "--steps", "3",
                               "--batch", "8", "--seq", "16",
                               "--ckpt-dir", str(tmp_path),
                               "--ckpt-every", "2", "--production-mesh"])
    assert made and made[0].shape == {"data": 2, "model": 2}
    assert all(isinstance(x, PlacedTensor) for x in tree_leaves(res.state))
    assert all(np.isfinite(m["loss"]) for m in res.metrics_history)
    res = p_launch_train.main(["--smoke", "--device", CPU, "--steps", "1",
                               "--batch", "8", "--seq", "16",
                               "--production-mesh", "--multi-pod"])
    assert made[-1].shape == {"pod": 2, "data": 2, "model": 2}


def test_cli_production_mesh_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(UnsupportedSpecError, match="dp256"):
        p_launch_train.main(["--smoke", "--steps", "1",
                             "--production-mesh"])
    with pytest.raises(UnsupportedSpecError, match="dp512"):
        p_launch_train.main(["--smoke", "--steps", "1",
                             "--production-mesh", "--multi-pod"])


PLACED_ARCHS = ("llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b",
                "seamless-m4t-medium", "phi-3-vision-4.2b")


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placed_prefill_and_decode_equal_one_position(arch):
    """``runtime.placed.PlacedServe`` on a (2, 2) mesh (decode rules: the
    batch over data, the cache's sequence over model) against the model
    on one position: logits and every cache leaf within float32 noise
    (2e-5 absolute: other row counts' products, the model group's sums),
    the placed logits a value over the batch axes.  seamless-m4t-medium
    runs in float64: its smoke model is ill-conditioned in float32 (one
    float32 ulp of its params moves its one-position cache by 2.5e-4 to
    5e-4), so the group's sums, split over ``model`` since its placed
    serving is tensor-parallel, would move its cache past the bound."""
    import dataclasses

    from repro_torch.configs.base import InputShape
    from repro_torch.runtime.placed import PlacedServe

    api = p_registry.get(arch, smoke=True)
    if api.cfg.is_encdec:
        api = p_registry.get_model(dataclasses.replace(
            api.cfg, param_dtype="float64", compute_dtype="float64"))
    cfg = api.cfg
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    mesh = _mesh()
    B, S, M = 4, 8, 32
    serve = PlacedServe(api, mesh, p_mesh.adapt_batch_rule(
        p_mesh.rules_for(cfg, mesh, "decode"), mesh, B))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    extra = {k: torch.randn(sh, generator=g).to(dt) for k, (sh, dt) in
             api.inputs(InputShape("p", seq_len=S + P, global_batch=B,
                                   mode="prefill")).items()
             if k != "tokens"}
    if "frames" in extra:
        extra["frames"] = torch.randn(B, max(1, M // cfg.src_ratio),
                                      cfg.d_model, generator=g)
    cache = api.init_cache(B, M + P, device=CPU)
    want, want_c = api.prefill(params, tok, {k: v.clone() for k, v in
                                             cache.items()}, **extra)
    got, placed = serve.prefill(params, tok, serve.place_cache(cache),
                                **extra)
    assert got.placement.spec == ("data",)
    torch.testing.assert_close(got.gather(), want, rtol=0, atol=2e-5)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    want, want_c = api.decode_step(params, nxt, want_c)
    got, placed = serve.decode_step(params, nxt, placed)
    torch.testing.assert_close(got.gather(), want, rtol=0, atol=2e-5)
    for k, v in want_c.items():
        torch.testing.assert_close(placed[k].gather(), v, rtol=0, atol=2e-5)


def test_slot_prefill_fills_its_row_as_a_batch_one_prefill():
    """Prompts of different lengths, each prefilled into its row of a
    placed 4-slot cache (only the row's holders compute), equal batch-1
    prefills stacked into the slots: bit for bit the same mesh's placed
    batch-1 prefills (the heads and d_ff split over ``model``, so the
    members' partial sums add in the group's order), within float32 noise
    those of one position; a decode step over the slots equals one
    position's."""
    from repro_torch.runtime.placed import PlacedServe

    api = _api()
    cfg = api.cfg
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    mesh = _mesh()
    serve = PlacedServe(api, mesh, p_mesh.adapt_batch_rule(
        p_mesh.rules_for(cfg, mesh, "decode"), mesh, 4))
    one = PlacedServe(api, mesh, p_mesh.adapt_batch_rule(
        p_mesh.rules_for(cfg, mesh, "decode"), mesh, 1))
    assert serve.plan is not None and serve.plan.heads
    placed = serve.place_cache(api.init_cache(4, 32, device=CPU))
    g = torch.Generator().manual_seed(2)
    caches, placed_rows = [], []
    for r, n in enumerate((3, 7, 5, 9)):
        tok = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
        want, c = api.prefill(params, tok, api.init_cache(1, 32, device=CPU))
        got, placed = serve.prefill(params, tok, placed, slot=r)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        caches.append(c)
        got1, c1 = one.prefill(params, tok, one.place_cache(
            api.init_cache(1, 32, device=CPU)))
        torch.testing.assert_close(got, got1.gather(), rtol=0, atol=0)
        placed_rows.append({k: v.gather() for k, v in c1.items()})
    def stacked(rows):
        return {k: torch.cat([c[k] for c in rows], dim=0 if k == "pos"
                             else 1) for k in rows[0]}

    ref = stacked(caches)
    for rows, atol in ((stacked(placed_rows), 0), (ref, 2e-5)):
        for k, v in rows.items():
            torch.testing.assert_close(placed[k].gather(), v, rtol=0,
                                       atol=atol)
    nxt = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
    want, _ = api.decode_step(params, nxt, ref)
    got, _ = serve.decode_step(params, nxt, placed)
    torch.testing.assert_close(got.gather(), want, rtol=0, atol=2e-5)
