#!/usr/bin/env python3
"""How far float32 implementations of the production-mesh train step part
from each other, on the CPU, against the JAX package's jitted step: the
grounds of the tolerances of ``tests/test_torch_sharded_train.py``'s
masked-then-plain and encoder-decoder tests.

The reference's steps come from that module's child (its forced
4-device host, ``reference_sharded_steps``); the reference's one-device
steps are jitted here, on this process's one CPU device.  Every gap is
the largest |a - b| of any leaf of the train state (params and the
SGD-momentum state) over that leaf's largest element in b, less the
tests' 1e-6 absolute floor.  Two JSON lines:

  * ``"f6"``: llama3.2-1b smoke at vocab 256 on a (2, 2) mesh, three
    steps from the seeded state, the plain batches 0, 1, 2 (``plain``)
    or the masked batch 0 then the plain 1, 2 (``masked``), at
    ``micro_batches`` 1 (``masked`` also at 2).  Per step, to the
    reference's (2, 2) steps: the port's sharded step from the
    reference's state before it (``port_restart``), the port's own
    trajectory (``port_trajectory``) and the reference's own trajectory
    jitted on one device (``reference_one_device``);
  * ``"encdec"``: seamless-m4t-medium smoke with its frames, on (2, 2) at
    vocab 256 and on (1, 4) at vocab 258, each of 2 steps from the
    reference's state before it: to the reference's mesh step, the
    port's tensor-parallel step (``port_tp``), its replicated step on the
    same mesh (``port_replicated``), the port's one-position step
    (``port_one``) and the reference's one-device step
    (``reference_one_device``); ``port_tp_vs_replicated``; and, for the
    momentum alone (less 0.9 x its input: the step's gradient), each
    float32 one's gap to the float64 gradient of the same step computed
    by the port's model with its float32 casts patched out (the norms,
    rope, the attention's plain version, the head and the
    cross-entropy): ``f64_*``.

Usage (from the repository root, on the CPU; about 4 minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/torch_f32_spread.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_sharded_train as T  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.optim import constant as r_constant  # noqa: E402
from repro.optim import make_optimizer as r_make_optimizer  # noqa: E402
from repro.runtime.train import \
    make_train_step as r_make_train_step  # noqa: E402
from repro.runtime.train import train_state as r_train_state  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.core import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.core.placement import PlacedTensor  # noqa: E402
from repro_torch.core.treepath import tree_flatten_with_path  # noqa: E402

STEPS = 3


def gap(got, want) -> float:
    """The largest leaf gap of ``got`` to ``want`` (numpy leaves)."""
    out = 0.0
    for a, b in zip(got, want):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        top = float(np.abs(b).max(initial=0.0))
        err = float(np.abs(a - b).max(initial=0.0)) - T.ATOL
        out = max(out, err / top if top else 0.0)
    return out


def np_leaves(state):
    return [(x.gather() if isinstance(x, PlacedTensor) else x).float()
            .numpy() for x in tree_leaves(state)]


def reference_step(arch, vocab, micro_batches=1):
    """The reference's step jitted on one device, and a function that
    makes its state from numpy leaves."""
    api = r_registry.get_model(dataclasses.replace(
        r_registry.get(arch, smoke=True).cfg, vocab_size=vocab,
        micro_batches=micro_batches))
    opt = r_make_optimizer(T.OPT)
    step = jax.jit(r_make_train_step(api, opt, r_constant(T.LR)))
    treedef = jax.tree_util.tree_structure(
        r_train_state(api, opt, jax.random.PRNGKey(0)))

    def call(state, batch):
        return step(state, {k: jnp.asarray(v, jnp.float32 if k == "frames"
                                           else jnp.int32)
                            for k, v in batch.items()})
    return call, lambda leaves: jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in leaves])


def ref_leaves(ref, key, n):
    return [ref[f"{key}/{i}"] for i in range(n)]


def f6(ref):
    out = {}
    opt = T.make_optimizer(T.OPT)
    mesh = T.p_mesh.make_debug_mesh(2, 2, device=T.CPU)
    for case, m in (("plain", 1), ("masked", 1), ("masked", 2)):
        api = T.p_registry.get_model(dataclasses.replace(
            T._tp_api("v256").cfg, micro_batches=m))
        step = T.p_train.make_sharded_train_step(api, opt, T.constant(T.LR),
                                                 mesh)
        r_step, r_state_of = reference_step("llama3.2-1b", 256, m)
        n = len(tree_leaves(T.p_train.abstract_train_state(api, opt)))
        data = T.SyntheticLM(256, 16, 8)
        r_state = r_state_of(ref_leaves(ref, "v256/0/in", n))
        own = T._ref_state(ref, "v256/0/in", opt, api)
        rows, before = [], "v256/0/in"
        for j in range(STEPS):
            masked = case == "masked" and j == 0
            batch = T._masked_batch(data.batch(0)) if masked \
                else data.batch(j)
            key = (f"v256masked{m}" + (f"/plain{j}" if j else "")
                   if case == "masked" else f"v256/{j}")
            want = ref_leaves(ref, f"{key}/out", n)
            restart, _ = step(T._ref_state(ref, before, opt, api), batch)
            own, _ = step(own, batch)
            r_state, _ = r_step(r_state, batch)
            rows.append({"port_restart": gap(np_leaves(restart), want),
                         "port_trajectory": gap(np_leaves(own), want),
                         "reference_one_device": gap(
                             [np.asarray(x) for x in
                              jax.tree_util.tree_leaves(r_state)], want)})
            before = f"{key}/out"
        out[f"{case}_mb{m}"] = rows
    return out


@contextlib.contextmanager
def float64_model():
    """The port's model computing in its parameters' dtype: the float32
    casts of the norms, rope, the attention's plain version, the head and
    the cross-entropy patched out (for this reading only)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import encdec, layers as L

    attention = flash_ref.attention_ref

    def attention_ref(q, k, v, **kw):
        with mock.patch.object(torch.Tensor, "float", lambda t: t):
            return attention(q, k, v, **kw)

    def apply_norm(cfg, p, x):
        return F.layer_norm(x, x.shape[-1:], p["scale"].to(x.dtype),
                            p["bias"].to(x.dtype), eps=1e-5)

    def rope(x, positions, theta):
        half = x.shape[-1] // 2
        freqs = theta ** (-torch.arange(half, dtype=x.dtype) / half)
        ang = positions[..., None].to(x.dtype) * freqs
        sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def unembed(cfg, p, x):
        return x @ (p["tok"].T if cfg.tie_embeddings else p["lm_head"])

    def cross_entropy(logits, labels):
        labels = labels.to(torch.long)
        mask = (labels >= 0).to(logits.dtype)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        return (torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0),
                torch.sum(mask))

    with mock.patch.object(flash_ref, "attention_ref", attention_ref), \
            mock.patch.object(L, "apply_norm", apply_norm), \
            mock.patch.object(L, "rope", rope), \
            mock.patch.object(L, "unembed", unembed), \
            mock.patch.object(encdec, "cross_entropy", cross_entropy):
        yield


def gradient(api, params, batch):
    leaves, treedef = tree_flatten(params)
    xs = [v.detach().clone().requires_grad_() for v in leaves]
    loss, _ = api.loss_fn(treedef.unflatten(xs), batch)
    return [g.detach() for g in torch.autograd.grad(loss, xs)]


def encdec(ref):
    out = {}
    opt = T.make_optimizer(T.OPT)
    for tag, (shape, _, vocab) in T.ENCDEC.items():
        api = T._v256("seamless-m4t-medium", vocab)
        api64 = T.p_registry.get_model(dataclasses.replace(
            api.cfg, param_dtype="float64", compute_dtype="float64"))
        mesh = T.p_mesh.make_debug_mesh(*shape, device=T.CPU)
        tp = T.p_train.make_sharded_train_step(api, opt, T.constant(T.LR),
                                               mesh)
        whole = T.p_train.make_sharded_train_step(
            api, opt, T.constant(T.LR), mesh,
            dict(tp.rules, heads=None, mlp=None, vocab=None))
        one = T.p_train.make_train_step(api, opt, T.constant(T.LR))
        r_step, r_state_of = reference_step("seamless-m4t-medium", vocab)
        template = T.p_train.abstract_train_state(api, opt)
        t_leaves, t_def = tree_flatten(template)
        n = len(t_leaves)
        mu = [i for i, (p, _) in enumerate(tree_flatten_with_path(template))
              if p[:2] == ("opt", "mu")]
        rows = []
        for s in range(T.SC2_STEPS):
            batch = T._patched(api, T.SyntheticLM(vocab, 16, 8).batch(s), s)
            tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
            before = ref_leaves(ref, f"{tag}/{s}/in", n)
            want = ref_leaves(ref, f"{tag}/{s}/out", n)
            state = T._ref_state(ref, f"{tag}/{s}/in", opt, api)
            got_tp = np_leaves(tp(state, batch)[0])
            got_whole = np_leaves(whole(state, batch)[0])
            plain = train_state_from_reference(t_def.unflatten(before), T.CPU)
            got_one = np_leaves(one(plain, tbatch)[0])
            r_out, _ = r_step(r_state_of(before), batch)
            got_r1 = [np.asarray(x) for x in jax.tree_util.tree_leaves(r_out)]
            params64 = t_def.unflatten([torch.as_tensor(x).double()
                                        for x in before])["params"]
            batch64 = dict(tbatch, frames=tbatch["frames"].double())
            with float64_model():
                g64 = [g.numpy() for g in gradient(api64, params64, batch64)]

            def grads(leaves):
                return [leaves[i] - 0.9 * before[i] for i in mu]

            rows.append({
                "port_tp": gap(got_tp, want),
                "port_replicated": gap(got_whole, want),
                "port_one": gap(got_one, want),
                "reference_one_device": gap(got_r1, want),
                "port_tp_vs_replicated": gap(got_tp, got_whole),
                "f64_reference_mesh": gap(grads(want), g64),
                "f64_reference_one_device": gap(grads(got_r1), g64),
                "f64_port_tp": gap(grads(got_tp), g64),
                "f64_port_one": gap(grads(got_one), g64)})
        out[tag] = rows
    return out


def main():
    torch.use_deterministic_algorithms(True)
    with tempfile.TemporaryDirectory() as tmp:
        ref = T.reference_sharded_steps(str(Path(tmp) / "ref.npz"))
    print(json.dumps({"f6": f6(ref)}), flush=True)
    print(json.dumps({"encdec": encdec(ref)}), flush=True)


if __name__ == "__main__":
    main()
