#!/usr/bin/env python3
"""Where the production-mesh Adafactor step parts from the one-position
step, on the CPU: the grounds of
``tests/test_torch_sharded_train.py::test_adafactor_updates_gathered_leaves_as_one_position``.

llama3.2-1b smoke, ``constant(1e-3)``, ``SyntheticLM(vocab, 16, 8)``, the
seeded state of that test, ``ShardedTrainStep`` on a (2, 2) mesh of CPU
positions (heads and d_ff split over ``model``) against
``make_train_step`` on one position, under deterministic algorithms.
Every gap is the largest |sharded - one position| of a leaf of the train
state over that leaf's largest element (the test's bound is 1e-6 + 2e-4
of it).  One JSON line a run:

  * ``trajectory``: each side steps from its own state (the test), the
    worst leaf after each step;
  * ``restart``: each step of the sharded side from the one-position
    state before it, as the module's other tests step: what the step
    itself adds;
  * ``params_after_step0`` and ``next_gradient``: the params' gap after
    the first step, and the gap between the second step's gradients
    taken on one position from the two sides' params (the seeded model's
    amplification of a gap in its params);
  * runs: Adafactor in float32 and in float64 (the model's param and
    compute dtypes), float64 with the optimizer's arithmetic in float64
    too (``optim.optimizers.F32`` patched: its moments and its update
    are float32 whatever the param dtype), and AdamW's first step in
    float32 and float64.

Usage (from the repository root, on the CPU; about 10 s):

    PYTHONPATH=src python3 scripts/torch_adafactor_spread.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.treepath import tree_flatten_with_path  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import mesh as p_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.runtime import train  # noqa: E402


def gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


def worst(a, b) -> dict:
    """The worst leaf gap of the gathered state ``b`` to ``a``."""
    paths = ["/".join(map(str, p)) for p, _ in tree_flatten_with_path(a)]
    g, path = max((gap(y, x), p) for p, x, y in
                  zip(paths, tree_leaves(a), tree_leaves(b)))
    return {"gap": g, "leaf": path}


def run(opt_name: str, dtype: str, steps: int) -> dict:
    api = registry.get("llama3.2-1b", smoke=True)
    if dtype != "float32":
        api = registry.get_model(dataclasses.replace(
            api.cfg, param_dtype=dtype, compute_dtype=dtype))
    opt = make_optimizer(opt_name)
    mesh = p_mesh.make_debug_mesh(2, 2, device="cpu")
    sharded = train.make_sharded_train_step(api, opt, constant(1e-3), mesh)
    plain = train.make_train_step(api, opt, constant(1e-3))
    data = SyntheticLM(api.cfg.vocab_size, 16, 8)
    gather = lambda s: tree_map(lambda x: x.gather(), s)
    a = train.train_state(api, opt, torch.Generator().manual_seed(0),
                          device="cpu")
    b = a
    out = {"optimizer": opt_name, "dtype": dtype, "trajectory": [],
           "restart": []}
    for s in range(steps):
        a_next, _ = plain(a, data.batch(s))
        b, _ = sharded(b, data.batch(s))
        r, _ = sharded(a, data.batch(s))
        out["trajectory"].append(worst(a_next, gather(b)))
        out["restart"].append(worst(a_next, gather(r)))
        if s == 0 and steps > 1:
            pa, pb = a_next["params"], gather(b)["params"]
            out["params_after_step0"] = worst(pa, pb)
            batch = {k: torch.as_tensor(v) for k, v in data.batch(1).items()}
            ga = train.value_and_grad(api.loss_fn, pa, batch)[2]
            gb = train.value_and_grad(api.loss_fn, pb, batch)[2]
            out["next_gradient"] = worst(ga, gb)
        a = a_next
    return out


def main() -> None:
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(2)
    for opt_name, dtype, steps in (("adafactor", "float32", 2),
                                   ("adafactor", "float64", 2)):
        print(json.dumps(run(opt_name, dtype, steps)), flush=True)
    with mock.patch.object(optimizers, "F32", torch.float64):
        res = run("adafactor", "float64", 2)
    res["optimizer_dtype"] = "float64"
    print(json.dumps(res), flush=True)
    for dtype in ("float32", "float64"):
        print(json.dumps(run("adamw", dtype, 1)), flush=True)


if __name__ == "__main__":
    main()
