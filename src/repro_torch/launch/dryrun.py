"""Production-mesh dry run: trace every (arch x shape x mesh) cell on meta
positions, the port's counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out artifacts/dryrun_torch

No card is needed: the mesh is ``make_production_mesh(device="meta")``,
256 or 512 meta positions (shapes without data).  Per cell:

  * the abstract arguments (the train state and batch; the params, cache
    and inputs of a prefill or decode) are placed by ``tree_shardings``;
    ``memory.argument_size_in_bytes`` is the bytes one position holds of
    them, from the placements (blocks are even, so every position holds
    the same), exact;
  * one position's step runs on meta tensors under the op counter
    (``hlo_analysis.OpCounter``): the sharded train step
    (``ShardedTrainStep.trace``) or the placed prefill / decode
    (``runtime.placed.PlacedServe``, ``traced=True``), while the step's
    gathers and sums run over every meta position with
    ``core.collectives``, whose deltas give ``collectives``.  ``flops``
    and ``bytes_accessed`` are that position's dispatched aten ops
    (``torch.utils.flop_counter``'s formulas; each op's inputs and outputs
    once).  A train step is tensor-parallel over the model axis where the
    placements split heads, d_ff, the experts' d_ff, the Mamba2 mixers'
    heads or vocab (``models/tp.py``), and so are every family's placed
    prefill and decode, the encoder-decoder's included: position 0
    computes its blocks with its model group's other members standing in
    (its tensors in their slots of the group's ``psum`` / ``pmax`` and of
    the decode's kv exchange, which count in ``collectives``);
  * the whole step (the gathers and sums too) runs under the memory
    counter (``hlo_analysis.MemoryCounter``), which books each storage
    an op creates while it lives; a kernel is booked at what it
    allocates on the card, not at its plain version's temporaries
    (``repro_torch._counting``), and a collective's result once, for
    position 0.  ``memory`` gives the reference's ``memory_analysis``
    keys but ``generated_code_size_in_bytes`` (no program is compiled):
    ``argument_size_in_bytes``; ``output_size_in_bytes``, the distinct
    storages of position 0's outputs (a train step's blocks of the new
    state and its metrics; a serve step's logits and cache blocks);
    ``alias_size_in_bytes``, those that are arguments' storages (the k /
    v cache, written in place, and a decode's encoder memory; the
    functional train step aliases nothing, where the reference donates
    its state, ``donate_argnums=(0,)``); ``peak_memory_in_bytes``, the
    arguments plus the largest live sum of the storages the step
    allocates; ``temp_size_in_bytes``, peak less arguments less outputs
    plus aliases.  These are the eager schedule's bytes as a caching
    allocator would hold them (``chip_smoke.py`` phase 20 (e) holds them
    against the card's), not what a compiler would plan;
  * ``bodies`` are ``probe.layer_bodies`` (at the tensor-parallel widths
    where the step splits, a serve body with the member's blocks of the
    cache); eager PyTorch counts every layer trip, so
    ``corrected`` is the raw count, and ``probe_check`` holds the step's
    FLOPs against the sum of trips times each body's plus the FLOPs of
    the same step with the layers removed;
  * ``gathered_param_bytes`` is the params one position gathers for its
    step, train or serve: a tensor-parallel step's blocks of the split
    leaves (whole over the data axes) and the other leaves whole;
    elsewhere the whole params;
  * ``trace_s`` stands where the reference reports ``lower_s`` and
    ``compile_s``.

These are counts on the host that runs the dry run, not measurements of
any device.  Each cell prints ``[dryrun] arch|shape|mesh: status`` (an ok
cell's trace time and memory keys), the run ``[dryrun] N/M cells ok``, and
it exits 1 if a cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.core.placement import place_tree, position_bytes
from repro_torch.core.treepath import tree_leaves
from repro_torch.launch import hlo_analysis, probe
from repro_torch.launch.mesh import (adapt_batch_rule, make_production_mesh,
                                     rules_for, tree_shardings)
from repro_torch.models import registry
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime.placed import PlacedServe
from repro_torch.runtime.train import (ShardedTrainStep, abstract_train_state)

META = torch.device("meta")


def _meta_inputs(specs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META)
            for k, v in specs.items()}


def _placed_bytes(tree: Any, shardings: Any) -> int:
    return position_bytes([(tuple(v.shape), v.dtype, pl) for v, pl in
                           zip(tree_leaves(tree), tree_leaves(shardings))])


def _blocks(tree: Any) -> list:
    """Every tensor of a tree of placed leaves: each position's blocks."""
    return [b for leaf in tree_leaves(tree) for b in leaf.blocks]


def trace_step(api, shape, mesh, rules, granule: int = 1
               ) -> Dict[str, Any]:
    """One position's step of ``api`` at ``shape`` on ``mesh``: its op
    counter, the collectives' stats, the arguments' bytes a position and
    the step's :class:`~repro_torch.launch.hlo_analysis.StepMemory`,
    each storage rounded up to ``granule`` bytes (the placed arguments
    are made before the memory counter is entered, so they are not
    booked)."""
    mode = shape.mode
    counter = hlo_analysis.OpCounter()
    memory = hlo_analysis.MemoryCounter(granule)
    count = lambda: counter
    specs = api.input_specs(shape)
    in_bytes = _placed_bytes(specs, tree_shardings(
        mesh, api.input_axes(shape), rules, specs))
    inputs = _meta_inputs(specs)
    before = hlo_analysis.stats_snapshot()
    if mode == "train":
        opt = make_optimizer(api.cfg.optimizer)
        step = ShardedTrainStep(api, opt, warmup_cosine(3e-4, 100, 10_000),
                                mesh, rules)
        state_abs = abstract_train_state(api, opt)
        arg_bytes = _placed_bytes(state_abs, step.shardings) + in_bytes
        gathered = step.gathered_param_bytes()
        state = place_tree(state_abs, step.shardings)
        arguments = (_blocks(state), inputs)
        with memory:
            outputs = step.trace(state, inputs, count)
    else:
        serve = PlacedServe(api, mesh, rules)
        cache_abs = api.abstract_cache(shape)
        cache_sh = tree_shardings(mesh, api.cache_axes(shape), rules,
                                  cache_abs)
        params_abs = api.abstract()
        gathered = serve.gathered_param_bytes()
        arg_bytes = (_placed_bytes(params_abs, serve.param_shardings)
                     + _placed_bytes(cache_abs, cache_sh) + in_bytes)
        params = place_tree(params_abs, serve.param_shardings)
        cache = place_tree(cache_abs, cache_sh)
        arguments = (_blocks(params), _blocks(cache), inputs)
        tokens = inputs.pop("tokens")
        with memory:
            if mode == "prefill":
                outputs = serve.prefill(params, tokens, cache, traced=True,
                                        count=count, **inputs)
            else:
                outputs = serve.decode_step(params, tokens, cache,
                                            traced=True, count=count)
    return {"counter": counter,
            "collectives": hlo_analysis.collective_stats(before),
            "argument_bytes": arg_bytes, "gathered_param_bytes": gathered,
            "memory": hlo_analysis.step_memory(memory, outputs, arguments)}


def lower_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
               layer_probe: bool = True) -> Dict[str, Any]:
    """Trace one (arch, shape) on ``mesh``; return the analysis dict."""
    api = registry.get(arch, smoke=smoke)
    cfg = api.cfg
    shape = SHAPES[shape_name]
    if smoke:
        shape = shape.smoke()
    reason = skip_reason(cfg, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    mode = shape.mode
    rules = adapt_batch_rule(rules_for(cfg, mesh, mode), mesh,
                             shape.global_batch)
    t0 = time.perf_counter()
    traced = trace_step(api, shape, mesh, rules)
    t_trace = time.perf_counter() - t0
    counter = traced["counter"]
    result = {
        "arch": arch, "shape": shape_name, "mode": mode,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "mesh_axes": list(mesh.axis_names),
        "devices": mesh.size,
        "trace_s": round(t_trace, 2),
        "flops": float(counter.total_flops),
        "bytes_accessed": float(counter.total_bytes),
        "memory": hlo_analysis.memory_dict(traced["argument_bytes"],
                                           traced["memory"]),
        # what a position holds once its step has gathered the params: a
        # tensor-parallel step's (train, prefill or decode) blocks of the
        # leaves it splits over the model axis, whole over the data axes,
        # and the other leaves whole; a replicated one's, the whole params
        "gathered_param_bytes": traced["gathered_param_bytes"],
        "collectives": traced["collectives"],
        "census": hlo_analysis.op_census(counter),
        "bodies": [],
    }
    if layer_probe:
        bodies = probe.layer_bodies(api, shape, mesh, rules)
        free_flops = probe.layer_free_flops(api, shape, mesh, rules)
        body_flops = sum(b["trips"] * b["flops"] for b in bodies)
        result["bodies"] = bodies
        result["probe_check"] = {
            "step_flops": result["flops"], "layer_free_flops":
            float(free_flops), "bodies_flops": float(body_flops),
            "exact": result["flops"] == free_flops + body_flops}
    # every layer trip is already in the raw count (eager dispatch)
    result["corrected"] = probe.corrected_terms(result, [])
    return result


def _memory_line(memory: Dict[str, int]) -> str:
    """A cell's memory keys, short: ``argument 10, ..., peak 30 B a
    position``."""
    return ", ".join(f"{k.split('_')[0]} {v}" for k, v in memory.items()) \
        + " B a position"


def run_grid(archs, shapes, meshes, out_dir: Optional[str], smoke: bool):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results = []
    for mesh_name in meshes:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                    device="meta")
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}|{shape_name}|{mesh_name}"
                try:
                    res = lower_cell(arch, shape_name, mesh, smoke=smoke)
                    res["mesh_name"] = mesh_name
                    status = ("SKIP: " + res["skipped"]) if "skipped" in res \
                        else f"ok ({res['trace_s']:.1f}s trace; " \
                        f"{_memory_line(res['memory'])})"
                except Exception as e:  # noqa: BLE001 - report and continue
                    res = {"arch": arch, "shape": shape_name,
                           "mesh_name": mesh_name, "error": str(e),
                           "traceback": traceback.format_exc()}
                    status = f"ERROR: {e}"
                print(f"[dryrun] {tag}: {status}", flush=True)
                results.append(res)
                if out_dir:
                    fname = f"{arch}_{shape_name}_{mesh_name}.json".replace(
                        "/", "_")
                    with open(os.path.join(out_dir, fname), "w") as f:
                        json.dump(res, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI of the dry-run itself)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(registry.ARCH_IDS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = run_grid(archs, shapes, meshes, args.out, args.smoke)
    bad = [r for r in results if "error" in r]
    print(f"[dryrun] {len(results) - len(bad)}/{len(results)} cells ok")
    if bad:
        for r in bad:
            print(f"  FAILED {r['arch']}|{r['shape']}|{r['mesh_name']}: "
                  f"{r['error'][:200]}")
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
