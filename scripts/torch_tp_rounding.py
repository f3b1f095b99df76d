#!/usr/bin/env python3
"""Where the tensor-parallel production-mesh step's bf16 loss parts from
one position's: ``chip_smoke.py`` phase 20 (a)'s masked step (llama3.2-1b
at full width, seeded random weights, batch 8 x 128 with labels masked
unevenly over the row blocks, a (2, 2) mesh on one card), at 2, 4, 6 and
8 layers.

Each line holds the masked mean cross-entropy of the same params and
batch:

  * ``one_bf16``, ``one_f32``: one position (``loss_fn``) in bf16, and in
    f32 on the bf16 params cast up;
  * ``tp_bf16``: the sharded step (``make_sharded_train_step``) in bf16,
    where each member rounds its partial output of the attention's ``wo``
    and of the MLP's ``w_down`` to bf16 before the group sums them, as a
    bf16 all-reduce of GSPMD's does;
  * ``tp_bf16_f32_partials``: the same step with those two products kept
    in f32, summed in f32 and rounded once to bf16 after the sum, as one
    position rounds the whole product once (``tp.leave`` and the two
    partial sublayers patched for this reading only);
  * ``tp_f32``: the sharded step in f32 on the cast params;
  * ``f32_one_ulp``: one position in f32 with the params moved one ulp up
    (half of the elements, three seeds), less ``one_f32``: how far any
    rounding moves this model's loss at this depth.

Usage (from the repository root, on the card):

    python3 scripts/torch_tp_rounding.py

Prints the card's name and power limit, then one JSON line a depth.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DEPTHS = (2, 4, 6, 8)


@contextlib.contextmanager
def f32_partials():
    """The tensor-parallel block's row-parallel products in f32, summed
    in f32 and rounded once to bf16 after the sum."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import tp as TP

    attention, mlp = L.multihead_attention, L.apply_mlp

    def leave(ctx, group, *xs):
        out = group.psum(list(xs))
        # the regions' (B, S, D) sums; the cross-entropy's stay f32
        return tuple(o.to(torch.bfloat16) if o.dim() == 3 else o
                     for o in out)

    def member_attention(cfg, p, x, *, positions, heads=None, **kw):
        if heads is None:
            return attention(cfg, p, x, positions=positions, **kw)
        B, S, _ = x.shape
        q, k, v = L._local_qkv(cfg, p, x, positions, heads)
        ctx = L.mha(q, k, v, causal=True,
                    q_offset=positions.expand(B, S)[:, 0])
        ctx = ctx.reshape(B, S, -1).float()
        return ctx @ p["wo"].float().reshape(ctx.shape[-1], -1), None

    def member_mlp(cfg, p, x, partial=False):
        if not partial:
            return mlp(cfg, p, x)
        gate = F.silu(x @ p["w_gate"].to(x.dtype))
        return (gate * (x @ p["w_up"].to(x.dtype))).float() \
            @ p["w_down"].float()

    with mock.patch.object(TP._Leave, "forward", staticmethod(leave)), \
            mock.patch.object(L, "multihead_attention", member_attention), \
            mock.patch.object(L, "apply_mlp", member_mlp):
        yield


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tp_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mesh = C._dp_mesh(C.LAUNCH_MESH)
    dev = mesh.positions[0]
    base = registry.get("llama3.2-1b").cfg
    data = SyntheticLM(base.vocab_size, C.LAUNCH_SEQ, C.LAUNCH_BATCH)
    masked = C.masked_batch(data.batch(0), mesh.shape["data"])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in masked.items()}
    opt = make_optimizer("sgdm")

    def step_loss(api, params):
        step = train.make_sharded_train_step(api, opt, constant(0.0), mesh)
        if step.tp is None or not (step.tp.heads and step.tp.mlp
                                   and step.tp.vocab):
            raise SystemExit(f"the step does not split: {step.tp}")
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return float(step(step.place(state), masked)[1]["loss"])

    def one_ulp(p, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        up = torch.rand(p.shape, generator=g, device=dev) < 0.5
        return torch.where(up, torch.nextafter(p, p + 1), p)

    for layers in DEPTHS:
        cfg = dataclasses.replace(base, num_layers=layers)
        api = registry.get_model(cfg)
        api32 = registry.get_model(dataclasses.replace(
            cfg, param_dtype="float32", compute_dtype="float32"))
        p16 = api.init(torch.Generator(device=dev).manual_seed(0),
                       device=dev)
        p32 = tree_map(lambda x: x.float(), p16)
        with torch.no_grad():
            one16 = float(api.loss_fn(p16, batch)[1]["loss"])
            one32 = float(api32.loss_fn(p32, batch)[1]["loss"])
            moved = [float(api32.loss_fn(tree_map(
                lambda x: one_ulp(x, s), p32), batch)[1]["loss"]) - one32
                for s in (1, 2, 3)]
        tp16 = step_loss(api, p16)
        with f32_partials():
            tp16_f32 = step_loss(api, p16)
        tp32 = step_loss(api32, p32)
        print(json.dumps({"layers": layers, "one_bf16": one16,
                          "one_f32": one32, "tp_bf16": tp16,
                          "tp_bf16_f32_partials": tp16_f32,
                          "tp_f32": tp32, "f32_one_ulp": moved}),
              flush=True)
        del p16, p32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
