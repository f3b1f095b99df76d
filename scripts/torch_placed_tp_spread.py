#!/usr/bin/env python3
"""Where tensor-parallel placed serving parts from one position's:
``chip_smoke.py`` phase 20 (c)'s first request (full width, seeded random
weights, phase 8's first prompt prefilled into slot 0 of an 8 x 2048
cache placed under the decode rules on one card's positions), by depth:
llama3.2-1b on (2, 2) at 1, 2, 4, 8 and 16 layers, zamba2-2.7b on (1, 4)
at 1 and 2, seamless-m4t-medium on (2, 2) at 1 + 1 and 2 + 2 (encoder +
decoder layers; the prompt with SERVE_MAX_SEQ / src_ratio frames drawn
from seed 19, in each run's compute dtype).

Each line holds, for the same params and prompt, the largest |difference|
between the last-token logits (and each cache leaf of the slot's row) of:

  * ``one_bf16``, ``one_f32``: one position (``api.prefill``) in bf16,
    and in f32 on the bf16 params cast up;
  * ``tp_bf16``, ``tp_f32``: the placed prefill (``PlacedServe``, each
    model group tensor-parallel over ``model``) in bf16 and in f32;
  * ``f32_one_ulp``: one position in f32 with the params moved one ulp
    up (half of the elements, three seeds): how far any rounding moves
    this model's values at this depth;

and the largest |value| of ``one_f32``, how many of the bf16 placed
values fall outside ``allclose(rtol=2e-2, atol=2e-2)`` of one
position's, and whether the greedy tokens agree.

Usage (from the repository root, on the card):

    python3 scripts/torch_placed_tp_spread.py \
        [--arch llama3.2-1b|zamba2-2.7b|seamless-m4t-medium]

Prints the card's name and power limit, then one JSON line a depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = {"llama3.2-1b": ((2, 2), (1, 2, 4, 8, 16)),
         "zamba2-2.7b": ((1, 4), (1, 2)),
         "seamless-m4t-medium": ((2, 2), (1, 2))}
TOL = 2e-2


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(CASES), action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_placed_tp_spread: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core import tree_map
    from repro_torch.launch.mesh import adapt_batch_rule, rules_for
    from repro_torch.models import registry
    from repro_torch.runtime.placed import PlacedServe

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    slots = C.LAUNCH_PROMPTS

    def extra(cfg, frames):
        return {"frames": frames.to(getattr(torch, cfg.compute_dtype))} \
            if frames is not None else {}

    def one(api, params, tok, dev, frames=None):
        logits, cache = api.prefill(params, tok, api.init_cache(
            1, C.SERVE_MAX_SEQ, device=dev), **extra(api.cfg, frames))
        return dict({k: v.float() for k, v in cache.items() if k != "pos"},
                    logits=logits.float())

    def placed(api, params, tok, mesh, dev, frames=None):
        serve = PlacedServe(api, mesh, adapt_batch_rule(
            rules_for(api.cfg, mesh, "decode"), mesh, slots))
        if serve.plan is None or not serve.plan.heads:
            raise SystemExit(f"the serve plan does not split: {serve.plan}")
        cache = serve.place_cache(api.init_cache(slots, C.SERVE_MAX_SEQ,
                                                 device=dev))
        logits, cache = serve.prefill(serve.place_params(params), tok,
                                      cache, slot=0,
                                      **extra(api.cfg, frames))
        return dict({k: v.gather(dev).narrow(0 if k == "enc_out" else 1,
                                             0, 1).float()
                     for k, v in cache.items() if k != "pos"},
                    logits=logits.float())

    def one_ulp(p, seed, dev):
        g = torch.Generator(device=dev).manual_seed(seed)
        up = torch.rand(p.shape, generator=g, device=dev) < 0.5
        return torch.where(up, torch.nextafter(p, p + 1), p)

    def gap(a, b):
        return float((a - b).abs().max())

    for arch in args.arch or sorted(CASES):
        shape, depths = CASES[arch]
        mesh = C._dp_mesh(shape)
        dev = mesh.positions[0]
        base = registry.get(arch).cfg
        tok = torch.as_tensor(C.serve_prompts(base.vocab_size)[0][None],
                              device=dev)
        frames = torch.randn(
            1, max(1, C.SERVE_MAX_SEQ // base.src_ratio), base.d_model,
            generator=torch.Generator(device=dev).manual_seed(19),
            device=dev) if base.is_encdec else None
        for layers in depths:
            cfg = dataclasses.replace(base, num_layers=layers, **(
                {"enc_layers": layers} if base.is_encdec else {}))
            api = registry.get_model(cfg)
            api32 = registry.get_model(dataclasses.replace(
                cfg, param_dtype="float32", compute_dtype="float32"))
            p16 = api.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
            p32 = tree_map(lambda x: x.float(), p16)
            with torch.no_grad():
                one16 = one(api, p16, tok, dev, frames)
                one32 = one(api32, p32, tok, dev, frames)
                moved = [one(api32, tree_map(lambda x: one_ulp(x, s, dev),
                                             p32), tok, dev, frames)
                         for s in (1, 2, 3)]
            tp16 = placed(api, p16, tok, mesh, dev, frames)
            tp32 = placed(api32, p32, tok, mesh, dev, frames)
            line = {"arch": arch, "mesh": shape, "layers": layers}
            for k in one32:
                line[k] = {
                    "largest": float(one32[k].abs().max()),
                    "tp_bf16-one_bf16": gap(tp16[k], one16[k]),
                    "one_bf16-one_f32": gap(one16[k], one32[k]),
                    "tp_f32-one_f32": gap(tp32[k], one32[k]),
                    "f32_one_ulp": [gap(m[k], one32[k]) for m in moved],
                    "outside_tol": int((~torch.isclose(
                        tp16[k], one16[k], rtol=TOL, atol=TOL)).sum()),
                    "of": one32[k].numel()}
            line["greedy_agree"] = bool(tp16["logits"].argmax()
                                        == one16["logits"].argmax())
            print(json.dumps(line), flush=True)
            del p16, p32
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
