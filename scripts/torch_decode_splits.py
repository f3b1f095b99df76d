#!/usr/bin/env python3
"""Time the split-KV decode kernel at each split it may take, on one CUDA
card, at the shapes ``chip_smoke.py`` times it: llama3.2-1b's serve shape
(8 slots of a 2048-row cache layer, 32 heads on 8 KV heads, hd 64, the
serve run's valid lengths), the large shape (32 x 8192, random valid
lengths) and zamba2's serve shape (32 heads on 32 KV heads, hd 80).

Usage (from the repository root, on the card):

    python3 scripts/torch_decode_splits.py

Prints the card's name and power limit, one line per (shape, split) with
the kernel's time (CUDA events, ``chip_smoke.time_ms``), and the split
``kernels/decode_attention/kernel.py::split_keys`` picks for each shape.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.models import registry

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    llama = registry.get("llama3.2-1b").cfg
    zamba = registry.get("zamba2-2.7b").cfg
    lens = [len(p) for p in cs.serve_prompts(llama.vocab_size)]
    serve_valid = [n + cs.SERVE_NEW_TOKENS // 2 for n in lens[:cs.SERVE_SLOTS]]
    big_valid = np.random.default_rng(3).integers(1, 8193, size=32)
    shapes = (
        ("llama serve", serve_valid, cs.SERVE_MAX_SEQ, llama.num_heads,
         llama.num_kv_heads, llama.resolved_head_dim, 50),
        ("llama large", big_valid, 8192, llama.num_heads,
         llama.num_kv_heads, llama.resolved_head_dim, 20),
        ("zamba2 serve", serve_valid, cs.SERVE_MAX_SEQ, zamba.num_heads,
         zamba.num_kv_heads, zamba.resolved_head_dim, 50))
    rule = DK.split_keys
    rows = []
    try:
        for label, valid, S, H, KV, hd, iters in shapes:
            for split in DK.SPLITS:
                DK.split_keys = lambda S, split=split: split
                gen = torch.Generator(device=device).manual_seed(3)
                m, err = cs.time_decode(device, gen, valid, S, H, KV, hd,
                                        iters)
                rows.append({"shape": label, "split": split, "ms": m["ms"],
                             "bound_ms": m["bound_ms"], "max_abs_err": err})
                print(json.dumps(rows[-1]), flush=True)
            print(json.dumps({"shape": label, "split_keys picks": rule(S)}),
                  flush=True)
    finally:
        DK.split_keys = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
