#!/usr/bin/env python3
"""Calibrate the port's transfer cost model on one CUDA card and save it.

``CostModel.calibrate`` times single pageable host-to-card copies of
64 KiB, 1 MiB and 4 MiB (the minimum of 5 each) and fits the two-parameter
wall model; the fit is saved with the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, in keys ``CostModel.load`` ignores.

Usage (from the repository root, on the card):

    python3 scripts/torch_calibrate.py [--out BENCH_torch_costmodel.json]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    from repro_torch.analysis.cost import COSTMODEL_FILE, CostModel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / COSTMODEL_FILE))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    name, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0].split(", ")
    model = CostModel.calibrate()
    model.save(args.out, card=name, power_limit=limit,
               torch=torch.__version__, cuda=torch.version.cuda)
    print(f"{name}, {limit}: latency {model.latency_us} us, bandwidth "
          f"{model.bandwidth_gbps} GB/s, probes {list(model.probes)} -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
