"""End-to-end driver on the PyTorch port: train a ~100M-param llama-family
model.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]

The port's counterpart of ``examples/train_lm.py``: the production train
loop with a reduced-width llama3.2 config (~100M params), deterministic
learnable data, async marshalled checkpoints, the straggler watchdog and
a simulated node failure at step 120 to demonstrate checkpoint-restart.
It runs on the card unless ``--device cpu``; params are drawn there from
seed 0.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import lm as lm_mod
from repro_torch.models import registry
from repro_torch.models.specs import param_count
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import NodeFailure, make_train_step, run, train_state


def config_100m() -> ModelConfig:
    base = registry.load_config("llama3.2-1b")
    return dataclasses.replace(
        base, name="llama-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        param_dtype="float32", compute_dtype="float32", remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=120,
                    help="simulate a node failure at this step (-1: off)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m()
    api = registry.get_model(cfg)
    n = param_count(lm_mod.spec_tree(cfg))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    opt = make_optimizer(cfg.optimizer)
    lr = warmup_cosine(3e-4, 50, args.steps)
    step = make_train_step(api, opt, lr)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_lm")
    boom = {"armed": args.fail_at >= 0}

    def injector(s):
        if boom["armed"] and s == args.fail_at:
            boom["armed"] = False
            print(f"\n*** simulated node failure at step {s}; "
                  f"restarting from latest marshalled checkpoint ***\n")
            raise NodeFailure("injected")

    res = run(step, lambda: train_state(
                  api, opt, torch.Generator(device=dev).manual_seed(0),
                  device=dev),
              data.batch, num_steps=args.steps, ckpt_dir=ckpt_dir,
              ckpt_every=50, failure_injector=injector, log_every=20,
              device=dev)

    losses = [m["loss"] for m in res.metrics_history]
    print(f"\nloss: {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
          f"(restarts: {res.restarts}, stragglers flagged: "
          f"{len(res.straggler_steps)})")
    print(f"checkpoints in {ckpt_dir}")
    return res


if __name__ == "__main__":
    main()
