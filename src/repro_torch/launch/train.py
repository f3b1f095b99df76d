"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        [--smoke] [--device cpu] [--steps 100] [--ckpt-dir D] \\
        [--dp-shardmap --grad-scheme arena --compress] \\
        [--production-mesh [--multi-pod]]

The port's counterpart of ``repro/launch/train.py``: the same loop,
checkpoints, watchdog and failure recovery on one device, the card unless
``--device cpu``.  Params are drawn on that device from seed 0.
``--dp-shardmap`` switches to the explicit data-parallel step whose
gradient collective is the paper's transfer-scheme choice (pertensor |
arena [+ int8]) over a (n, 1) mesh of every visible device, as the
reference builds it: the visible cards, or one position with ``--device
cpu``.  Its step replicates the state, so restores on that path move the
tree leaf by leaf (no state policy), as the reference's do.
``--production-mesh`` builds the reference's (16, 16) mesh (``--multi-pod``:
(2, 16, 16)) of cards, or of CPU positions with ``--device cpu``, and
trains with the sharded step (``runtime.train.make_sharded_train_step``),
the state in 2-D placements that restores place again
(``state_shardings``); with fewer cards than the mesh needs it raises the
stale-mesh error, as ``jax.make_mesh`` fails without the devices.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     rules_for)
from repro_torch.models import registry
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import loop as loop_mod
from repro_torch.runtime.train import (init_error_state, make_dp_train_step,
                                       make_sharded_train_step,
                                       make_train_step, state_transfer_policy,
                                       train_state)


def visible_positions(dev: torch.device) -> int:
    """The dp mesh's size: every visible card, or one position on the CPU
    (the reference's ``len(jax.devices())``)."""
    return 1 if dev.type == "cpu" else torch.cuda.device_count()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--production-mesh", action="store_true",
                    help="build the 16x16 mesh (needs >=256 devices)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dp-shardmap", action="store_true",
                    help="explicit-DP step with chosen gradient collective")
    ap.add_argument("--grad-scheme", default="arena",
                    choices=["pertensor", "arena"])
    ap.add_argument("--compress", action="store_true",
                    help="int8+error-feedback gradient compression")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    # the production mesh first: too few cards is the stale-mesh error,
    # raised before any card is asked for
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device=args.device) \
        if args.production_mesh else None
    dev = resolve_device(args.device)
    api = registry.get(args.arch, smoke=args.smoke)
    cfg = api.cfg
    opt = make_optimizer(cfg.optimizer)
    lr = warmup_cosine(args.lr, min(100, args.steps // 10 + 1), args.steps)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)

    state_shardings = None
    if mesh is not None:
        step = make_sharded_train_step(api, opt, lr, mesh,
                                       rules_for(cfg, mesh, "train"))
        state_shardings = step.shardings
    elif args.dp_shardmap:
        mesh = make_debug_mesh(data=visible_positions(dev), model=1,
                               device=dev)
        dp_step = make_dp_train_step(api, opt, lr, mesh,
                                     grad_scheme=args.grad_scheme,
                                     compress=args.compress)

        def step(state, batch):
            new_state, metrics, step.err = dp_step(state, batch, step.err)
            return new_state, metrics
        step.err = init_error_state(api, args.compress, mesh)
    else:
        step = make_train_step(api, opt, lr)

    res = loop_mod.run(
        step, lambda: train_state(api, opt, torch.Generator(
            device=dev).manual_seed(0), device=dev),
        data.batch, num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        state_shardings=state_shardings,
        # restored checkpoints stage through ONE policy program: arena
        # params + delta opt state + marshalled metadata; not on the dp
        # path, whose step replicates the state itself, nor on the
        # production mesh, whose restores place the state in its blocks
        state_policy=state_transfer_policy()
        if state_shardings is None and not args.dp_shardmap else None,
        log_every=args.log_every,
        device=dev)

    losses = [m["loss"] for m in res.metrics_history]
    print(f"done: loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} "
          f"({args.steps} steps, {res.restarts} restarts, "
          f"{len(res.straggler_steps)} stragglers)")
    return res


if __name__ == "__main__":
    main()
