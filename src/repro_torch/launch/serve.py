"""Serving entry point.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        [--smoke] [--device cpu] [--requests 16] [--slots 4] [--ckpt-dir D]

The port's counterpart of ``repro/launch/serve.py``, on one device: the
card unless ``--device cpu``.  With ``--ckpt-dir`` the params come from
the checkpoint (a checkpoint of either package): ``selective_restore``
reads only the ``params`` chains, then ``load`` rebuilds the params
subtree, which reads the whole checkpoint, as the reference does.
Otherwise params are drawn on the device from seed 0.  The
continuous-batching ``Server`` then serves the reference's synthetic
request stream (``default_rng(0)``, prompts of 4-15 tokens) and the two
summary lines are printed.  ``main`` returns the server and the finished
requests.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import resolve_device
from repro_torch.models import registry
from repro_torch.runtime import Request, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission queue hard bound (submits shed above "
                         "the watermark instead of buffering forever)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline; lapsed requests terminate "
                         "typed (timed_out), not silently")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    api = registry.get(args.arch, smoke=args.smoke)
    if args.ckpt_dir:
        t0 = time.perf_counter()
        # pointerchain over the manifest: read ONLY the params chains
        sel = ckpt.selective_restore(args.ckpt_dir, ["params"])
        params = ckpt.load(args.ckpt_dir)["params"]  # the full subtree
        print(f"restored {len(sel)} param chains from {args.ckpt_dir} in "
              f"{time.perf_counter() - t0:.2f}s")
    else:
        params = api.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)

    server = Server(api, params, slots=args.slots, max_seq=args.max_seq,
                    max_queue=args.max_queue, device=dev)
    del params
    rng = np.random.default_rng(0)
    shed = 0
    for i in range(args.requests):
        verdict = server.submit(Request(
            rid=i,
            prompt=rng.integers(0, api.cfg.vocab_size,
                                size=int(rng.integers(4, 16))).astype(np.int32),
            max_new_tokens=args.max_new,
            deadline_s=args.deadline_s))
        shed += verdict == "shed"
    t0 = time.perf_counter()
    done = server.run(max_steps=args.requests * args.max_new + 50)
    dt = time.perf_counter() - t0
    tok = sum(len(r.tokens_out) for r in done)
    stats = server.stats
    print(f"served {len(done)}/{args.requests} requests, {tok} tokens, "
          f"{dt:.2f}s ({tok/max(dt,1e-9):.1f} tok/s)")
    print(f"policy {server.policy} | completed {stats.completed} "
          f"shed {stats.shed} timed-out {stats.timed_out} "
          f"failed {stats.failed} retries {stats.retries_total}")
    return server, done


if __name__ == "__main__":
    main()
