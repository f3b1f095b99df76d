"""Serving example on the PyTorch port: continuous batching over a small
LM.

    PYTHONPATH=src python examples/torch_serve_lm.py [--requests 8 --slots 4]
        [--arch llama3.2-1b] [--device cpu]

The port's counterpart of ``examples/serve_lm.py``: a reduced model of
``--arch``, a stream of requests (more than slots, so the slot table
cycles), greedy decoding.  The ServeState (params, KV caches, slot
positions) is the pointer-chain tree the paper is about.  It runs on the
card unless ``--device cpu``; params are drawn there from seed 0.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import registry
from repro_torch.runtime import Request, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    api = registry.get(args.arch, smoke=True)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    server = Server(api, params, slots=args.slots, max_seq=128, device=dev)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, api.cfg.vocab_size,
                              size=rng.integers(4, 12)).astype(np.int32)
        server.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    done = server.run(max_steps=500)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.tokens_out) for r in done)
    stats = server.stats
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {dev})")
    print(f"  policy {server.policy} | completed {stats.completed} "
          f"shed {stats.shed} timed-out {stats.timed_out} "
          f"failed {stats.failed} | prefill batches {stats.prefill_batches} "
          f"decode steps {stats.decode_steps}")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.tokens_out}")
    return done


if __name__ == "__main__":
    main()
