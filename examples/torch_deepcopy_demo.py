"""Deep-copy scenarios demo on the PyTorch port, interactively sized.

    PYTHONPATH=src python examples/torch_deepcopy_demo.py [--k 8 --n 100000]
        [--spec marshal+delta] [--policy '...'] [--device cpu]

The port's counterpart of ``examples/deepcopy_demo.py``: one Linear-
scenario cell and one Dense-scenario cell under the paper's three
transfer specs (plus any ``--spec`` strings, such as ``marshal+delta``),
printing the Algorithm-2 wall time, the kernel time and the exact data
motion each spec issued, then a params/opt/meta tree under a path-scoped
``--policy`` (one TransferProgram: every region its own spec, one
synchronize).  It runs on the card unless ``--device cpu``; the walls are
that device's.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.core import PAPER_SPECS, TransferSpec
from repro_torch.scenarios import (dense_chain, dense_tree,
                                   dense_uvm_access_set, linear_tree,
                                   linear_used_paths, mixed_policy_tree,
                                   run_algorithm2)


def _report(tree, used, specs, device, access=None):
    base = None
    for spec in specs:
        m = run_algorithm2(tree, used, spec, uvm_access=access,
                           device=device)
        base = base or m.wall_us
        print(f"  {str(spec):18s} wall {m.wall_us/1e3:8.2f} ms "
              f"(x{m.wall_us/base:5.2f} vs uvm)  kernel {m.kernel_us:7.1f} us"
              f"  H2D {m.h2d_calls:3d} DMAs / {m.h2d_bytes/1e6:8.3f} MB"
              f"  check={'ok' if m.ok else 'FAIL'}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=6)
    ap.add_argument("--spec", action="append", default=[],
                    help="extra TransferSpec strings to run alongside the "
                         "paper's three (repeatable)")
    ap.add_argument("--policy",
                    default="params/**=marshal; opt/**=marshal+delta; "
                            "**=pointerchain",
                    help="path-scoped TransferPolicy for the mixed-state "
                         "section (region pattern = spec, ';'-separated)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    specs = list(PAPER_SPECS) + [TransferSpec.parse(s) for s in args.spec]

    print(f"=== Linear scenario: k={args.k}, n={args.n}, LLinit-LLused ===")
    tree = linear_tree(args.k, args.n, "LLinit-LLused")
    used = linear_used_paths(args.k, "LLinit-LLused")
    _report(tree, used, specs, dev)

    print(f"\n=== Dense scenario: q={args.q}, n={args.n // 10}, depth 3 ===")
    tree = dense_tree(args.q, args.n // 10)
    used = [dense_chain(args.q)]
    access = dense_uvm_access_set(args.q)
    _report(tree, used, specs, dev, access=access)
    print("\n(marshalling moves the whole q^3 tree for one used leaf; "
          "pointerchain moves exactly that leaf — the paper's Fig. 7 gap)")

    n = max(args.n // 100, 8)
    print(f"\n=== Mixed state: params/opt/meta tree, n={n} ===")
    tree = mixed_policy_tree(n)
    used = ["params.w", "opt.m", "meta.scale"]
    _report(tree, used, specs, dev)
    m = run_algorithm2(tree, used, policy=args.policy, device=dev)
    print(f"  policy program      wall {m.wall_us/1e3:8.2f} ms  "
          f"H2D {m.h2d_calls:3d} DMAs / {m.h2d_bytes/1e6:8.3f} MB"
          f"  check={'ok' if m.ok else 'FAIL'}")
    print(f"  ({m.spec}\n   — each region under its own spec, every "
          "region's buckets enqueued before ONE sync)")


if __name__ == "__main__":
    main()
