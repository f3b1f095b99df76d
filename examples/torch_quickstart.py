"""Quickstart on the PyTorch port: the deep-copy engine in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``: walks the paper's
Figure-1 example as a tree of tensors, declares a pointer chain, compares
the three transfer schemes' data motion and marshals the whole tree.  It
runs on the card unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (chain_call, declare, get_session, pack, region,
                              transfer_scheme, tree_bytes, tree_leaves,
                              unpack)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # Figure 1: simulation -> atoms -> traits -> positions (host tree)
    simulation = {
        "atoms": {
            "traits": {"positions": torch.zeros((1024, 3)),
                       "momenta": torch.zeros((1024, 3)),
                       "forces": torch.zeros((1024, 3))},
            "N": torch.tensor(1024, dtype=torch.int32),
        },
        "box": torch.eye(3),
    }
    print(f"tree: {tree_bytes(simulation)/1e3:.1f} KB, "
          f"{len(tree_leaves(simulation))} leaves\n")

    # -- pointerchain: declare once, use everywhere -------------------------
    refs = declare(simulation, "atoms.traits.positions")
    print(f"declared chain: {refs[0]}  (effective address = flat leaf index)")

    # region with write-back (paper §3.3 semantics)
    with region(simulation, refs) as r:
        r[0] = r[0] + 1.0       # the kernel
    simulation = r.result
    print("after region: positions[0] =",
          simulation["atoms"]["traits"]["positions"][0].numpy(), "\n")

    # condensed form (§3.2): declare + region in one call
    simulation = chain_call(lambda p: p * 2.0, simulation,
                            ["atoms.traits.positions"])

    # -- the three transfer specs, with their data motion -------------------
    for name in ("uvm", "marshal", "pointerchain"):
        scheme = transfer_scheme(name, device=dev)
        if name == "pointerchain":
            scheme.to_device(simulation, paths=["atoms.traits.positions"])
        elif name == "uvm":
            scheme.materialize(scheme.to_device(simulation),
                               paths=["atoms.traits.positions"])
        else:
            scheme.to_device(simulation)
        led = scheme.ledger
        print(f"{name:13s} H2D: {led.h2d_calls} transfer(s), "
              f"{led.h2d_bytes/1e3:8.1f} KB")

    # -- path-scoped policy: each region its own spec, ONE program -----------
    program = get_session().compile(
        simulation,
        "atoms/traits/**=marshal+delta; box=pointerchain; **=marshal",
        device=dev)
    program.to_device(simulation)
    print("\npolicy program regions:")
    for pat, led in program.ledgers.items():
        print(f"  {pat:20s} H2D {led.h2d_calls} transfer(s), "
              f"{led.h2d_bytes/1e3:6.1f} KB")
    print(f"  ({program.last_stats.enqueue_total} enqueues, "
          f"{program.last_stats.syncs} sync — a repeat pass re-ships only "
          "dirty traits buckets)")

    # -- marshalling by hand: Algorithm 1 ------------------------------------
    buffers, layout = pack(simulation)
    print(f"\nmarshalled: {[(b, tuple(v.shape)) for b, v in buffers.items()]}")
    print(f"requestList: {layout.num_leaves} slots, "
          f"{layout.total_bytes()/1e3:.1f} KB total")
    restored = unpack(buffers, layout)
    assert torch.equal(restored["atoms"]["traits"]["positions"],
                       simulation["atoms"]["traits"]["positions"])
    print("attach (unpack) verified: leaves reconstructed from the arena")


if __name__ == "__main__":
    main()
