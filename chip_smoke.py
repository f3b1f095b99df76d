#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card and check it.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. environment — the card's name and power limit (nvidia-smi), torch and
     CUDA versions;
  2. build       — the tile-gather kernel, with nvcc, into build/;
  3. kernels     — each kernel against its plain PyTorch version on the
     card, bit for bit, then timed at the main path's largest shape beside
     its plain version, one library call and its bound;
  4. Algorithm 2 — every scenario of the ported families at the ``full``
     preset under uvm, marshal, marshal+db, marshal+delta and pointerchain:
     line-7 check ok and the ledger equal to the expected motion exactly;
  5. steady      — marshal+delta steady passes on steady_reuse_n2048;
  6. real size   — the paper's two figures at about 1 GiB under every spec
     (ledger == the closed forms);
  7. pack        — pack_tree / unpack_tree of the dense tree's f32 payload
     through the tile-gather kernel: the packed buffer and the unpacked
     pool each equal to the plain version on the same pool and maps, and
     the round trip bit-exact.

Each path is driven with the launch counters set to 0 just before it and
read just after: Algorithm 2 (phases 4-6) must launch no kernel, as the
reference engine calls none, and the pack path must launch gather_tiles
exactly twice (pack and unpack).  The last lines are the card's name and power limit, a ``kernels``
JSON line and ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SPECS = ("uvm", "marshal", "marshal+db", "marshal+delta", "pointerchain")
GIB_TILES = 262144                       # 262144 f32 tiles of 4 KiB = 1 GiB
H100_SXM_BANDWIDTH = 3.35e12             # bytes/s, NVIDIA's H100 SXM data sheet


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def memory_bandwidth(name: str) -> float:
    """The H100 SXM's (its CUDA name is "NVIDIA H100 80GB HBM3"); the
    bound is stated for no other card."""
    if "H100" in name and "HBM3" in name:
        return H100_SXM_BANDWIDTH
    fail(f"the bounds are stated for the H100 SXM only, not {name!r}")


def time_ms(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` calls: CUDA events on the card."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3 -----------------------------------------------------------------

def check_gather_tiles(device, big_tiles: int) -> dict:
    """gather_tiles vs its plain version: f32/bf16/int32 at 1, 4 and 17
    tiles with random permutation maps, then f32 at ``big_tiles``, timed."""
    import torch
    from repro_torch.kernels.marshal_pack import kernel as K, ref

    tile = K.TILE
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for n in (1, 4, 17):
            src = (torch.randn(n * K.SUBLANE, K.LANE, generator=gen) * 10
                   ).to(dtype).to(device)
            tmap = torch.randperm(n, generator=gen).to(torch.int32).to(device)
            got = K.gather_tiles(src, tmap)
            want = ref.pack_ref(src.reshape(-1), tmap, tile).reshape(-1, K.LANE)
            if not torch.equal(got, want):
                fail(f"gather_tiles != plain for {dtype} x {n} tiles")
            max_err = max(max_err, float((got.double() - want.double())
                                         .abs().max()))
    src = torch.randn(big_tiles * K.SUBLANE, K.LANE, generator=gen
                      ).to(device)
    tmap = torch.randperm(big_tiles, generator=gen).to(torch.int32).to(device)
    tmap_long = tmap.long()
    got = K.gather_tiles(src, tmap)
    want = ref.pack_ref(src.reshape(-1), tmap, tile).reshape(-1, K.LANE)
    if not torch.equal(got, want):
        fail(f"gather_tiles != plain at {big_tiles} tiles")
    max_err = max(max_err, float((got - want).abs().max()))
    del got, want

    def kernel():
        K.gather_tiles(src, tmap)

    def plain():
        ref.pack_ref(src.reshape(-1), tmap, tile)

    def library():
        torch.index_select(src.view(big_tiles, -1), 0, tmap_long)

    times = {"kernel": [], "plain": [], "library": []}
    for name, fn in (("plain", plain), ("kernel", kernel), ("library", library),
                     ("library", library), ("kernel", kernel), ("plain", plain)):
        times[name].append(time_ms(fn, device))
    tile_bytes = tile * src.element_size()
    moved = 2 * big_tiles * tile_bytes + 4 * big_tiles
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    bw = memory_bandwidth(name) if device.type == "cuda" else float("nan")
    out = {"ms": sum(times["kernel"]) / 2, "plain_ms": sum(times["plain"]) / 2,
           "library_ms": sum(times["library"]) / 2,
           "bound_ms": moved / bw * 1e3, "bound_by": "bytes",
           "max_abs_err": max_err}
    say(f"[kernels] gather_tiles: bit-exact vs plain (f32/bf16/int32 x 1,4,17 "
        f"tiles; f32 x {big_tiles} tiles = {big_tiles * tile_bytes / 2**30:.3f} "
        f"GiB); kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
        f"index_select {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
        f"ms ({moved} B at {bw / 1e12} TB/s); runs {times}")
    return out


# -- phases 4-7 --------------------------------------------------------------

def algorithm2_matrix(device, size: str) -> int:
    from repro_torch.scenarios import iter_scenarios, run_scenario

    cells = 0
    for sc in iter_scenarios(size):
        tree = sc.build()
        sc.validate(tree)
        for spec in SPECS:
            m = run_scenario(sc, spec, tree=tree, device=device)
            if not (m.ok and m.motion_ok):
                fail(f"{sc.name}/{spec}: ok={m.ok} ledger "
                     f"{(m.h2d_bytes, m.h2d_calls)} expected "
                     f"{m.expected.as_tuple()}")
            cells += 1
        say(f"[algorithm2] {sc.name}: " + ", ".join(
            f"{s} ok" for s in SPECS))
    return cells


def steady(device, n: int) -> None:
    from repro_torch.scenarios import Motion, run_steady_scenario, steady_reuse_case

    sc = steady_reuse_case(n)
    want = Motion(4 * (n + n // 2), 1)
    for i, m in enumerate(run_steady_scenario(sc, passes=3, device=device)):
        if not (m.ok and m.motion_ok
                and (m.h2d_bytes, m.h2d_calls) == want.as_tuple()):
            fail(f"steady pass {i} of {sc.name}: {m}")
        say(f"[steady] {sc.name} pass {i}: moved {m.h2d_bytes} B in "
            f"{m.h2d_calls} copy, skipped {m.skipped_bytes} B, "
            f"{m.wall_us:.1f} us")


def real_size(device, cases) -> None:
    """Algorithm 2 on each (scenario, {kind: (bytes, calls)}) under every
    spec, each ledger held to its closed form, then the transfer step
    alone on a fresh executor (warm staging) for its H2D rate."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.core import get_session
    from repro_torch.scenarios import run_scenario

    for sc, closed in cases:
        t0 = time.perf_counter()
        tree = sc.build()
        say(f"[real] {sc.name}: built in {time.perf_counter() - t0:.2f} s")
        for spec in SPECS:
            m = run_scenario(sc, spec, tree=tree, device=device)
            want = closed[spec.split("+")[0]]
            if not (m.ok and m.motion_ok
                    and (m.h2d_bytes, m.h2d_calls) == want):
                fail(f"{sc.name}/{spec}: ok={m.ok} ledger "
                     f"{(m.h2d_bytes, m.h2d_calls)} closed form {want}")
            scheme = sc.scheme_for(spec, device=device)
            t0 = time.perf_counter()
            scheme.stage(tree, list(sc.used_paths),
                         uvm_access=list(sc.uvm_access) if sc.uvm_access
                         else None)
            synchronize(device)
            stage_s = time.perf_counter() - t0
            say(f"[real] {sc.name}/{spec}: line-7 ok, ledger "
                f"{m.h2d_bytes} B / {m.h2d_calls} calls == closed form; "
                f"Alg-2 wall {m.wall_us / 1e3:.2f} ms (enqueue "
                f"{m.enqueue_us / 1e3:.2f} + sync {m.sync_us / 1e3:.2f}); "
                f"stage {stage_s * 1e3:.2f} ms = "
                f"{scheme.ledger.h2d_bytes / stage_s / 1e9:.2f} GB/s H2D")
            del scheme
        del tree
        get_session().clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def pack_roundtrip(device, sc):
    """pack_tree / unpack_tree of the f32 payload leaves of ``sc``'s tree
    through the tile-gather kernel.  Returns the kernel's launches in those
    two calls (read right after them) and the largest |kernel - plain|
    difference of the checks that follow:

    - the packed buffer equals the plain gather of the same source pool by
      pack_tree's own arena map, and the unpacked pool the plain gather of
      the packed buffer by the inverse map, both on the card;
    - on a one-dtype tree the arena keeps leaf order, so that map is the
      identity; the kernel therefore also gathers the same pool by a random
      permutation of its tiles, held against the plain version, so that a
      kernel that ignored its map fails here too;
    - the round trip gives the leaves back bit for bit.
    """
    import torch
    from repro_torch._device import synchronize
    from repro_torch.core import tree_leaves
    from repro_torch.kernels.marshal_pack import kernel as K, ops, ref

    payload = [l for l in tree_leaves(sc.build())
               if l.dtype == torch.float32]
    nbytes = sum(l.numel() * 4 for l in payload)
    synchronize(device)
    t0 = time.perf_counter()
    packed, meta = ops.pack_tree(payload, device=device)
    back = ops.unpack_tree(packed, meta)
    synchronize(device)
    dt = time.perf_counter() - t0
    launches = K.gather_tiles.launches

    pack_map, unpack_map = ops._device_maps(meta["layout"], meta["shapes"],
                                            device)
    if not torch.equal(unpack_map, meta["unpack_map"]):
        fail("pack_tree's unpack map is not the cached inverse map")
    identity = bool(torch.equal(pack_map, torch.arange(
        pack_map.numel(), dtype=torch.int32, device=device)))
    pool = ops.flatten_to_pool(payload, torch.float32, device)
    want = ref.pack_ref(pool, pack_map, ops.TILE)
    if not torch.equal(packed, want):
        fail("pack_tree's packed buffer != the plain gather of its pool")
    err = float((packed - want).abs().max())
    perm = torch.randperm(pack_map.numel(), generator=torch.Generator()
                          .manual_seed(1)).to(torch.int32).to(device)
    got = ops.pack_pool(pool, perm)
    want = ref.pack_ref(pool, perm, ops.TILE)
    if not torch.equal(got, want):
        fail("gather_tiles != plain on the pack path's pool with a "
             "permuted map")
    err = max(err, float((got - want).abs().max()))
    del pool, want, got
    # the leaves unpack_tree returns are views of one unpacked pool
    unpacked = torch.empty(0, dtype=torch.float32, device=device).set_(
        back[0].untyped_storage())
    want = ref.pack_ref(packed, unpack_map, ops.TILE)
    if not torch.equal(unpacked, want):
        fail("unpack_tree's pool != the plain gather of the packed buffer")
    err = max(err, float((unpacked - want).abs().max()))
    del want, unpacked
    for a, b in zip(back, payload):
        if not torch.equal(a.cpu(), b):
            fail("pack_tree -> unpack_tree round trip is not bit-exact")
    say(f"[pack] pack_tree/unpack_tree: {len(payload)} f32 leaves, "
        f"{nbytes} B ({nbytes / 2**30:.3f} GiB), packed {packed.numel() * 4} "
        f"B ({pack_map.numel()} tiles, arena map "
        f"{'the identity' if identity else 'a permutation'}); {launches} "
        f"launch(es), {dt:.3f} s including the H2D of the pool; packed and "
        f"unpacked pools == plain gather by the arena maps, pool gathered by "
        f"a random permutation == plain, round trip bit-exact")
    return launches, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.marshal_pack import kernel as K
    from repro_torch.scenarios import dense_case, linear_case

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"[env] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.load(K.SOURCE)
    say(f"[build] gather_tiles in {time.perf_counter() - t0:.2f} s")
    log = _build.library_path(K.SOURCE).with_suffix(".log")
    if log.exists():        # absent when build/ already held the library
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] gather_tiles: {line.strip()}")

    gather = check_gather_tiles(device, GIB_TILES)

    # Algorithm 2 (phases 4-6): the engine attaches with views and calls
    # no kernel, so none may be launched here
    K.gather_tiles.launches = 0
    t0 = time.perf_counter()
    cells = algorithm2_matrix(device, "full")
    say(f"[algorithm2] {cells} cells ok in {time.perf_counter() - t0:.2f} s")
    steady(device, 2048)
    dense = dense_case(8, 524288, 3)
    linear = linear_case(6, 33554432, "allinit-allused")
    real_size(device, [
        (dense, {"marshal": (1226836552, 2), "uvm": (2097180, 8),
                 "pointerchain": (2097152, 1)}),
        (linear, {"marshal": (805306512, 2), "uvm": (805306368, 6),
                  "pointerchain": (805306368, 6)})])
    if K.gather_tiles.launches:
        fail(f"Algorithm 2 launched gather_tiles {K.gather_tiles.launches} "
             f"time(s); its engine calls no kernel")

    # the pack path (phase 7): one launch to pack, one to unpack
    K.gather_tiles.launches = 0
    launches, pack_err = pack_roundtrip(device, dense)
    if launches != 2:
        fail(f"pack_tree/unpack_tree launched gather_tiles {launches} "
             f"time(s), not 2")
    gather["max_abs_err"] = max(gather["max_abs_err"], pack_err)

    kernels = [dict(name="gather_tiles", route="cuda",
                    source="src/repro_torch/kernels/marshal_pack/csrc/gather_tiles.cu",
                    replaces="src/repro/kernels/marshal_pack/kernel.py:32",
                    launches=launches, **gather)]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
