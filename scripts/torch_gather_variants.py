#!/usr/bin/env python3
"""Time variants of the tile-gather kernel against ``torch.index_select``
on one CUDA card, at ``chip_smoke.py``'s 1 GiB shape (262144 f32 tiles of
4 KiB, gathered by a random permutation).

Usage (from the repository root, on the card):

    python3 scripts/torch_gather_variants.py

The variants are built from ``kernels/marshal_pack/csrc/gather_tiles.cu``
as committed (the TMA ring) with its constants changed, plus one kernel
written here that does not use TMA:

  * ``ring S/L``: the TMA ring with S stages of one tile per block, a stage
    refilled L stores after its own (the committed kernel is 8/4);
  * ``ring 8/4 evict_first``: the committed ring with an L2 evict-first
    policy on its loads (every source byte is read once);
  * ``ring 8/4 contiguous``: the committed ring with each block taking one
    contiguous range of destination tiles instead of every grid-th tile;
  * ``loop x4``: a persistent grid of 256-thread blocks, each thread
    loading one 16-byte word of each of four tiles into registers before it
    stores them (several loads in flight a thread, no shared memory).

Each at 2, 4 and 6 blocks per SM, every result checked bit for bit against
the plain version, timed in turns with ``index_select`` (kernel, library,
library, kernel; CUDA events, ``chip_smoke.time_ms``).  Prints the card's
name and power limit and one line per (variant, blocks per SM).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LOOP_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kThreads = 256, kUnroll = 4;
__global__ void __launch_bounds__(kThreads)
gather_loop(const uint4* __restrict__ src, uint4* __restrict__ dst,
            const int32_t* __restrict__ map, int64_t n_src, int64_t n_dst,
            int64_t vecs) {
  const int64_t grid = gridDim.x;
  for (int64_t base = blockIdx.x; base < n_dst; base += grid * kUnroll) {
    int64_t s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * grid;
      s[u] = i < n_dst ? map[i] : -1;
      if (s[u] >= n_src) s[u] = -1;
    }
    for (int64_t w = threadIdx.x; w < vecs; w += kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s[u] >= 0) v[u] = src[s[u] * vecs + w];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s[u] >= 0) dst[(base + u * grid) * vecs + w] = v[u];
    }
  }
}
}  // namespace
extern "C" int gather_tiles(const void* src, void* dst, const void* map,
                            long long n_src, long long n_dst,
                            long long tile_bytes, int blocks, void* stream) {
  gather_loop<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      static_cast<const int32_t*>(map), n_src, n_dst, tile_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
"""

LOAD = ('"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
        '      "[%0], [%1], %2, [%3];\\n"')
LOAD_EVICT_FIRST = (
    '"{\\n.reg .b64 pol;\\n'
    'createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"\n'
    '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes'
    '.L2::cache_hint "\n'
    '      "[%0], [%1], %2, [%3], pol;\\n}\\n"')


STRIDED = ("  const int64_t nk = (n_dst - blockIdx.x + grid - 1) / grid;  "
            "// my tiles",
            "tile_map[blockIdx.x + k * grid]",
            "dst + (blockIdx.x + k * grid) * tile_bytes")
CONTIGUOUS = ("  const int64_t per = (n_dst + grid - 1) / grid;\n"
              "  const int64_t first = blockIdx.x * per;\n"
              "  const int64_t nk = first >= n_dst ? 0\n"
              "      : (per < n_dst - first ? per : n_dst - first);",
              "tile_map[first + k]",
              "dst + (first + k) * tile_bytes")


def variants(base: str) -> dict:
    def ring(stages, lag, text=base):
        out = text.replace("constexpr int kStages = 8;",
                           f"constexpr int kStages = {stages};")
        return out.replace("constexpr int kLag = 4;",
                           f"constexpr int kLag = {lag};")

    if (LOAD not in base or "constexpr int kStages = 8;" not in base
            or not all(a in base for a in STRIDED)):
        raise SystemExit("gather_tiles.cu changed: update the variants")
    contiguous = base
    for a, b in zip(STRIDED, CONTIGUOUS):
        contiguous = contiguous.replace(a, b)
    return {"ring 4/2": ring(4, 2), "ring 8/4": base, "ring 16/8": ring(16, 8),
            "ring 8/4 evict_first": base.replace(LOAD, LOAD_EVICT_FIRST),
            "ring 8/4 contiguous": contiguous,
            "loop x4": LOOP_SOURCE}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.marshal_pack import kernel as K, ref

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR / "gather_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, text) in enumerate(variants(K.SOURCE.read_text()).items()):
        path = out_dir / f"gather_variant{i}.cu"
        path.write_text(text)
        sources[name] = path
    _build.build(list(sources.values()))

    n = cs.GIB_TILES
    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.randn(n * K.SUBLANE, K.LANE, generator=gen, device=device)
    tmap = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    tmap_long = tmap.long()
    want = ref.pack_ref(src.reshape(-1), tmap, K.TILE)
    out = torch.empty_like(src)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream

    def library():
        torch.index_select(src.view(n, -1), 0, tmap_long)

    for name, path in sources.items():
        fn = ctypes.CDLL(str(_build.library_path(path))).gather_tiles
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for per_sm in (2, 4, 6):
            def kernel():
                err = fn(src.data_ptr(), out.data_ptr(), tmap.data_ptr(), n, n,
                         K.TILE * 4, per_sm * sms, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            kernel()
            if not torch.equal(out.view(-1), want):
                raise SystemExit(f"{name} at {per_sm} blocks/SM != plain")
            t = {"kernel": [], "library": []}
            for which, f in (("kernel", kernel), ("library", library),
                             ("library", library), ("kernel", kernel)):
                t[which].append(cs.time_ms(f, device, iters=20))
            k, lib = sum(t["kernel"]) / 2, sum(t["library"]) / 2
            print(f"{name:22s} {per_sm} blocks/SM: {k:.4f} ms, index_select "
                  f"{lib:.4f} ms, ratio {k / lib:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
