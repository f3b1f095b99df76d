// gather_tiles — the marshal_pack tile gather for Hopper (sm_90a).
//
// Replaces repro/kernels/marshal_pack/kernel.py::gather_tiles (Pallas/TPU):
//     dst_tile[i] = src_tile[tile_map[i]]
// over tiles of 8 x 128 = 1024 elements.  The same kernel packs (map) and
// unpacks (inverse map) an arena.
//
// Bound: pure data movement.  Every packed byte is read once and written
// once, so the least time is 2 * bytes / the card's memory bandwidth; the
// map adds 4 bytes per tile.
//
// Design: the kernel does not care about the element type — it moves
// tile_bytes per tile in 16-byte (uint4) loads and stores.  One block per
// destination tile; the block reads its source index once (the TPU's
// scalar prefetch becomes one load per block) and its threads stride over
// the tile's 16-byte words, so neighbouring threads touch neighbouring
// addresses.  Offsets are 64-bit: tile index x tile_bytes passes 2^31 above
// 2 GiB.  A source index outside [0, n_src) writes nothing (the host checks
// maps where it builds them; this guard keeps a bad map from faulting the
// card).  Making it fast (TMA bulk copies, a persistent grid) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_tiles_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                    const int32_t* __restrict__ tile_map, int64_t n_src,
                    int64_t tile_vecs) {
  const int64_t i = blockIdx.x;
  const int64_t s = tile_map[i];
  if (s < 0 || s >= n_src) return;
  const uint4* from = src + s * tile_vecs;
  uint4* to = dst + i * tile_vecs;
  for (int64_t v = threadIdx.x; v < tile_vecs; v += kThreads) {
    to[v] = from[v];
  }
}

}  // namespace

// Launches on `stream`, does not synchronize, returns cudaGetLastError().
// src: n_src tiles, dst: n_dst tiles, both tile_bytes each and 16-byte
// aligned; tile_bytes a multiple of 16; n_dst > 0 (the caller skips empty
// maps: a grid of 0 blocks is a launch error).
extern "C" int gather_tiles(const void* src, void* dst, const void* tile_map,
                            long long n_src, long long n_dst,
                            long long tile_bytes, void* stream) {
  const int64_t tile_vecs = tile_bytes / static_cast<int64_t>(sizeof(uint4));
  gather_tiles_kernel<<<static_cast<unsigned int>(n_dst), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      static_cast<const int32_t*>(tile_map), n_src, tile_vecs);
  return static_cast<int>(cudaGetLastError());
}
