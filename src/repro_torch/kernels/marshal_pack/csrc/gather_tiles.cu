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
// Design: TMA bulk copies on a persistent grid.  The kernel does not care
// about the element type: a tile is tile_bytes (4 KiB for f32 and int32,
// 2 KiB for bf16) moved as one 1-D cp.async.bulk each way.
//   * The grid is a small multiple of the SM count (the wrapper passes it),
//     and each block walks destination tiles blockIdx.x + k * gridDim.x.
//     Nothing is scheduled per tile, so the copy rate no longer depends on
//     how fast the card can start and retire blocks (the one-block-per-tile
//     kernel this replaces launched 262144 blocks at 1 GiB).
//   * A block is one warp, and lane 0 drives a ring of kStages shared-memory
//     stages of one tile each.  A load into a stage completes on the
//     stage's mbarrier, armed with expect_tx of the tile's bytes; once it
//     has landed the tile is written back out with a shared -> global bulk
//     store, one bulk group per store.  The stage is refilled kLag tiles
//     later, after cp.async.bulk.wait_group.read has seen that store finish
//     reading it, so up to kStages tiles are in flight per block (32 KiB at
//     f32) and a few blocks per SM keep ~100 KiB outstanding on every SM.
//   * The map is read 32 entries at a time, one per lane, a batch ahead of
//     its use, and broadcast with a shuffle: lane 0 never waits on a map
//     load before it issues a copy.
//   * Offsets are 64-bit: tile index x tile_bytes passes 2^31 above 2 GiB.
//     A source index outside [0, n_src) writes nothing: its stage is not
//     loaded (the mbarrier gets a plain arrive so its phases stay in step)
//     and its destination tile is not stored (the host checks maps where it
//     builds them; this guard keeps a bad map from faulting the card).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 8;   // tiles in flight per block
constexpr int kLag = 4;      // a stage is refilled kLag stores after its own

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(32)
gather_tiles_kernel(const unsigned char* __restrict__ src,
                    unsigned char* __restrict__ dst,
                    const int32_t* __restrict__ tile_map, int64_t n_src,
                    int64_t n_dst, uint32_t tile_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int64_t from[kStages];      // the source tile of each stage
  const int lane = threadIdx.x;
  const int64_t grid = gridDim.x;
  const int64_t nk = (n_dst - blockIdx.x + grid - 1) / grid;  // my tiles
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // map entries of my tiles 32 k .. 32 k + 31, one per lane: `cur` holds
  // the batch that loads are being issued from, `nxt` the one after it
  auto map_of = [&](int64_t k) -> int32_t {
    return k < nk ? tile_map[blockIdx.x + k * grid] : -1;
  };
  int32_t cur = map_of(lane), nxt = map_of(32 + lane);
  int64_t batch = 0;

  // issue the load of my tile j into stage j % kStages (warp-uniform call)
  auto issue = [&](int64_t j) {
    if (j >> 5 != batch) {               // j only ever steps forward by one
      batch = j >> 5;
      cur = nxt;
      nxt = map_of(32 * (batch + 1) + lane);
    }
    const int64_t s_tile = __shfl_sync(0xffffffffu, cur, j & 31);
    if (lane == 0) {
      const int s = j % kStages;
      const bool ok = s_tile >= 0 && s_tile < n_src;
      from[s] = ok ? s_tile : -1;
      if (ok) {
        bar_expect_tx(&full[s], tile_bytes);
        bulk_load(ring + s * tile_bytes, src + s_tile * tile_bytes,
                  tile_bytes, &full[s]);
      } else {
        bar_arrive(&full[s]);            // completes the phase, loads nothing
      }
    }
  };

  for (int64_t j = 0; j < kStages && j < nk; ++j) issue(j);
  for (int64_t k = 0; k < nk; ++k) {
    if (lane == 0) {
      const int s = k % kStages;
      bar_wait(&full[s], static_cast<uint32_t>((k / kStages) & 1));
      if (from[s] >= 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_store(dst + (blockIdx.x + k * grid) * tile_bytes,
                   ring + s * tile_bytes, tile_bytes);
      } else {
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // refill the stage of tile k - kLag + 1 once its store has read it:
    // stores k - kLag + 2 .. k (kLag - 1 groups) may still be pending
    const int64_t done = k - kLag + 1;
    if (done >= 0 && done + kStages < nk) {
      if (lane == 0) bulk_wait_read<kLag - 1>();
      issue(done + kStages);
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// Launches `blocks` blocks on `stream`, does not synchronize, returns
// cudaGetLastError().  src: n_src tiles, dst: n_dst tiles, both tile_bytes
// each and 16-byte aligned; tile_bytes a multiple of 16 and at most 8 KiB;
// n_dst > 0 (the caller skips empty maps: a grid of 0 blocks is a launch
// error); 0 < blocks.
extern "C" int gather_tiles(const void* src, void* dst, const void* tile_map,
                            long long n_src, long long n_dst,
                            long long tile_bytes, int blocks, void* stream) {
  if (n_dst < 1 || blocks < 1 || tile_bytes < 16 || tile_bytes % 16 ||
      tile_bytes > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = blocks < n_dst ? blocks : n_dst;
  const size_t smem = static_cast<size_t>(kStages) * tile_bytes;
  if (smem + 1024 > 48 * 1024) {      // with the static barriers and indices
    const cudaError_t err = cudaFuncSetAttribute(
        gather_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_tiles_kernel<<<static_cast<unsigned int>(grid), 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst),
      static_cast<const int32_t*>(tile_map), n_src, n_dst,
      static_cast<uint32_t>(tile_bytes));
  return static_cast<int>(cudaGetLastError());
}
