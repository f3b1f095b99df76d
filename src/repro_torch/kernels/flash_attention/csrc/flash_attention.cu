// flash_attention — blocked causal GQA attention (forward) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas/TPU): per (b, h), softmax(Q K^T * scale) V with an f32 online
// softmax (running max, sum and accumulator), keys at or past kv_len[b]
// masked, k_pos <= q_offset[b] + i for query row i when causal, masked
// scores NEG_INF = -1e30 and output acc / max(l, 1e-30).  The per-batch
// query offset lets a multi-token call at a nonzero cache position (prefill
// after decode, chunked prefill) attend to the cache it continues.
//
// Bound: at the serving shapes (Sq = Sk up to a few thousand, hd = 64) the
// products dominate: 4 * B * H * Sq * Sk * hd operations (half of them
// under causal masking) against q, k, v and o read or written once.  The
// least time is the larger of those operations at the tensor cores' 989
// TFLOP/s (bf16) and those bytes at 3.35 TB/s: the operations, by ~20x.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback: a bf16 input
// never reaches the FMA kernel):
//
// bf16 (serving): flash_tc_kernel, both products on the tensor cores.
//   * One block per (b, h, 128-row q tile): two consumer warpgroups of 64
//     rows each (P = 938 gives 8 x 32 = 256 blocks at llama's 32 heads),
//     the longest causal tiles scheduled first.
//   * S = Q K^T is wgmma m64n64k16 with Q and K in shared memory (both
//     K-major); O += P V is wgmma m64n{hd}k16 with P in registers: the S
//     accumulator fragment is scaled, exponentiated and packed to bf16 in
//     place as the A operand (its layout is the A layout), so P never goes
//     through shared memory; V is the B operand in its MN-major form (the
//     cache's rows as they are, read transposed by the descriptor).  f32
//     accumulation; the running max, sum and O live in registers.
//   * K/V tiles of 64 keys go through a ring in shared memory (four stages
//     at hd <= 64, three above), filled with cp.async 16-byte copies: the
//     tiles up to it + stages - 1 are in flight while tile it is
//     multiplied, so the L2 and HBM latency of a tile is hidden behind
//     several tiles' work; one __syncthreads per tile.  cp.async, not TMA: a TMA
//     descriptor would have to be encoded on the host for every call (the
//     strides and base pointers change per layer and per call), which adds
//     host work to a host-bound serve loop; with cp.async the kernel writes
//     the wgmma layout itself.  That layout is the no-swizzle one (8 x 16 B
//     core matrices, each 128 contiguous bytes): it takes every head dim
//     the models use, 16 to 128 including zamba2's 80 and phi-3's 96 (160-
//     and 192-byte rows that no 128-byte swizzle atom holds), with no
//     padding, and its stores are free of bank conflicts because 8
//     neighbouring lanes fill the 8 rows of one core matrix (smem offset =
//     16 * copy index).  At hd 96 P V is wgmma m64n96k16 (a valid N) and
//     Q K^T six k16 steps; the ring keeps three stages, 96 KiB in all.
//   * The row max and sum of a fragment span the 4 lanes of a quad
//     (__shfl_xor_sync over 1 and 2); exp2 with the scale folded into
//     log2(e) and applied in the exponent's FFMA; O is rescaled in
//     registers.
//   * Masking runs only on the tiles that need it: the one holding the
//     causal diagonal of the warpgroup's rows and the one holding
//     kv_len[b].  Tiles wholly above the block's last row position, or
//     wholly at or past kv_len[b], are not loaded, and a warpgroup skips
//     the tiles wholly above its own last row.  That is exact: kv_len[b]
//     is clamped into [1, Sk] and q_offset[b] to >= 0, so every row has
//     key 0 valid in the first tile, and a skipped tile would only have
//     contributed exp(-1e30 - m) = 0.
//   * The ragged last q and k tiles are zero-filled by cp.async's
//     src-size form (nothing past the tensor is read); rows past Sq are
//     not stored.  The inputs are read through their strides in the
//     model's (B, S, H, hd) layout: 16-byte aligned base pointers and row
//     strides are required (the wrapper checks).
//   * P rounded to bf16 before P V is the one numerical change against the
//     FMA kernel: a few bf16 ulps in the output.
//   Not done: a producer warp with TMA and mbarriers, overlap of one
//   warpgroup's softmax with its own next Q K^T (two warpgroups and two
//   blocks an SM interleave instead), a persistent grid.
//
// f32 (the card tests and the smoke models' logits checks):
//   flash_fma_kernel, f32 FMAs on the CUDA cores.  Tensor cores in f32 are
//   TF32, about three decimal digits, where the f32 checks want ~1e-5.
//   One block per (b, h, 64-row q tile), K/V staged as f32 in shared
//   memory, thread (tr, tc) of 16 x 16 owning rows tr + 16 i and columns
//   tc + 16 j; the same masks, clamps and tile skip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {          // in elements; the head dim has stride 1
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// f32: the FMA kernel
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaBQ = 64;         // q rows per block
constexpr int kFmaBK = 64;         // keys per tile

template <int HD>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (kFmaBQ * (HD + 1) + kFmaBK * (HD + 1) +
                          kFmaBK * HD + kFmaBQ * (kFmaBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ q_offset,
                 const int* __restrict__ kv_lens, int H, int KV, int Sq,
                 int Sk, int causal, float scale, Strides qs, Strides ks,
                 Strides vs, Strides os) {
  constexpr int U = HD / 16;             // output dims per thread
  extern __shared__ float fma_smem[];
  float* sQ = fma_smem;                  // kFmaBQ x (HD + 1)
  float* sK = sQ + kFmaBQ * (HD + 1);    // kFmaBK x (HD + 1)
  float* sV = sK + kFmaBK * (HD + 1);    // kFmaBK x HD
  float* sP = sV + kFmaBK * HD;          // kFmaBQ x (kFmaBK + 1)

  const int q0 = blockIdx.x * kFmaBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int qoff = q_offset != nullptr ? max(q_offset[b], 0) : 0;
  const int kvl = kv_lens != nullptr ? min(max(kv_lens[b], 1), Sk) : Sk;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kFmaBQ * HD; i += kFmaThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    sQ[r * (HD + 1) + d] =
        row < Sq ? qb[static_cast<long long>(row) * qs.s + d] : 0.f;
  }

  float m[4], l[4], acc[4][U];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
  }

  int k_end = kvl;                       // keys past kv_len: masked tiles
  if (causal) k_end = min(k_end, qoff + q0 + kFmaBQ);
  for (int k0 = 0; k0 < k_end; k0 += kFmaBK) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < kFmaBK * HD; i += kFmaThreads) {
      const int j = i / HD, d = i % HD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = kb[static_cast<long long>(key) * ks.s + d];
        vv = vb[static_cast<long long>(key) * vs.s + d];
      }
      sK[j * (HD + 1) + d] = kv;
      sV[j * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tc + 16 * j;
        const bool ok = key < kvl && (!causal || key <= qoff + row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 threads of a row are lanes tc = 0..15 of one half-warp
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(tr + 16 * i) * (kFmaBK + 1) + tc + 16 * j] = p;
        psum += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < U; ++u) acc[i][u] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kFmaBK; ++c) {
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) vv[u] = sV[c * HD + tc + 16 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tr + 16 * i) * (kFmaBK + 1) + c];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[i][u] = fmaf(p, vv[u], acc[i][u]);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < U; ++u)
      ob[static_cast<long long>(row) * os.s + tc + 16 * u] = acc[i][u] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTcThreads = 256;    // two consumer warpgroups
constexpr int kTcBQ = 128;         // q rows per block, 64 per warpgroup
constexpr int kTcBK = 64;          // keys per tile
// K/V ring depth: tile it + kStages - 1 is in flight while tile it is
// multiplied (four tiles of 64 keys at hd <= 64, three above)
template <int HD>
__host__ __device__ constexpr int stages() { return HD <= 64 ? 4 : 3; }
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (src is
// then not read, but stays a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's newest copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the copies' shared-memory writes, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma shared-memory descriptor, no swizzle: address, leading (K
// direction) and stride (M/N direction) byte offsets between core matrices
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma (its results exist only after the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) += A (64 x 16, smem) * B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, smem,
// MN-major), N = the head dim
template <int N> struct WgmmaRS;

template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<80> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<96> {
  static __device__ __forceinline__ void run(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x HD bf16 (rows a multiple of 8) into the no-swizzle core-matrix
// layout: copy i moves 16 bytes of row (i % 8) + 8 (i / (8 C)), chunk
// (i / 8) % C, to byte 16 i; rows at or past `limit` are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const bf16* src,
                                           long long row_stride, int row0,
                                           int limit, int tid) {
  constexpr int C = HD / 8;
#pragma unroll
  for (int i = tid; i < ROWS * C; i += kTcThreads) {
    const int row = row0 + (i & 7) + 8 * (i / (8 * C));
    const int c8 = (i >> 3) % C;
    const bool ok = row < limit;
    cp_async16(dst + 16 * i, src + (ok ? row : 0) * row_stride + 8 * c8, ok);
  }
}

template <int HD>
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(kTcBQ + 2 * stages<HD>() * kTcBK) * HD * 2;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                const int* __restrict__ q_offset,
                const int* __restrict__ kv_lens, int H, int KV, int Sq,
                int Sk, int causal, float scale_log2, Strides qs, Strides ks,
                Strides vs, Strides os) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kStages = stages<HD>();
  constexpr int kTile = kTcBK * HD * 2;  // bytes of one K or V tile
  constexpr uint32_t kRowGroup = 16 * HD;   // bytes between 8-row groups
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* sQ = tc_smem;                     // kTcBQ x HD
  unsigned char* sK = sQ + kTcBQ * HD * 2;         // kStages x kTcBK x HD
  unsigned char* sV = sK + kStages * kTile;        // kStages x kTcBK x HD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // row r of this batch sits at position qoff + r; keys at or past kvl are
  // masked (see the tile-skip note at the top for the clamps)
  const int qoff = q_offset != nullptr ? max(q_offset[b], 0) : 0;
  const int kvl = kv_lens != nullptr ? min(max(kv_lens[b], 1), Sk) : Sk;
  const int k_end = causal ? min(kvl, qoff + min(q0 + kTcBQ, Sq)) : kvl;
  const int n_tiles = (k_end + kTcBK - 1) / kTcBK;
  const int q0w = q0 + 64 * wg;                  // this warpgroup's rows
  const bool wg_live = q0w < Sq;
  const int wg_k_end = causal ? min(kvl, qoff + min(q0w + 64, Sq)) : kvl;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  // one copy group per tile, Q with the first; tiles 0 .. kStages - 2
  // in flight before the loop (empty groups past the last tile)
  stage_rows<HD, kTcBQ>(sQ, qb, qs.s, q0, Sq, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      stage_rows<HD, kTcBK>(sK + st * kTile, kb, ks.s, st * kTcBK, kvl, tid);
      stage_rows<HD, kTcBK>(sV + st * kTile, vb, vs.s, st * kTcBK, kvl, tid);
    }
    cp_async_commit();
  }

  // the thread's two rows of the accumulator fragments: r and r + 8
  const int r = 16 * warp + (lane >> 2);
  const int t = lane & 3;
  const int pos0 = qoff + q0w + r;               // causal positions
  const int pos1 = pos0 + 8;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // the running max is kept in raw score units; exponents are
  // exp2(s * scale_log2 - m * scale_log2), one FFMA each
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint64_t q_desc = wgmma_desc(sQ + wg * 64 * HD * 2, 128, kRowGroup);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();        // tile it (and Q) has landed
    fence_proxy_async();
    __syncthreads();                     // ... for every thread; and tile
                                         // it - 1's stage is free again
    const int nx = it + kStages - 1;
    if (nx < n_tiles) {
      const int st = nx % kStages;
      stage_rows<HD, kTcBK>(sK + st * kTile, kb, ks.s, nx * kTcBK, kvl, tid);
      stage_rows<HD, kTcBK>(sV + st * kTile, vb, vs.s, nx * kTcBK, kvl, tid);
    }
    cp_async_commit();
    const int k0 = it * kTcBK;
    if (!wg_live || k0 >= wg_k_end) continue;    // warpgroup-uniform
    const unsigned char* tK = sK + (it % kStages) * kTile;
    const unsigned char* tV = sV + (it % kStages) * kTile;

    // S = Q K^T: 64 rows x 64 keys
    float s[32];                         // overwritten: scale_d = 0 at kk 0
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, q_desc + ((kk * 256) >> 4),
                   wgmma_desc(tK + kk * 256, 128, kRowGroup), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[4j + e] is (row r, key k0 + 8j + 2t + e), s[4j + 2 + e] row r + 8
    const bool need_mask =
        k0 + kTcBK > kvl || (causal && k0 + kTcBK - 1 > qoff + q0w);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          const bool ok = key < kvl;
          if (!(ok && (!causal || key <= pos0))) s[4 * j + e] = kNegInf;
          if (!(ok && (!causal || key <= pos1))) s[4 * j + 2 + e] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {   // the quad holds a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * scale_log2);
    const float alpha1 = exp2f((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float b0 = -mn0 * scale_log2, b1 = -mn1 * scale_log2;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(fmaf(s[4 * j], scale_log2, b0));
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale_log2, b0));
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale_log2, b1));
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale_log2, b1));
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + ps0;              // this thread's columns; the quad
    l1 = l1 * alpha1 + ps1;              // is summed once, at the end
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    // P as the A operand: keys 16 kk .. 16 kk + 15 are S's n-chunks 2 kk
    // and 2 kk + 1, already in the A fragment's order
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V: V's 16 keys of step kk are two 8-row groups further on
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<HD>::run(acc, p[kk],
                       wgmma_desc(tV + kk * 2 * kRowGroup, kRowGroup, 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  if (!wg_live) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = o + b * os.b + h * os.h;
  const int row0 = q0w + r, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                acc[4 * j + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           const int* qo, const int* kl, int B, int H, int KV, int Sq, int Sk,
           int causal, float scale, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr size_t smem = fma_smem_bytes<HD>();
    if (int err = set_smem(flash_fma_kernel<HD>, smem)) return err;
    const dim3 grid((Sq + kFmaBQ - 1) / kFmaBQ, H, B);
    flash_fma_kernel<HD><<<grid, kFmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), qo, kl, H, KV,
        Sq, Sk, causal, scale, qs, ks, vs, os);
  } else {
    constexpr size_t smem = tc_smem_bytes<HD>();
    if (int err = set_smem(flash_tc_kernel<HD>, smem)) return err;
    const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H, B);
    flash_tc_kernel<HD><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), qo, kl, H, KV,
        Sq, Sk, causal, scale * kLog2e, qs, ks, vs, os);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, does not synchronize, returns cudaGetLastError().
// q (B, H, Sq, hd), k/v (B, KV, Sk, hd) and o (B, H, Sq, hd), each given by
// its strides in elements (batch, head, seq; the head dim contiguous).
// dtype 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core kernel:
// q, k and v 16-byte aligned with strides a multiple of 8 elements); hd in
// {16, 32, 64, 80, 96, 128}; H % KV == 0; B, H, Sq > 0.  q_offset and kv_lens
// are (B,) int32 on the device, or null for an offset of 0 and every key
// valid; a length is clamped into [1, Sk] and an offset to >= 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int* q_offset,
                               const int* kv_lens, int B, int H, int KV,
                               int Sq, int Sk, int hd, int causal,
                               float scale,
                               long long qsb, long long qsh, long long qss,
                               long long ksb, long long ksh, long long kss,
                               long long vsb, long long vsh, long long vss,
                               long long osb, long long osh, long long oss,
                               int dtype, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 32: return launch<32>(dtype, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 64: return launch<64>(dtype, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 80: return launch<80>(dtype, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 96: return launch<96>(dtype, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 128: return launch<128>(dtype, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
