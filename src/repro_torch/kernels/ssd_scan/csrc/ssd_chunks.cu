// ssd_chunks — the Mamba2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan/kernel.py::ssd_chunks (Pallas/TPU): for
// every (batch b, chunk c, head h) tile of Q steps,
//   cum    = cumsum(dtA)                                   (Q,)     f32
//   y_diag = ((C B^T) o L) (dt * x),  L = tril(exp(cum_i - cum_j))  (Q, hd)
//   state  = (dt * x)^T (B o exp(cum_last - cum))          (hd, N)  f32
// where B and C (Q, N) are shared by every head of the chunk (one group).
//
// Bound: bytes, at every shape the models run.  Per chunk the scores C B^T
// are Q(Q+1)/2 causal pairs of N products, shared by the heads, and each
// head adds Q(Q+1)/2 * hd products for y_diag and Q * hd * N for its state:
// at mamba2's widths (Q = 256, N = 128, hd = 64, 64 heads) ~547 MFLOP
// against ~6.4 MB a chunk (x and y in bf16, B and C, dt, dtA and cum, and
// the f32 states), 85 operations a byte, well under the card's ~295, so
// HBM's 3.35 TB/s sets the least time (chip_smoke.py's ssd_bound).
//
// Two kernels, chosen by dtype (a dispatch, not a fallback: a bf16 input
// never reaches the FMA kernels):
//
// bf16 (serving): ssd_tc_kernel, every product on the tensor cores.
//   * One launch, two roles.  A y block takes (b, c, 64-row query tile, a
//     group of G heads), one warpgroup a head; a state block takes (b, c,
//     the same head group, 128 columns of N at hd <= 64, else 64).  The
//     state blocks come first in the grid and the y blocks follow, longest
//     query tiles first.
//   * G = 4 heads a block for head dims up to 64 (512 threads), 2 above
//     (the y accumulator doubles).  At the serve shape (B = 1, four chunks
//     of 256, so four query tiles) mamba2's 64 heads give 16 groups: 256 y
//     blocks and 64 state blocks, enough to fill 132 SMs; G = 8 would
//     leave 128 y blocks, fewer than the SMs.  zamba2's 80 heads give 20
//     groups.  A head count that G does not divide leaves the last
//     group's spare warpgroups helping with the scores and storing nothing.
//   * Scores shared across the group: per 64-key tile up to the diagonal,
//     the y block forms the 64 x 64 scores C B^T once (wgmma m64n16k16, C
//     and B both K-major from shared memory, warpgroup wg taking the 16-key
//     slices wg, wg + G, ...) and writes them to shared memory in
//     accumulator order (a 36-float slot per thread, free of bank
//     conflicts); every warpgroup reads its fragment back and applies it to
//     its own head.  C B^T is thus formed once per G heads, not per head.
//   * y = P x as register-A wgmma (m64n{hd}k16) with x the B operand read
//     MN-major, flash_attention's P-in-registers path.  P = S o exp(cum_i -
//     cum_j) dt_j: on the diagonal tile the exp is evaluated only on and
//     below the diagonal, so it never sees a positive argument; below it,
//     exp(cum_i - cum_ref) exp(cum_ref - cum_j) with cum_ref the key tile's
//     last step, the key factor (times dt_j) formed once per key, so a
//     thread makes two exps a tile instead of 32.  One bf16 P would lose
//     the y checks (about one bf16 ulp of P times |x|, summed over up to Q
//     keys), so P is split into hi = bf16(P) and lo = bf16(P - hi) and both
//     products go into one f32 accumulator: ~16 significant bits of P, the
//     bf16 x exact.  y leaves through the warpgroup's spent x tile, so its
//     stores are 16 bytes a lane.
//   * The state, as (x w)^T B with w_j = dt_j exp(cum_last - cum_j): each
//     warpgroup turns its head's staged x tile into x w, split into bf16 hi
//     and lo, in the same layout (16 bytes in, two 16-byte stores out), and
//     adds both products with A = (x w)^T read MN-major from those tiles
//     and the B tile read MN-major (its rows as they are), wgmma
//     m64n64k16, one accumulator tile per 64 head-dim rows and 64 columns
//     of N.  The block forms cum itself from dtA, so there is no round trip
//     through global memory and no order between the roles.
//   * Loads: dtA and dt go to registers first, then 64-row tiles go
//     through a two-stage ring filled with 16-byte cp.async copies into the
//     no-swizzle core-matrix layout (8 x 16 B core matrices, 128 contiguous
//     bytes each), the next key tile in flight while this one is
//     multiplied; x, B and C are read through the strides the wrapper
//     passes, with no transposed copy.  Rows that are not 16-byte aligned
//     (hd or N not a multiple of 8, odd strides) are staged element by
//     element into the same layout (the wrapper's `vec` flag).
//   * Ragged edges: Q not a multiple of 64, hd not a multiple of 16 and N
//     not a multiple of 16 load as zeros and are not stored, so one path
//     covers every shape the wrapper takes (Q <= 1024, hd <= 128, N <= 256),
//     the head dim padded to 16, 32, 64, 80 or 128.
//   The copies of the next tile are issued by the threads that compute,
//   and under load their issue takes about as long as a tile's products.
//   A producer warp issuing every copy behind mbarriers was tried and was
//   slower: one warp issues them no faster, and its 17th warp cuts the
//   consumers to 96 registers (spills) or the group to 3 heads.  Not done:
//   TMA tensor copies (descriptors encoded on the host every call), a
//   persistent grid.
//
// f32 (the card tests and the smoke models' logits checks): f32 FMAs on
// the CUDA cores, where the tensor cores would be TF32.
//   * ssd_y_kernel: one block per (b, c, 64-row query tile, h).  C stays in
//     shared memory; a loop over 64-key tiles up to the diagonal stages B,
//     x and dt, forms the scores, weights them (only j <= i) and
//     accumulates P x in registers.  Each block forms the chunk's cum with
//     a block scan; the first query tile's block writes it out.
//   * ssd_state_kernel: one block per (b, c, 64-column slice of N, h),
//     reading the cum ssd_y_kernel wrote (same stream, launched after it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;             // query rows per block, keys per tile
constexpr int kSlice = 64;         // state columns (of N) per block
constexpr int kMaxU = 8;           // dims per thread: hd <= 128
constexpr int kMaxQ = 1024;
constexpr int kMaxN = 256;

struct S4 {               // (batch, chunk, head, step) strides, in elements
  long long b, c, h, q;
};
struct S3 {               // (batch, chunk, step) strides of B and C
  long long b, c, q;
};

// cum[i] = dtA[0] + ... + dtA[i] for i < Q into sCum[i * ostride] (both
// strides in floats): each thread sums a run of ceil(Q / THREADS) steps,
// then the runs' totals are scanned across warps.  dtA may be sCum itself
// (a scan in place).  Ends with a barrier.
template <int THREADS>
__device__ void block_cumsum(const float* dtA, long long stride,
                             int Q, float* sCum, int ostride, float* sWarp) {
  constexpr int kWarps = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (Q + THREADS - 1) / THREADS;
  const int i0 = min(tid * per, Q), i1 = min(i0 + per, Q);
  float run = 0.f;
  for (int i = i0; i < i1; ++i) {
    run += dtA[i * stride];
    sCum[i * ostride] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) sWarp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < kWarps ? sWarp[lane] : 0.f;
    float wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += up;
    }
    if (lane < kWarps) sWarp[lane] = wi - w;     // exclusive over warps
  }
  __syncthreads();
  const float add = sWarp[warp] + (incl - run);  // everything before i0
  for (int i = i0; i < i1; ++i) sCum[i * ostride] += add;
  __syncthreads();
}

size_t y_smem_bytes(int Q, int hd, int N) {
  return sizeof(float) * (static_cast<size_t>(Q) + kWarps + kT +
                          2 * kT * (N + 1) + kT * hd + kT * (kT + 1));
}

size_t state_smem_bytes(int hd) {
  return sizeof(float) * (kT + kT * hd + kT * kSlice);
}

__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ dtA, const float* __restrict__ Bm,
             const float* __restrict__ Cm, float* __restrict__ y,
             float* __restrict__ cum, int nc, int Q, int hd, int N, S4 xs,
             S4 dts, S4 das, S3 bs, S3 cs, S4 ys) {
  extern __shared__ float smem[];
  const int ldn = N + 1;                 // odd row pitch for even N
  float* sCum = smem;                    // Q
  float* sWarp = sCum + Q;               // kWarps
  float* sDt = sWarp + kWarps;           // kT
  float* sC = sDt + kT;                  // kT x ldn
  float* sB = sC + kT * ldn;             // kT x ldn
  float* sX = sB + kT * ldn;             // kT x hd
  float* sP = sX + kT * hd;              // kT x (kT + 1)

  const int tiles = (Q + kT - 1) / kT;
  const int qt = blockIdx.x % tiles;
  const int bc = blockIdx.x / tiles;
  const int b = bc / nc, c = bc % nc;
  const int h = blockIdx.y;
  const int q0 = qt * kT;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int U = (hd + 15) / 16;

  block_cumsum<kThreads>(dtA + b * das.b + c * das.c + h * das.h, das.q, Q,
                         sCum, 1, sWarp);
  if (qt == 0) {
    float* out = cum + (static_cast<long long>(bc) * gridDim.y + h) * Q;
    for (int i = tid; i < Q; i += kThreads) out[i] = sCum[i];
  }

  const float* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const float* dtb = dt + b * dts.b + c * dts.c + h * dts.h;
  const float* bb = Bm + b * bs.b + c * bs.c;
  const float* cb = Cm + b * cs.b + c * cs.c;

  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N, n = i % N;
    const int row = q0 + r;
    sC[r * ldn + n] = row < Q ? cb[row * cs.q + n] : 0.f;
  }

  float acc[4][kMaxU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) acc[i][u] = 0.f;

  const int k_end = min(Q, q0 + kT);     // causal: no key past the last row
  for (int k0 = 0; k0 < k_end; k0 += kT) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < kT * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const int key = k0 + j;
      sB[j * ldn + n] = key < Q ? bb[key * bs.q + n] : 0.f;
    }
    for (int i = tid; i < kT * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int key = k0 + j;
      sX[j * hd + d] = key < Q ? xb[key * xs.q + d] : 0.f;
    }
    if (tid < kT) sDt[tid] = k0 + tid < Q ? dtb[(k0 + tid) * dts.q] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sC[(tr + 16 * i) * ldn + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[(tc + 16 * j) * ldn + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tc + 16 * j;
        float p = 0.f;
        if (key <= row && row < Q)       // on or below the diagonal only
          p = s[i][j] * expf(sCum[row] - sCum[key]) * sDt[tc + 16 * j];
        sP[r * (kT + 1) + tc + 16 * j] = p;
      }
    }
    __syncthreads();

    const int kn = min(kT, Q - k0);
    for (int j = 0; j < kn; ++j) {
      float xv[kMaxU];
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int d = tc + 16 * u;
        xv[u] = (u < U && d < hd) ? sX[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tr + 16 * i) * (kT + 1) + j];
#pragma unroll
        for (int u = 0; u < kMaxU; ++u)
          if (u < U) acc[i][u] = fmaf(p, xv[u], acc[i][u]);
      }
    }
  }

  float* yb = y + b * ys.b + c * ys.c + h * ys.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Q) continue;
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      const int d = tc + 16 * u;
      if (u < U && d < hd) yb[row * ys.q + d] = acc[i][u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ cum,
                 float* __restrict__ state, int nc, int Q, int hd, int N,
                 S4 xs, S4 dts, S3 bs) {
  extern __shared__ float smem[];
  float* sW = smem;                      // kT: dt_j exp(cum_last - cum_j)
  float* sX = sW + kT;                   // kT x hd: x * w
  float* sB = sX + kT * hd;              // kT x kSlice

  const int slices = (N + kSlice - 1) / kSlice;
  const int sl = blockIdx.x % slices;
  const int bc = blockIdx.x / slices;
  const int b = bc / nc, c = bc % nc;
  const int h = blockIdx.y;
  const int n0 = sl * kSlice;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;               // dims ty + 16 a
  const int tx = tid & 15;               // columns n0 + tx + 16 e
  const int U = (hd + 15) / 16;

  const long long tile = static_cast<long long>(bc) * gridDim.y + h;
  const float* cp = cum + tile * Q;
  const float last = cp[Q - 1];
  const float* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const float* dtb = dt + b * dts.b + c * dts.c + h * dts.h;
  const float* bb = Bm + b * bs.b + c * bs.c;

  float acc[kMaxU][4];
#pragma unroll
  for (int a = 0; a < kMaxU; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

  for (int k0 = 0; k0 < Q; k0 += kT) {
    __syncthreads();                     // the previous tile is consumed
    if (tid < kT) {
      const int key = k0 + tid;
      sW[tid] = key < Q ? dtb[key * dts.q] * expf(last - cp[key]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kT * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int key = k0 + j;
      sX[j * hd + d] = key < Q ? xb[key * xs.q + d] * sW[j] : 0.f;
    }
    for (int i = tid; i < kT * kSlice; i += kThreads) {
      const int j = i / kSlice, n = i % kSlice;
      const int key = k0 + j;
      sB[j * kSlice + n] =
          key < Q && n0 + n < N ? bb[key * bs.q + n0 + n] : 0.f;
    }
    __syncthreads();

    const int kn = min(kT, Q - k0);
    for (int j = 0; j < kn; ++j) {
      float xv[kMaxU], bv[4];
#pragma unroll
      for (int a = 0; a < kMaxU; ++a) {
        const int d = ty + 16 * a;
        xv[a] = (a < U && d < hd) ? sX[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[e] = sB[j * kSlice + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < kMaxU; ++a) {
        if (a >= U) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(xv[a], bv[e], acc[a][e]);
      }
    }
  }

  float* sb = state + tile * hd * N;
#pragma unroll
  for (int a = 0; a < kMaxU; ++a) {
    const int d = ty + 16 * a;
    if (a >= U || d >= hd) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + tx + 16 * e;
      if (n < N) sb[static_cast<long long>(d) * N + n] = acc[a][e];
    }
  }
}

template <typename F>
int allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kSlot = 36;          // floats per thread slot of the score tile
constexpr float kLog2e = 1.4426950408889634f;

// heads per block (one warpgroup each) for a padded head dim: four up to 64
// (512 threads, 128 registers each), two above (y's accumulator doubles)
template <int HDP>
__host__ __device__ constexpr int heads_per_block() { return HDP <= 64 ? 4 : 2; }

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory writes (cp.async or plain stores), made visible to wgmma
// (the async proxy)
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

// D (64 x 16, f32) (+)= A (64 x 16, smem) * B (16 x 16, smem), both K-major:
// one 16-key slice of the scores C B^T
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, smem, MN-major) * B (16 x 64, smem,
// MN-major): the state, 64 of its head-dim rows by 64 columns of N
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, smem,
// MN-major), N = the padded head dim: y += P x
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 pairs hi = bf16(v) and lo = bf16(v - hi): hi + lo carries
// ~16 significant bits of the f32 value, so two bf16 products stand in for
// one f32 product
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

struct Args {
  const bf16* x;
  const float* dt;
  const float* dtA;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* state;
  float* cum;
  int Bsz, nc, nh, Q, hd, N;
  int vec;             // every row 16-byte aligned, hd and N multiples of 8
  S4 xs, dts, das;
  S3 bs, cs;
  S4 ys;
};

// a 64-row tile of a (rows, width) bf16 matrix into the no-swizzle
// core-matrix layout with a row pitch of W elements (W a multiple of 8):
// element (r, col) at byte (r / 8) 16 W + (col / 8) 128 + (r % 8) 16 +
// (col % 8) 2, so an 8 x 8 core matrix is 128 contiguous bytes.  Rows
// row0 + r at or past `limit` and columns col0 + col at or past `width`
// load as zeros.  vec: 16-byte cp.async copies, copy i landing at byte 16 i
// (no bank conflicts), the thread's (8-row group, chunk) stepped without a
// division; else element by element.
template <int THREADS>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const bf16* src,
                                           long long rs, int row0, int limit,
                                           int col0, int width, int W,
                                           bool vec, int tid) {
  const int C = W / 8;
  if (vec) {
    // copy i = tid + k THREADS: row (i % 8) + 8 (i / 8C), chunk (i / 8) % C
    constexpr int kStep = THREADS / 8;
    const int sc = kStep % C, sg = kStep / C;
    int c8 = (tid >> 3) % C, g8 = (tid >> 3) / C;
    const int r8 = tid & 7;
    for (int i = tid; i < 64 * C; i += THREADS) {
      const int row = row0 + r8 + 8 * g8;
      const int col = col0 + 8 * c8;
      const bool ok = row < limit && col < width;
      cp_async16(dst + 16 * i, src + (ok ? row * rs + col : 0), ok);
      c8 += sc;
      g8 += sg;
      if (c8 >= C) {
        c8 -= C;
        ++g8;
      }
    }
  } else {
    bf16* d = reinterpret_cast<bf16*>(dst);
    for (int i = tid; i < 64 * W; i += THREADS) {
      const int r = i / W, c = i % W;
      const int row = row0 + r, col = col0 + c;
      const bf16 v = row < limit && col < width ? src[row * rs + col]
                                                : __float2bfloat16(0.f);
      d[(r >> 3) * 8 * W + (c >> 3) * 64 + (r & 7) * 8 + (c & 7)] = v;
    }
  }
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// shared memory of the two roles (bytes); the block takes the larger
template <int HDP>
__host__ __device__ size_t tc_y_smem(int Q, int N) {
  constexpr int G = heads_per_block<HDP>();
  const int np = round_up(N, 16);
  return static_cast<size_t>(64 * np * 2) * 3 +      // C, two B stages
         static_cast<size_t>(2 * G * 64 * HDP * 2) +    // two x stages
         128 * kSlot * 4 + G * 64 * 4 +       // the score tile, key factors
         static_cast<size_t>(G * round_up(Q, 4) * 8) + 64 * 4;
}

// 64-column slices of N a state block covers: two at hd <= 64 (two
// accumulator tiles), so x is staged once for 128 columns, else one
template <int HDP>
__host__ __device__ constexpr int state_slices() { return HDP <= 64 ? 2 : 1; }

template <int HDP>
__host__ __device__ size_t tc_state_smem(int Q) {
  constexpr int G = heads_per_block<HDP>();
  return 2 * 64 * 64 * state_slices<HDP>() * 2 +         // two B stages
         static_cast<size_t>(2 * G * 64 * HDP * 2) +     // two x stages
         static_cast<size_t>(2 * G * 64 * HDP * 2) +     // x w, hi and lo
         1024 +                // read (never used) past the last x w tile
         static_cast<size_t>(G * round_up(Q, 4) * 8) + 64 * 4;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// (dtA, dt) of the group's heads, loaded into registers (a dead head, past
// nh, gets zeros) before the block issues its first tile copies, so the
// loads' latency and the copies overlap; K = ceil(1024 / THREADS) steps a
// head a thread
template <int THREADS, int G>
struct Steps {
  static constexpr int K = (1024 + THREADS - 1) / THREADS;
  float2 v[G][K];

  __device__ __forceinline__ void load(const Args& a, int b, int c, int h0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool ok = h0 + g < a.nh;
      const float* pa = a.dtA + b * a.das.b + c * a.das.c + (h0 + g) * a.das.h;
      const float* pd = a.dt + b * a.dts.b + c * a.dts.c + (h0 + g) * a.dts.h;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = threadIdx.x + k * THREADS;
        v[g][k] = ok && j < a.Q ? make_float2(pa[j * a.das.q], pd[j * a.dts.q])
                                : make_float2(0.f, 0.f);
      }
    }
  }

  // into sCD (head g at g * Qr), then each head's cum scanned in place in
  // .x.  Ends with a barrier.
  __device__ __forceinline__ void scan(int Q, int Qr, float2* sCD,
                                       float* sWarp) const {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = threadIdx.x + k * THREADS;
        if (j < Q) sCD[g * Qr + j] = v[g][k];
      }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      float* cg = &sCD[g * Qr].x;
      block_cumsum<THREADS>(cg, 2, Q, cg, 2, sWarp);
    }
  }
};

// y_diag and cum for (b, c, 64-row query tile qt, heads h0 .. h0 + G - 1):
// warpgroup wg owns head h0 + wg's 64 x hd accumulator.  Per key tile up to
// the diagonal the scores C B^T are formed once for the G heads (warpgroup
// wg computes the 16-key slices wg, wg + G, ...) and handed to every
// warpgroup through shared memory in accumulator order; each warpgroup then
// weights them by its head's decay and dt and adds P x.
template <int HDP>
__device__ __forceinline__ void tc_y_role(const Args& a, unsigned char* smem,
                                          int b, int c, int qt, int h0) {
  constexpr int G = heads_per_block<HDP>();
  constexpr int THREADS = 128 * G;
  constexpr int XT = 64 * HDP * 2;            // bytes of one x tile
  constexpr uint32_t RGX = 16 * HDP;          // x: bytes between 8-row groups
  const int Q = a.Q, Qr = round_up(Q, 4);
  const int np = round_up(a.N, 16);
  const int BT = 64 * np * 2;                 // bytes of one B or C tile
  const uint32_t RGB = 16 * np;
  unsigned char* sC = smem;
  unsigned char* sB = sC + BT;                // two stages
  unsigned char* sX = sB + 2 * BT;            // two stages of G tiles
  float* sS = reinterpret_cast<float*>(sX + 2 * G * XT);
  float* sF = sS + 128 * kSlot;               // G x 64 key factors
  float2* sCD = reinterpret_cast<float2*>(sF + G * 64);  // G x Qr
  float* sWarp = reinterpret_cast<float*>(sCD + G * Qr);

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int h = h0 + wg;
  const bool live = h < a.nh;
  const int q0 = 64 * qt;
  const int bc = b * a.nc + c;
  const bool vec = a.vec != 0;

  const bf16* cb = a.Cm + b * a.cs.b + c * a.cs.c;
  const bf16* bb = a.Bm + b * a.bs.b + c * a.bs.c;
  const bf16* xb = a.x + b * a.xs.b + c * a.xs.c;
  auto stage_keys = [&](int t) {
    const int st = t & 1;
    stage_tile<THREADS>(sB + st * BT, bb, a.bs.q, 64 * t, Q, 0, a.N, np, vec,
                        tid);
    for (int g = 0; g < G; ++g)
      if (h0 + g < a.nh)
        stage_tile<THREADS>(sX + (st * G + g) * XT, xb + (h0 + g) * a.xs.h,
                            a.xs.q, 64 * t, Q, 0, a.hd, HDP, vec, tid);
  };
  Steps<THREADS, G> steps;
  steps.load(a, b, c, h0);
  stage_tile<THREADS>(sC, cb, a.cs.q, q0, Q, 0, a.N, np, vec, tid);
  stage_keys(0);
  cp_async_commit();

  // (cum, dt) per step; the first query tile's block writes cum out, then
  // cum is kept times log2(e) for exp2
  steps.scan(Q, Qr, sCD, sWarp);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* out = a.cum + (static_cast<long long>(bc) * a.nh + h0 + g) * Q;
    const bool put = qt == 0 && h0 + g < a.nh;
    for (int j = tid; j < Q; j += THREADS) {
      const float cv = sCD[g * Qr + j].x;
      if (put) out[j] = cv;
      sCD[g * Qr + j].x = cv * kLog2e;
    }
  }

  // the thread's rows of every accumulator fragment: r and r + 8
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  const int row0 = q0 + r, row1 = row0 + 8;
  const float2* cd = sCD + wg * Qr;
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

  const int n_tiles = qt + 1;                 // keys up to the diagonal
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();                      // tile it (and C) has landed
    fence_proxy_async();
    __syncthreads();                          // ... for every thread; and
                                              // tile it - 1 is consumed
    if (it + 1 < n_tiles) stage_keys(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const int k0 = 64 * it;

    // scores: this warpgroup's 16-key slices of the 64 x 64 tile
    for (int sl = wg; sl < 4; sl += G) {
      float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      wgmma_fence();
      for (int kk = 0; kk < np / 16; ++kk)
        wgmma_ss_n16(s8, wgmma_desc(sC + kk * 256, 128, RGB),
                     wgmma_desc(sB + st * BT + sl * 2 * RGB + kk * 256, 128,
                                RGB),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s8);
      // keys 16 sl + 8 j + 2 t + e are columns J = 2 sl + j of the slot
      float4* slot = reinterpret_cast<float4*>(sS + wtid * kSlot);
      slot[2 * sl] = make_float4(s8[0], s8[1], s8[2], s8[3]);
      slot[2 * sl + 1] = make_float4(s8[4], s8[5], s8[6], s8[7]);
    }
    // below the diagonal exp(cum_i - cum_j) = exp(cum_i - cum_ref) exp(cum_ref
    // - cum_j) with cum_ref the tile's last step: the key factors (times
    // dt_j) once per key, two row factors per thread, instead of an exp per
    // (row, key).  Where cum falls (dtA <= 0, as Mamba2's A < 0 and dt > 0
    // make it) neither factor exceeds 1.
    const float c_ref = cd[k0 + 63 < Q ? k0 + 63 : Q - 1].x;
    if (live && it < qt && wtid < 64) {
      const float2 v = cd[k0 + wtid];
      sF[wg * 64 + wtid] = ex2(c_ref - v.x) * v.y;
    }
    __syncthreads();
    if (!live) continue;                      // warpgroup-uniform

    // s[4J + e] is (row r, key k0 + 8J + 2t + e), s[4J + 2 + e] row r + 8
    float s[32];
    const float4* slot = reinterpret_cast<const float4*>(sS + wtid * kSlot);
#pragma unroll
    for (int J = 0; J < 8; ++J) {
      const float4 v = slot[J];
      s[4 * J] = v.x;
      s[4 * J + 1] = v.y;
      s[4 * J + 2] = v.z;
      s[4 * J + 3] = v.w;
    }
    // P = S o exp(cum_i - cum_j) dt_j on and below the diagonal only, so
    // the exp never sees a positive argument; rows past Q (never stored)
    // take the last step's cum
    const float c0 = cd[min(row0, Q - 1)].x, c1 = cd[min(row1, Q - 1)].x;
    if (it < qt) {                            // wholly below the diagonal
      const float e0 = ex2(c0 - c_ref), e1 = ex2(c1 - c_ref);
      const float* f = sF + wg * 64 + 2 * t;
#pragma unroll
      for (int J = 0; J < 8; ++J) {
        const float2 fk = *reinterpret_cast<const float2*>(f + 8 * J);
        s[4 * J] *= e0 * fk.x;
        s[4 * J + 1] *= e0 * fk.y;
        s[4 * J + 2] *= e1 * fk.x;
        s[4 * J + 3] *= e1 * fk.y;
      }
    } else {                                  // the diagonal tile: exact
#pragma unroll
      for (int J = 0; J < 8; ++J)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * J + 2 * t + e;
          const float2 v = key < Q ? cd[key] : make_float2(0.f, 0.f);
          s[4 * J + e] = key <= row0 ? s[4 * J + e] * ex2(c0 - v.x) * v.y
                                     : 0.f;
          s[4 * J + 2 + e] =
              key <= row1 ? s[4 * J + 2 + e] * ex2(c1 - v.x) * v.y : 0.f;
        }
    }
    // P as the A operand, hi and lo: keys 16 kk .. 16 kk + 15 are columns
    // 2 kk and 2 kk + 1, already in the A fragment's order
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], phi[kk][i],
                   plo[kk][i]);
    const unsigned char* tX = sX + (st * G + wg) * XT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = wgmma_desc(tX + kk * 2 * RGX, RGX, 128);
      WgmmaRS<HDP>::run(acc, phi[kk], dx);
      WgmmaRS<HDP>::run(acc, plo[kk], dx);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  if (!live) return;

  bf16* yb = a.y + b * a.ys.b + c * a.ys.c + h * a.ys.h;
  if (vec) {
    // through this warpgroup's own x tile of stage 0 (free: its last
    // product has completed, no copy is pending) in the tile layout, so
    // the stores to y are 16 bytes a lane, rows of 64 or more bytes
    unsigned char* tY = sX + wg * XT;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(
            tY + ((r >> 3) + half) * RGX + j * 128 + (r & 7) * 16 + 4 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                  acc[4 * j + 2 * half + 1]);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int C = HDP / 8;
    for (int i = wtid; i < 64 * C; i += 128) {
      const int row = q0 + (i & 7) + 8 * (i / (8 * C));
      const int col = 8 * ((i >> 3) % C);
      if (row < Q && col < a.hd)
        *reinterpret_cast<uint4*>(yb + row * a.ys.q + col) =
            *reinterpret_cast<const uint4*>(tY + 16 * i);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (row >= Q || col >= a.hd) continue;
      bf16* p = yb + row * a.ys.q + col;
      p[0] = __float2bfloat16(v0);
      if (col + 1 < a.hd) p[1] = __float2bfloat16(v1);
    }
  }
}

// the chunk state for (b, c, heads h0 .. h0 + G - 1, columns n0 .. n0 + 64
// NS - 1 of N), as (x w)^T B with w_j = dt_j exp(cum_last - cum_j): per 64-key
// tile, warpgroup wg turns its head's staged x tile into x w, split into
// bf16 hi and lo, in the same layout (16 bytes in, 2 x 16 out, no bank
// conflicts), and adds both products, A = (x w)^T read MN-major from those
// tiles (head-dim rows; two 64-row tiles above hd 64) against the B tile
// read MN-major (its rows as they are).  The block forms cum itself, so
// nothing waits on the y role.
template <int HDP>
__device__ __forceinline__ void tc_state_role(const Args& a,
                                              unsigned char* smem, int b,
                                              int c, int h0, int n0) {
  constexpr int G = heads_per_block<HDP>();
  constexpr int THREADS = 128 * G;
  constexpr int MT = (HDP + 63) / 64;
  constexpr int NS = state_slices<HDP>();
  constexpr int XT = 64 * HDP * 2;
  constexpr int CX = HDP / 8;                 // 16-byte chunks in a row
  constexpr int BT = 64 * 64 * NS * 2;        // bytes of one B tile
  constexpr uint32_t RGX = 16 * HDP;
  constexpr uint32_t RGB = 16 * 64 * NS;
  const int Q = a.Q, Qr = round_up(Q, 4);
  unsigned char* sB = smem;                   // two stages of 64 x 64 NS
  unsigned char* sX = sB + 2 * BT;            // two stages of G tiles
  unsigned char* sA = sX + 2 * G * XT;        // G x (hi, lo), then slack
  float2* sCD = reinterpret_cast<float2*>(sA + 2 * G * XT + 1024);
  float* sWarp = reinterpret_cast<float*>(sCD + G * Qr);

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int h = h0 + wg;
  const bool live = h < a.nh;
  const bool vec = a.vec != 0;

  const bf16* bb = a.Bm + b * a.bs.b + c * a.bs.c;
  const bf16* xb = a.x + b * a.xs.b + c * a.xs.c;
  auto stage_keys = [&](int t) {
    const int st = t & 1;
    stage_tile<THREADS>(sB + st * BT, bb, a.bs.q, 64 * t, Q, n0, a.N,
                        64 * NS, vec, tid);
    for (int g = 0; g < G; ++g)
      if (h0 + g < a.nh)
        stage_tile<THREADS>(sX + (st * G + g) * XT, xb + (h0 + g) * a.xs.h,
                            a.xs.q, 64 * t, Q, 0, a.hd, HDP, vec, tid);
  };
  Steps<THREADS, G> steps;
  steps.load(a, b, c, h0);
  stage_keys(0);
  cp_async_commit();

  // w_j = dt_j exp(cum_last - cum_j) into the .x of (cum, dt)
  steps.scan(Q, Qr, sCD, sWarp);
  float last[G];
#pragma unroll
  for (int g = 0; g < G; ++g) last[g] = sCD[g * Qr + Q - 1].x;
  __syncthreads();                            // every thread has read last
#pragma unroll
  for (int g = 0; g < G; ++g)
    for (int j = tid; j < Q; j += THREADS) {
      const float2 v = sCD[g * Qr + j];
      sCD[g * Qr + j].x = v.y * expf(last[g] - v.x);
    }

  float acc[MT * NS][32];                     // tile (m, slice) at m NS + ns
#pragma unroll
  for (int m = 0; m < MT * NS; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  const float2* wh = sCD + wg * Qr;
  unsigned char* aHi = sA + 2 * wg * XT;
  unsigned char* aLo = aHi + XT;

  const int n_tiles = (Q + 63) / 64;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) stage_keys(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const int k0 = 64 * it;
    if (live) {
      // chunk i of the x tile: key (i % 8) + 8 (i / 8 CX), 8 head dims
      const unsigned char* tX = sX + (st * G + wg) * XT;
      for (int i = wtid; i < 64 * CX; i += 128) {
        const int key = k0 + (i & 7) + 8 * (i / (8 * CX));
        const float w = key < Q ? wh[key].x : 0.f;
        const uint4 xv = *reinterpret_cast<const uint4*>(tX + 16 * i);
        const uint32_t in[4] = {xv.x, xv.y, xv.z, xv.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&in[q]));
          split_bf16(f.x * w, f.y * w, hi[q], lo[q]);
        }
        *reinterpret_cast<uint4*>(aHi + 16 * i) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(aLo + 16 * i) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (!live) continue;
    const unsigned char* tB = sB + st * BT;
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) {
        if (n0 + 64 * ns >= a.N) continue;    // warpgroup-uniform
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db =
              wgmma_desc(tB + kk * 2 * RGB + ns * 1024, RGB, 128);
          const int off = m * 1024 + kk * 2 * RGX;
          wgmma_ss_n64_tt(acc[m * NS + ns], wgmma_desc(aHi + off, RGX, 128),
                          db);
          wgmma_ss_n64_tt(acc[m * NS + ns], wgmma_desc(aLo + off, RGX, 128),
                          db);
        }
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < MT * NS; ++m) fence_regs(acc[m]);
  }
  if (!live) return;

  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  float* sb = a.state + (static_cast<long long>(b * a.nc + c) * a.nh + h) *
                            a.hd * a.N;
#pragma unroll
  for (int m = 0; m < MT * NS; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 64 * (m / NS) + r + 8 * half;
        const int n = n0 + 64 * (m % NS) + 8 * j + 2 * t;
        if (d >= a.hd || n >= a.N) continue;
        const float v0 = acc[m][4 * j + 2 * half];
        const float v1 = acc[m][4 * j + 2 * half + 1];
        float* p = sb + static_cast<long long>(d) * a.N + n;
        if (vec) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (n + 1 < a.N) p[1] = v1;
        }
      }
}

// one launch, two roles: blocks [0, n_state) compute the chunk states
// (b, c, head group, 64 state_slices columns of N), the rest y_diag and cum
// (b, c, head group, query tile), longest query tiles first
template <int HDP>
__global__ void __launch_bounds__(128 * heads_per_block<HDP>())
ssd_tc_kernel(const Args a, int n_state) {
  constexpr int G = heads_per_block<HDP>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int groups = (a.nh + G - 1) / G;
  const int per = a.Bsz * a.nc * groups;
  int idx = blockIdx.x;
  if (idx < n_state) {
    constexpr int NS = state_slices<HDP>();
    const int parts = (a.N + 64 * NS - 1) / (64 * NS);
    const int rest = idx / parts;
    const int grp = rest % groups, bc = rest / groups;
    tc_state_role<HDP>(a, tc_smem, bc / a.nc, bc % a.nc, grp * G,
                       64 * NS * (idx % parts));
  } else {
    idx -= n_state;
    const int tiles = (a.Q + 63) / 64;
    const int qt = tiles - 1 - idx / per;
    const int rest = idx % per;
    const int grp = rest % groups, bc = rest / groups;
    tc_y_role<HDP>(a, tc_smem, bc / a.nc, bc % a.nc, qt, grp * G);
  }
}

template <int HDP>
int launch_tc(const Args& a, cudaStream_t stream) {
  constexpr int G = heads_per_block<HDP>();
  const size_t ys = tc_y_smem<HDP>(a.Q, a.N), ss = tc_state_smem<HDP>(a.Q);
  const size_t smem = ys > ss ? ys : ss;
  int err = allow_smem(ssd_tc_kernel<HDP>, smem);
  if (err) return err;
  const long long groups = (a.nh + G - 1) / G;
  const long long per = static_cast<long long>(a.Bsz) * a.nc * groups;
  constexpr int NS = state_slices<HDP>();
  const long long n_state = per * ((a.N + 64 * NS - 1) / (64 * NS));
  const long long n_y = per * ((a.Q + 63) / 64);
  if (n_state + n_y >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_tc_kernel<HDP><<<static_cast<unsigned>(n_state + n_y), 128 * G, smem,
                       stream>>>(a, static_cast<int>(n_state));
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const float* dt, const float* dtA,
               const void* Bm, const void* Cm, void* y, float* state,
               float* cum, int B, int nc, int nh, int Q, int hd, int N,
               S4 xs, S4 dts, S4 das, S3 bs, S3 cs, S4 ys,
               cudaStream_t stream) {
  const size_t ysm = y_smem_bytes(Q, hd, N);
  const size_t ssm = state_smem_bytes(hd);
  int err = allow_smem(ssd_y_kernel, ysm);
  if (err) return err;
  err = allow_smem(ssd_state_kernel, ssm);
  if (err) return err;
  const long long bcs = static_cast<long long>(B) * nc;
  const dim3 ygrid(static_cast<unsigned>(bcs * ((Q + kT - 1) / kT)), nh);
  ssd_y_kernel<<<ygrid, kThreads, ysm, stream>>>(
      static_cast<const float*>(x), dt, dtA, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), cum, nc, Q, hd,
      N, xs, dts, das, bs, cs, ys);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 sgrid(static_cast<unsigned>(bcs * ((N + kSlice - 1) / kSlice)),
                   nh);
  ssd_state_kernel<<<sgrid, kThreads, ssm, stream>>>(
      static_cast<const float*>(x), dt, static_cast<const float*>(Bm), cum,
      state, nc, Q, hd, N, xs, dts, bs);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_bf16(const void* x, const float* dt, const float* dtA,
                const void* Bm, const void* Cm, void* y, float* state,
                float* cum, int B, int nc, int nh, int Q, int hd, int N,
                S4 xs, S4 dts, S4 das, S3 bs, S3 cs, S4 ys, int vec,
                cudaStream_t stream) {
  const Args a{static_cast<const bf16*>(x), dt, dtA,
               static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
               static_cast<bf16*>(y), state, cum, B, nc, nh, Q, hd, N, vec,
               xs, dts, das, bs, cs, ys};
  return launch_tc<HDP>(a, stream);
}

}  // namespace

// Launches on `stream`, does not synchronize, returns the first CUDA
// error.  x (B, nc, nh, Q, hd), dt and dtA (B, nc, nh, 1, Q) f32, Bm and Cm
// (B, nc, Q, N), y (B, nc, nh, Q, hd) in x's dtype, each given by its
// strides in elements, 22 of them in `st`: x (b, c, h, q), dt (b, c, h,
// q), dtA (b, c, h, q), Bm (b, c, q), Cm (b, c, q), y (b, c, h, q); the last
// dim of x, Bm, Cm and y has stride 1.  state (B, nc, nh, hd, N) and cum
// (B, nc, nh, 1, Q) are contiguous f32.  dtype 0 = float32 (the FMA
// kernels), 1 = bfloat16 (the tensor-core kernel; vec != 0 promises that
// x, Bm, Cm and y are 16-byte aligned, every stride of theirs a multiple of
// 8 elements and hd and N multiples of 8); 1 <= Q <= 1024, 1 <= hd <= 128,
// 1 <= N <= 256; B, nc, nh > 0.
extern "C" int ssd_chunks(const void* x, const float* dt, const float* dtA,
                          const void* Bm, const void* Cm, void* y,
                          float* state, float* cum, int B, int nc, int nh,
                          int Q, int hd, int N, const long long* st,
                          int dtype, int vec, void* stream) {
  if (B < 1 || nc < 1 || nh < 1 || Q < 1 || Q > kMaxQ || hd < 1 ||
      hd > 16 * kMaxU || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const S4 xs{st[0], st[1], st[2], st[3]};
  const S4 dts{st[4], st[5], st[6], st[7]};
  const S4 das{st[8], st[9], st[10], st[11]};
  const S3 bs{st[12], st[13], st[14]};
  const S3 cs{st[15], st[16], st[17]};
  const S4 ys{st[18], st[19], st[20], st[21]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, dt, dtA, Bm, Cm, y, state, cum, B, nc, nh, Q, hd, N,
                      xs, dts, das, bs, cs, ys, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_BF16(HDP)                                                        \
  return launch_bf16<HDP>(x, dt, dtA, Bm, Cm, y, state, cum, B, nc, nh, Q,  \
                          hd, N, xs, dts, das, bs, cs, ys, vec, s)
  if (hd <= 16) SSD_BF16(16);
  if (hd <= 32) SSD_BF16(32);
  if (hd <= 64) SSD_BF16(64);
  if (hd <= 80) SSD_BF16(80);
  SSD_BF16(128);
#undef SSD_BF16
}
