// ssd_chunks — the Mamba2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan/kernel.py::ssd_chunks (Pallas/TPU): for
// every (batch b, chunk c, head h) tile of Q steps,
//   cum    = cumsum(dtA)                                   (Q,)     f32
//   y_diag = ((C B^T) o L) (dt * x),  L = tril(exp(cum_i - cum_j))  (Q, hd)
//   state  = (dt * x)^T (B o exp(cum_last - cum))          (hd, N)  f32
// where B and C (Q, N) are shared by every head of the chunk (one group).
//
// Bound: per chunk the scores C B^T are Q(Q+1)/2 causal pairs of N
// products, shared by the heads, and each head adds Q(Q+1)/2 * hd products
// for y_diag and Q * hd * N for its state; the bytes are x and y, B and C,
// dt, dtA and cum, and the f32 states.  At mamba2's shapes (Q = 256, N =
// 128, hd = 64, 64 heads) that is ~1.4 GFLOP against ~9 MB a chunk, far
// above the card's ~295 operations per byte, so the tensor cores' 989
// TFLOP/s set the least time.  This first kernel runs its products as f32
// FMAs on the CUDA cores (67 TFLOP/s peak) and recomputes the scores for
// every head, so it is far from that bound; mma/wgmma tiles, TMA loads and
// scores shared across heads are later work.
//
// Design:
//   * Two __global__ functions, launched one after the other on the
//     caller's stream by one entry point (one wrapper call).
//   * ssd_y_kernel: one block per (b, c, 64-row query tile, h).  The 64
//     rows of C stay in shared memory for the block's life; a loop over
//     64-key tiles up to the diagonal (tiles above it are never visited)
//     stages B, x and dt of the tile, forms the 64 x 64 scores with f32
//     FMAs, weights entry (i, j) by exp(cum_i - cum_j) * dt_j — evaluated
//     only for j <= i, so the exp never sees a positive argument and
//     nothing above the diagonal is multiplied by a masked inf — and
//     accumulates P x in registers (4 rows x ceil(hd/16) dims per thread).
//     Each block forms the chunk's cum over all Q steps with a block scan
//     in shared memory; the first query tile's block writes it out.
//   * ssd_state_kernel: one block per (b, c, 64-column slice of N, h).  A
//     loop over 64-step tiles stages x * dt * exp(cum_last - cum) and B and
//     accumulates the (hd, 64) slice in registers.  It reads the cum that
//     ssd_y_kernel wrote (same stream, launched after it).
//   * Inputs are read through their strides, so the model's (B, S, nh, hd)
//     layout needs no transposed copy; the ragged edges (Q not a multiple
//     of 64, hd or N not a multiple of 16) load as zeros and are not
//     stored.  Any Q from 1 to 1024, hd <= 128, N <= 256.
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

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct S4 {               // (batch, chunk, head, step) strides, in elements
  long long b, c, h, q;
};
struct S3 {               // (batch, chunk, step) strides of B and C
  long long b, c, q;
};

// cum[i] = dtA[0] + ... + dtA[i] for i < Q into sCum: each thread sums a
// run of ceil(Q / 256) steps, then the runs' totals are scanned across
// warps.  Ends with a barrier.
__device__ void block_cumsum(const float* __restrict__ dtA, long long stride,
                             int Q, float* sCum, float* sWarp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (Q + kThreads - 1) / kThreads;
  const int i0 = min(tid * per, Q), i1 = min(i0 + per, Q);
  float run = 0.f;
  for (int i = i0; i < i1; ++i) {
    run += dtA[i * stride];
    sCum[i] = run;
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
  for (int i = i0; i < i1; ++i) sCum[i] += add;
  __syncthreads();
}

size_t y_smem_bytes(int Q, int hd, int N) {
  return sizeof(float) * (static_cast<size_t>(Q) + kWarps + kT +
                          2 * kT * (N + 1) + kT * hd + kT * (kT + 1));
}

size_t state_smem_bytes(int hd) {
  return sizeof(float) * (kT + kT * hd + kT * kSlice);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ dtA, const T* __restrict__ Bm,
             const T* __restrict__ Cm, T* __restrict__ y,
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

  block_cumsum(dtA + b * das.b + c * das.c + h * das.h, das.q, Q, sCum,
               sWarp);
  if (qt == 0) {
    float* out = cum + (static_cast<long long>(bc) * gridDim.y + h) * Q;
    for (int i = tid; i < Q; i += kThreads) out[i] = sCum[i];
  }

  const T* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const float* dtb = dt + b * dts.b + c * dts.c + h * dts.h;
  const T* bb = Bm + b * bs.b + c * bs.c;
  const T* cb = Cm + b * cs.b + c * cs.c;

  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N, n = i % N;
    const int row = q0 + r;
    sC[r * ldn + n] = row < Q ? to_f(cb[row * cs.q + n]) : 0.f;
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
      sB[j * ldn + n] = key < Q ? to_f(bb[key * bs.q + n]) : 0.f;
    }
    for (int i = tid; i < kT * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int key = k0 + j;
      sX[j * hd + d] = key < Q ? to_f(xb[key * xs.q + d]) : 0.f;
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

  T* yb = y + b * ys.b + c * ys.c + h * ys.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Q) continue;
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      const int d = tc + 16 * u;
      if (u < U && d < hd) yb[row * ys.q + d] = from_f<T>(acc[i][u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const float* __restrict__ cum,
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
  const T* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const float* dtb = dt + b * dts.b + c * dts.c + h * dts.h;
  const T* bb = Bm + b * bs.b + c * bs.c;

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
      sX[j * hd + d] = key < Q ? to_f(xb[key * xs.q + d]) * sW[j] : 0.f;
    }
    for (int i = tid; i < kT * kSlice; i += kThreads) {
      const int j = i / kSlice, n = i % kSlice;
      const int key = k0 + j;
      sB[j * kSlice + n] =
          key < Q && n0 + n < N ? to_f(bb[key * bs.q + n0 + n]) : 0.f;
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

template <typename T>
int launch(const void* x, const float* dt, const float* dtA, const void* Bm,
           const void* Cm, void* y, float* state, float* cum, int B, int nc,
           int nh, int Q, int hd, int N, S4 xs, S4 dts, S4 das, S3 bs, S3 cs,
           S4 ys, cudaStream_t stream) {
  const size_t ysm = y_smem_bytes(Q, hd, N);
  const size_t ssm = state_smem_bytes(hd);
  int err = allow_smem(ssd_y_kernel<T>, ysm);
  if (err) return err;
  err = allow_smem(ssd_state_kernel<T>, ssm);
  if (err) return err;
  const long long bcs = static_cast<long long>(B) * nc;
  const dim3 ygrid(static_cast<unsigned>(bcs * ((Q + kT - 1) / kT)), nh);
  ssd_y_kernel<T><<<ygrid, kThreads, ysm, stream>>>(
      static_cast<const T*>(x), dt, dtA, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), cum, nc, Q, hd, N, xs,
      dts, das, bs, cs, ys);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 sgrid(static_cast<unsigned>(bcs * ((N + kSlice - 1) / kSlice)),
                   nh);
  ssd_state_kernel<T><<<sgrid, kThreads, ssm, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(Bm), cum, state,
      nc, Q, hd, N, xs, dts, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both kernels on `stream`, does not synchronize, returns the
// first CUDA error.  x (B, nc, nh, Q, hd), dt and dtA (B, nc, nh, 1, Q) f32,
// Bm and Cm (B, nc, Q, N), y (B, nc, nh, Q, hd) in x's dtype, each given by
// its strides in elements, 22 of them in `st`: x (b, c, h, q), dt (b, c, h,
// q), dtA (b, c, h, q), Bm (b, c, q), Cm (b, c, q), y (b, c, h, q); the last
// dim of x, Bm, Cm and y has stride 1.  state (B, nc, nh, hd, N) and cum
// (B, nc, nh, 1, Q) are contiguous f32.  dtype 0 = float32, 1 = bfloat16
// (x, Bm, Cm and y); 1 <= Q <= 1024, 1 <= hd <= 128, 1 <= N <= 256;
// B, nc, nh > 0.
extern "C" int ssd_chunks(const void* x, const float* dt, const float* dtA,
                          const void* Bm, const void* Cm, void* y,
                          float* state, float* cum, int B, int nc, int nh,
                          int Q, int hd, int N, const long long* st,
                          int dtype, void* stream) {
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
    return launch<float>(x, dt, dtA, Bm, Cm, y, state, cum, B, nc, nh, Q, hd,
                         N, xs, dts, das, bs, cs, ys, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, dtA, Bm, Cm, y, state, cum, B, nc,
                                 nh, Q, hd, N, xs, dts, das, bs, cs, ys, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
