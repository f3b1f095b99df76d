// rmsnorm — fused RMSNorm for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm/kernel.py::rmsnorm (Pallas/TPU):
//     y = x * rsqrt(mean(x^2, -1) + eps) * scale
// with the mean of squares and the products in f32 and the result
// rounded to nearest even back to the input type.
//
// Bound: memory.  Each row is read once and written once and the scale is
// read once, so the least time is (2 * rows * D + D) * itemsize / the
// card's memory bandwidth; the arithmetic is ~4 operations per element.
// At the decode shape (8 rows) that bound is tens of nanoseconds, so a
// launch's fixed cost and one trip to memory are the whole time there.
//
// Design: one pass with the row held in registers, so x is read from
// memory once and nothing reads it again; bit for bit the results of the
// one-block-a-row kernel it replaced (256 threads at most, each summing
// every 256th 16-byte word, then a second pass re-reading the row), whose
// reduction order the row path keeps.  kernel.py::_plan picks the path and
// the launch shape:
//
//   row     16-byte aligned rows of up to 8 words a thread: a CTA a row,
//           the old kernel's V threads folded F to a thread (V / F
//           threads), so a thread holds F x W of the row's 16-byte words
//           and the scale's beside them.  The squares are summed, each
//           warp's by shuffles, then the warps' sums once through shared
//           memory (double-buffered by row parity, so one barrier a row).
//           The grid is persistent: at most about 64 warps an SM, each CTA
//           looping over the rows with the scale kept in registers.  Few
//           rows take F = 1 (the most threads a row: one row's latency is
//           the whole time), more rows F = 2 (two words in flight a thread
//           where one would hold one; above 2048 rows, every width).
//   strided rows that are not 16-byte aligned, or longer: the old kernel,
//           a block a row striding over it twice.
//
// A warp a row (no barrier, several rows a CTA) and folds of 4 and 8 were
// tried too: a warp's serial work on a 2048-3072 element row made it
// slower up to 1024 rows and it only tied at 4096, and the deeper folds
// lost at every row count of the 2560 and 3072 widths, so neither is kept
// (PERF.md).  Loads go through the read-only path (__ldg); stores are
// plain, so y stays in L2 for the product that reads it next.  The TPU
// kernel's 256-row blocks were for its sequential grid; here the rows are
// spread over the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStridedThreads = 256;  // at most, strided path

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ss plus the squares of one 16-byte word's elements, added one by one in
// element order (the one-block-a-row kernel's running sum).
template <typename T>
__device__ __forceinline__ float word_sumsq(float ss, const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) {
    const float f = to_f(e[j]);
    ss += f * f;
  }
  return ss;
}

// (x * inv) * w element by element, as the plain version multiplies.
template <typename T>
__device__ __forceinline__ uint4 word_scale(const uint4& xraw, const uint4& wraw,
                                            float inv) {
  uint4 out;
  const T* xe = reinterpret_cast<const T*>(&xraw);
  const T* we = reinterpret_cast<const T*>(&wraw);
  T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) {
    oe[j] = from_f<T>(to_f(xe[j]) * inv * to_f(we[j]));
  }
  return out;
}

// A CTA a row, the row in registers.  The reduction is the one-block-a-row
// kernel's, of V = F * blockDim.x threads: virtual thread v sums the
// squares of words v, v + V, v + 2V, ... element by element into one
// running f32 sum, each warp of virtual threads reduces by the shuffle
// butterfly, and the warps' sums are added in warp order.  Thread t plays
// the virtual threads t + j * blockDim.x (j < F), so its lane is theirs
// and one butterfly a j reduces their warps; F * W words a thread.  So y
// is bit for bit the one-block-a-row kernel's at every plan.
template <typename T, int F, int W>
__global__ void __launch_bounds__(256)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ y, long long rows, int words, int D, float eps) {
  __shared__ float red[2][8];   // the V / 32 <= 8 virtual warps' sums
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int V = F * nthreads;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 wr[F][W];
#pragma unroll
  for (int j = 0; j < F; ++j) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int k = tid + j * nthreads + i * V;
      if (k < words) wr[j][i] = __ldg(wv + k);
    }
  }
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * D);
    uint4 xr[F][W];
#pragma unroll
    for (int j = 0; j < F; ++j) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int k = tid + j * nthreads + i * V;
        if (k < words) xr[j][i] = __ldg(xv + k);
      }
    }
#pragma unroll
    for (int j = 0; j < F; ++j) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (tid + j * nthreads + i * V < words) ss = word_sumsq<T>(ss, xr[j][i]);
      }
      ss = warp_sum(ss);
      // red[parity] is written again two rows on, after every thread has
      // passed the next row's barrier, so after it read this row's sums
      if (lane == 0) red[parity][warp + j * nwarps] = ss;
    }
    __syncthreads();
    float total = 0.f;
    for (int v = 0; v < F * nwarps; ++v) total += red[parity][v];
    parity ^= 1;
    const float inv = rsqrtf(total / static_cast<float>(D) + eps);
    uint4* yv = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
    for (int j = 0; j < F; ++j) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int k = tid + j * nthreads + i * V;
        if (k < words) yv[k] = word_scale<T>(xr[j][i], wr[j][i], inv);
      }
    }
  }
}

// Sum of v over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int i = 0; i < nwarps; ++i) total += red[i];
  return total;
}

// A block a row, two strided passes; 16-byte words when vec, else scalars.
template <typename T>
__global__ void __launch_bounds__(kStridedThreads)
rmsnorm_strided(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int D, float eps, int vec) {
  __shared__ float red[kStridedThreads / 32];
  constexpr int E = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < D / E; i += blockDim.x) ss = word_sumsq<T>(ss, xv[i]);
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < D / E; i += blockDim.x) {
      yv[i] = word_scale<T>(xv[i], wv[i], inv);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      yr[i] = from_f<T>(to_f(xr[i]) * inv * to_f(w[i]));
    }
  }
}

__global__ void rmsnorm_empty_kernel() {}

template <typename T>
int launch(const void* xp, const void* wp, void* yp, long long rows, int D,
           float eps, int path, int vec, int fold, int wpv, int threads,
           int grid, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* y = static_cast<T*>(yp);
  const int words = static_cast<int>(static_cast<long long>(D) * sizeof(T) / 16);
  if (path == 0) {
    switch (fold * 16 + wpv) {
#define RMSNORM_ROWS(F, W)                                                   \
  case F * 16 + W:                                                           \
    rmsnorm_rows<T, F, W><<<grid, threads, 0, s>>>(x, w, y, rows, words, D,  \
                                                   eps);                     \
    break;
      RMSNORM_ROWS(1, 1) RMSNORM_ROWS(1, 2) RMSNORM_ROWS(1, 4) RMSNORM_ROWS(1, 8)
      RMSNORM_ROWS(2, 1) RMSNORM_ROWS(2, 2) RMSNORM_ROWS(2, 4)
#undef RMSNORM_ROWS
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (path == 1) {
    rmsnorm_strided<T><<<static_cast<unsigned int>(rows), threads, 0, s>>>(
        x, w, y, D, eps, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, does not synchronize, returns cudaGetLastError().
// x, y: (rows, D) contiguous; w: (D,); dtype 0 = float32, 1 = bfloat16;
// path 0 = row, 1 = strided, with fold (F), wpv (W: words a virtual
// thread), threads and grid as kernel.py::_plan gives them (strided: grid =
// rows, vec = 1 when x, w, y are 16-byte aligned and D * itemsize % 16 ==
// 0); rows > 0.
extern "C" int rmsnorm(const void* x, const void* w, void* y, long long rows,
                       int D, float eps, int dtype, int path, int vec, int fold,
                       int wpv, int threads, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, w, y, rows, D, eps, path, vec, fold, wpv, threads,
                         grid, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, y, rows, D, eps, path, vec, fold, wpv,
                                 threads, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One empty kernel on `stream`: the launch floor that rmsnorm's times are
// read against (the same ctypes path, no memory touched).
extern "C" int rmsnorm_empty(void* stream) {
  rmsnorm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
