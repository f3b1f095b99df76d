// rmsnorm — fused RMSNorm for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm/kernel.py::rmsnorm (Pallas/TPU):
//     y = x * rsqrt(mean(x^2, -1) + eps) * scale
// with the mean of squares and the products in f32 and the result cast
// back to the input type.
//
// Bound: memory.  Each row is read once and written once and the scale is
// read once, so the least time is (2 * rows * D + D) * itemsize / the
// card's memory bandwidth; the arithmetic is ~4 operations per element.
//
// Design: one block per row (rows are short: D = 2048 on llama3.2-1b), so
// the reduction never leaves the block.  The threads stride over the row
// in 16-byte words (8 bf16 or 4 f32 per load), neighbouring threads on
// neighbouring addresses; the f32 sum of squares is reduced by warp
// shuffles and then across the block's warps in shared memory.  The second
// pass re-reads the row (it is still in L1/L2) and scales it.  Rows whose
// start is not 16-byte aligned (D * itemsize not a multiple of 16) take
// the scalar loop instead.  The TPU kernel's 256-row blocks were for its
// sequential grid; here every row is its own block and the card runs
// them in parallel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

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

// Sum of v over the block; every thread gets the same value (the warps'
// partials are added in the same order by all of them).
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) total += red[w];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int D, float eps, int vec) {
  __shared__ float red[kMaxThreads / 32];
  constexpr int E = 16 / sizeof(T);           // elements per 16-byte word
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < D / E; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
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
      uint4 xraw = xv[i], wraw = wv[i], out;
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* we = reinterpret_cast<const T*>(&wraw);
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < E; ++j) oe[j] = from_f<T>(to_f(xe[j]) * inv * to_f(we[j]));
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      yr[i] = from_f<T>(to_f(xr[i]) * inv * to_f(w[i]));
    }
  }
}

}  // namespace

// Launches on `stream`, does not synchronize, returns cudaGetLastError().
// x, y: (rows, D) contiguous; w: (D,); dtype 0 = float32, 1 = bfloat16;
// vec = 1 when x, w, y are 16-byte aligned and D * itemsize % 16 == 0;
// threads a multiple of 32, at most 256; rows > 0.
extern "C" int rmsnorm(const void* x, const void* w, void* y, long long rows,
                       int D, float eps, int dtype, int vec, int threads,
                       void* stream) {
  const dim3 grid(static_cast<unsigned int>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), D, eps, vec);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), D, eps, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
