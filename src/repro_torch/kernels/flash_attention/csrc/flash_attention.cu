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
// TFLOP/s (bf16) and those bytes at 3.35 TB/s.  This first kernel runs its
// products as f32 FMAs on the CUDA cores (67 TFLOP/s peak) from shared
// memory, so it cannot come near that bound; mma/wgmma tiles, TMA loads
// and a persistent grid are later work.
//
// Design:
//   * One block per (b, h, 64-row q tile); a loop over 64-key tiles inside
//     the block replaces the TPU's sequential grid axis.  Q stays in
//     shared memory for the block's life; each K/V tile is staged in shared
//     memory as f32; the running max, sum and the accumulator live in f32
//     registers (4 rows x hd/16 dims per thread).
//   * GQA: the block reads KV head h / (H / KV); nothing is repeated.
//   * The inputs are read through their strides, so the model's (B, S, H,
//     hd) layout needs no transposed copy and no padding: the ragged last
//     q and k tiles are masked here (out-of-range rows load as zeros and
//     are not stored).
//   * Under causal masking the k tiles wholly above the block's last row
//     position (q_offset[b] + q0 + 63) are skipped, and so are tiles wholly
//     at or past kv_len[b].  That is exact: kv_len[b] is clamped into
//     [1, Sk] and q_offset[b] to >= 0, so every row has key 0 valid in the
//     first tile, and a skipped tile would only have contributed
//     exp(-1e30 - m) = 0.
//   * Thread (tr, tc) of 16 x 16 owns rows tr + 16 i and score columns
//     tc + 16 j (i, j < 4) and output dims tc + 16 u; shared rows are
//     padded by one float so these reads are free of bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // keys per tile
constexpr float kNegInf = -1e30f;

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

struct Strides {          // in elements; the head dim has stride 1
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                          kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
             int H, int KV, int Sq, int Sk, int causal, float scale,
             Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int U = HD / 16;             // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;                      // kBQ x (HD + 1)
  float* sK = sQ + kBQ * (HD + 1);       // kBK x (HD + 1)
  float* sV = sK + kBK * (HD + 1);       // kBK x HD
  float* sP = sV + kBK * HD;             // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  // row r of this batch sits at position qoff + r; keys at or past kvl are
  // masked (see the tile-skip note above for the clamps)
  const int qoff = q_offset != nullptr ? max(q_offset[b], 0) : 0;
  const int kvl = kv_lens != nullptr ? min(max(kv_lens[b], 1), Sk) : Sk;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    sQ[r * (HD + 1) + d] =
        row < Sq ? to_f(qb[static_cast<long long>(row) * qs.s + d]) : 0.f;
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
  if (causal) k_end = min(k_end, qoff + q0 + kBQ);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = to_f(kb[static_cast<long long>(key) * ks.s + d]);
        vv = to_f(vb[static_cast<long long>(key) * vs.s + d]);
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
        sP[(tr + 16 * i) * (kBK + 1) + tc + 16 * j] = p;
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

    for (int c = 0; c < kBK; ++c) {
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) vv[u] = sV[c * HD + tc + 16 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tr + 16 * i) * (kBK + 1) + c];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[i][u] = fmaf(p, vv[u], acc[i][u]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < U; ++u)
      ob[static_cast<long long>(row) * os.s + tc + 16 * u] =
          from_f<T>(acc[i][u] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* q_offset, const int* kv_lens, int B, int H, int KV,
           int Sq, int Sk, int causal, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), q_offset, kv_lens, H, KV,
      Sq, Sk, causal, scale, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             const int* qo, const int* kl, int B, int H, int KV, int Sq,
             int Sk, int causal, float scale, Strides qs, Strides ks,
             Strides vs, Strides os, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, qo, kl, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 32: return launch<T, 32>(q, k, v, o, qo, kl, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 64: return launch<T, 64>(q, k, v, o, qo, kl, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 80: return launch<T, 80>(q, k, v, o, qo, kl, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case 128: return launch<T, 128>(q, k, v, o, qo, kl, B, H, KV, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`, does not synchronize, returns cudaGetLastError().
// q (B, H, Sq, hd), k/v (B, KV, Sk, hd) and o (B, H, Sq, hd), each given by
// its strides in elements (batch, head, seq; the head dim contiguous).
// dtype 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 80, 128}; H % KV == 0;
// B, H, Sq > 0.  q_offset and kv_lens are (B,) int32 on the device, or null
// for an offset of 0 and every key valid; a length is clamped into [1, Sk]
// and an offset to >= 0.
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
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, q_offset, kv_lens, B, H, KV, Sq,
                           Sk, causal, scale, qs, ks, vs, os, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, q_offset, kv_lens, B, H,
                                   KV, Sq, Sk, causal, scale, qs, ks, vs, os,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
