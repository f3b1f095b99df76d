// decode_attention — one query token per head against a KV cache, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention
// (Pallas/TPU): for every (b, h), softmax(q . K[:valid_len[b]] * scale) V
// with an f32 online softmax, masked keys scored NEG_INF = -1e30 and the
// output acc / max(l, 1e-30).
//
// Bound: memory.  Each valid K and V row of the cache is read once and q
// and the output once: B * KV * valid * hd * 2 * itemsize bytes (plus q/o)
// over the card's memory bandwidth.  The arithmetic is ~4 operations per
// cache element, far below the card's ~295 operations per byte.
//
// Design:
//   * One block per (b, KV head).  The block computes all H/KV query heads
//     of its group, so each K/V row is read from memory once — the Pallas
//     BlockSpec's `h // g` index map, without its per-head re-read.
//   * The block loads valid_len[b] itself (the TPU's scalar prefetch) and
//     loops only over keys < min(valid_len, S): it reads nothing past the
//     valid prefix, where the TPU kernel still DMA'd every block.
//   * The cache is read in its (B, S, KV, hd) layout through strides (the
//     model's layer of an (L, B, S_max, KV, hd) cache); no transposed copy
//     is made, where ops.decode_mha in JAX transposes the cache every step.
//   * Keys come in tiles of 32 (one per lane): the tile is staged in shared
//     memory as f32 (16-byte loads when the rows are aligned), scores are
//     one (head, key) pair per thread, each warp runs the online softmax of
//     one head with shuffles, and the f32 accumulator lives in shared
//     memory, one (head, dim) element per thread and step.
//   * The TPU's (8, hd) query tile (QROWS) is dropped: one row per head.
//   * valid_len == 0 keeps the Pallas kernel's value: every score is the
//     finite -1e30, every probability 1, and the output is
//     sum(V[:S]) / (ceil(S / bk) * bk) for its key block bk — the wrapper
//     passes that denominator as empty_den.
// Split-KV (flash-decoding across blocks), TMA and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;          // keys per tile: one per lane
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

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
  long long b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              T* __restrict__ out, int H, int KV, int S, int hd,
              Strides qs, Strides ks, Strides vs, Strides os, float scale,
              float empty_den, int vec) {
  extern __shared__ float smem[];
  const int g = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int kstride = hd + 1;            // padded: conflict-free score reads
  float* sq = smem;                      // g x hd       queries
  float* sk = sq + g * hd;               // kTile x (hd + 1)
  float* sv = sk + kTile * kstride;      // kTile x hd
  float* sp = sv + kTile * hd;           // g x kTile    scores, then probs
  float* sacc = sp + g * kTile;          // g x hd       accumulator
  float* sm = sacc + g * hd;             // g            running max
  float* sl = sm + g;                    // g            running sum
  float* salpha = sl + g;                // g            this tile's rescale

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int valid = valid_len[b];
  const bool empty = valid <= 0;
  const int n_keys = empty ? S : min(valid, S);

  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd, d = i % hd;
    sq[i] = to_f(q[b * qs.b + static_cast<long long>(kvh * g + gi) * qs.h + d]);
    sacc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    sm[i] = kNegInf;
    sl[i] = 0.f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    const int nk = min(kTile, n_keys - k0);
    __syncthreads();                     // the previous tile is consumed
    if (vec) {
      constexpr int E = 16 / sizeof(T);
      const int words = hd / E;
      for (int i = tid; i < nk * words; i += kThreads) {
        const int j = i / words, c = i % words;
        const long long key = k0 + j;
        uint4 kraw = reinterpret_cast<const uint4*>(kb + key * ks.s)[c];
        uint4 vraw = reinterpret_cast<const uint4*>(vb + key * vs.s)[c];
        const T* ke = reinterpret_cast<const T*>(&kraw);
        const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sk[j * kstride + c * E + e] = to_f(ke[e]);
          sv[j * hd + c * E + e] = to_f(ve[e]);
        }
      }
    } else {
      for (int i = tid; i < nk * hd; i += kThreads) {
        const int j = i / hd, d = i % hd;
        const long long key = k0 + j;
        sk[j * kstride + d] = to_f(kb[key * ks.s + d]);
        sv[j * hd + d] = to_f(vb[key * vs.s + d]);
      }
    }
    __syncthreads();

    // scores: one (head, key) pair per thread and step
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, j = i % kTile;
      float s = -INFINITY;               // past the tile: probability 0
      if (j < nk) {
        if (empty) {
          s = kNegInf;
        } else {
          float acc = 0.f;
          const float* qr = sq + gi * hd;
          const float* kr = sk + j * kstride;
          for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
          s = acc * scale;
        }
      }
      sp[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head, lane j = key j of the tile
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      const float s = sp[gi * kTile + lane];
      float tmax = s;
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = sm[gi];
      const float m_new = fmaxf(m_prev, tmax);
      const float p = expf(s - m_new);
      float psum = p;
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      sp[gi * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        salpha[gi] = alpha;
        sl[gi] = sl[gi] * alpha + psum;
        sm[gi] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * hd; i += kThreads) {
      const int gi = i / hd, d = i % hd;
      const float* pr = sp + gi * kTile;
      float a = sacc[i] * salpha[gi];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], sv[j * hd + d], a);
      sacc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd, d = i % hd;
    const float l = empty ? empty_den : fmaxf(sl[gi], 1e-30f);
    out[b * os.b + static_cast<long long>(kvh * g + gi) * os.h + d] =
        from_f<T>(sacc[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           void* out, int B, int H, int KV, int S, int hd, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, float empty_den,
           int vec, cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(g) * hd * 2 + kTile * (hd + 1) + kTile * hd +
       g * kTile + 3 * g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len),
      static_cast<T*>(out), H, KV, S, hd, qs, ks, vs, os, scale, empty_den,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, does not synchronize, returns cudaGetLastError().
// q (B, H, hd), k/v (B, KV, S, hd), out (B, H, hd), each given by its
// strides in elements (batch, seq, head; the head dim contiguous; q and out
// ignore their seq stride); valid_len (B,) int32 on the card.  dtype 0 =
// float32, 1 = bfloat16.  vec = 1 when every K/V row is 16-byte aligned.
// H % KV == 0, B * KV > 0.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, void* out, int B,
                                int H, int KV, int S, int hd, long long qsb,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long vsb, long long vss,
                                long long vsh, long long osb, long long osh,
                                float scale, float empty_den, int dtype,
                                int vec, void* stream) {
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, 0, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, valid_len, out, B, H, KV, S, hd, qs, ks, vs,
                         os, scale, empty_den, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid_len, out, B, H, KV, S, hd, qs,
                                 ks, vs, os, scale, empty_den, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
