// decode_attention — one query token per head against a KV cache, for
// Hopper (sm_90a): split-KV flash-decoding.
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention
// (Pallas/TPU): for every (b, h), softmax(q . K[:valid_len[b]] * scale) V
// with an f32 online softmax, masked keys scored NEG_INF = -1e30 and the
// output acc / max(l, 1e-30).
//
// Bound: memory.  Each valid K and V row of the cache is read once and q
// and the output once: B * KV * valid * hd * 2 * itemsize bytes (plus q/o)
// over the card's memory bandwidth.  The arithmetic is ~4 operations per
// cache element, far below the card's ~295 operations per byte.  What keeps
// a kernel from that bound is too little parallelism and too few bytes in
// flight: one block per (b, KV head) is 64 blocks at llama's serve shape
// on 132 SMs, each walking its keys serially.
//
// Design: two kernels, launched back to back by one call.
//   * Pass 1, decode_split_kernel: grid (splits, B * KV, head chunks).  The
//     keys are cut into splits whose length the wrapper picks from S, the
//     cache's capacity (kernel.py::split_keys), never from valid_len, so
//     the host reads nothing back.  A block whose first key is at or past
//     min(valid_len[b], S) returns at once (the block loads valid_len[b]
//     itself, the TPU's scalar prefetch), so only the valid prefix is read.
//   * A block serves all H/KV query heads of its KV head (up to 8 at a
//     time), so each K/V row is read from memory once — the Pallas
//     BlockSpec's `h // g` index map.  The queries, pre-scaled by
//     scale * log2(e), and the f32 accumulators live in registers.
//   * Each lane reads 16 bytes of a K and a V row (hd 64 in bf16: 8 lanes a
//     row, 4 rows per warp instruction; hd 80 and 96: 10 and 12 of a
//     16-lane group, the rest of the group idle), 4
//     rows per lane group in flight before any is used.  Dot products are
//     reduced with shuffles inside the lane group; each lane group keeps
//     its own online softmax over its rows, one rescale per 4 rows.  The
//     groups of a warp merge by shuffles, the 4 warps once through shared
//     memory, and the block writes an f32 partial (m, l, acc[hd]) per (b,
//     h, split) to scratch the wrapper allocates.
//   * Pass 2, decode_combine_kernel: one warp per (b, h) loads valid_len[b],
//     so it knows how many splits were live, rescales their partials to the
//     common max, sums them and divides.
//   * The cache is read in its (B, S, KV, hd) layout through strides (the
//     model's layer of an (L, B, S_max, KV, hd) cache); no transposed copy
//     is made.  16-byte loads when every row is 16-byte aligned (`vec`),
//     else scalar loads of the same elements.
//   * The TPU's (8, hd) query tile (QROWS) is dropped: one row per head.
//   * valid_len == 0 keeps the Pallas kernel's value: every split is live,
//     every key scores the finite -1e30, so every split's max is -1e30,
//     every probability 1, and acc = sum(V[:S]); pass 2 divides that by
//     ceil(S / bk) * bk for the Pallas key block bk, which the wrapper
//     passes as empty_den.  Keys past a split's end score -inf and count
//     for nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;

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

// 16 bytes of a row: one vector load, or the same elements one by one
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r;
  uint32_t* w = &r.x;
  if (sizeof(T) == 4) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(s + i);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __ldg(s + 2 * i) | (static_cast<uint32_t>(__ldg(s + 2 * i + 1))
                                 << 16);
  }
  return r;
}

// element e (a compile-time index after unrolling) of a 16-byte word
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e) {
  const uint32_t* w = &r.x;
  if (sizeof(T) == 4) return __uint_as_float(w[e]);
  const uint32_t x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ valid_len,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int H, int KV, int S, int split, Strides qs, Strides ks,
                    Strides vs, float scale_log2, int vec) {
  constexpr int E = 16 / sizeof(T);        // elements a lane reads of a row
  constexpr int LPR = HD / E;              // lanes a row needs
  constexpr int G = pow2_at_least(LPR);    // lanes a row gets
  static_assert(HD % E == 0 && G <= 32, "head dim");
  constexpr int RPW = 32 / G;              // rows a warp reads at once
  constexpr int U = GT >= 8 ? 2 : 4;       // rows in flight per lane group
  constexpr int kStep = kWarps * RPW;      // rows the block reads at once

  const int nsplit = gridDim.x;
  const int sp = blockIdx.x;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int g = H / KV;
  const int valid = valid_len[b];
  const bool empty = valid <= 0;
  const int n_keys = empty ? S : min(valid, S);
  const int k_begin = sp * split;
  if (k_begin >= n_keys) return;           // past the valid prefix
  const int k_stop = min(k_begin + split, n_keys);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / G;
  const int c = lane % G;                  // 16-byte chunk of the row
  const bool lane_on = c < LPR;
  const int head0 = blockIdx.z * GT;       // first of this block's heads

  float qv[GT][E], m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    const bool on = lane_on && head0 + gi < g;
    const T* qr = q + b * qs.b +
                  static_cast<long long>(kvh * g + head0 + gi) * qs.h + c * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qv[gi][e] = on ? to_f(qr[e]) * scale_log2 : 0.f;
      acc[gi][e] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h + c * E;
  const T* vb = v + b * vs.b + kvh * vs.h + c * E;
  // the trip count is the warp's, not the lane group's: every lane takes
  // part in the shuffles
  for (int base = k_begin + warp * RPW; base < k_stop; base += U * kStep) {
    const int key0 = base + grp;
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key0 + u * kStep;
      if (lane_on && key < k_stop) {
        kr[u] = load16(kb + key * ks.s, vec);
        vr[u] = load16(vb + key * vs.s, vec);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float s[U];
      float smax = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qv[gi][e], elem<T>(kr[u], e), d);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = key0 + u * kStep < k_stop ? (empty ? kNegInf : d) : -INFINITY;
        smax = fmaxf(smax, s[u]);
      }
      const float mn = fmaxf(m[gi], smax);
      const float alpha = exp2f(m[gi] - mn);
      m[gi] = mn;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[u] - mn);
        psum += p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[gi][e] = fmaf(p, elem<T>(vr[u], e), acc[gi][e]);
      }
      l[gi] = l[gi] * alpha + psum;
    }
  }

  // the lane groups of a warp merge: lanes c, c + G, ... hold one chunk
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float a = exp2f(m[gi] - mn), bo = exp2f(mo - mn);
      m[gi] = mn;
      l[gi] = l[gi] * a + lo * bo;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * a + ao * bo;
      }
    }

  // the warps merge through shared memory
  __shared__ float s_m[kWarps][GT], s_l[kWarps][GT];
  __shared__ float s_acc[kWarps][GT][HD];
  if (grp == 0 && lane_on) {
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][gi][c * E + e] = acc[gi][e];
      if (c == 0) {
        s_m[warp][gi] = m[gi];
        s_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < GT * HD; i += kThreads) {
    const int gi = i / HD, d = i % HD;
    if (head0 + gi >= g) continue;
    float mx = s_m[0][gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][gi]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = exp2f(s_m[w][gi] - mx);
      a = fmaf(s_acc[w][gi][d], sc, a);
      lsum = fmaf(s_l[w][gi], sc, lsum);
    }
    const long long row =
        static_cast<long long>(b * H + kvh * g + head0 + gi) * nsplit + sp;
    part_acc[row * HD + d] = a;
    if (d == 0) {
      part_ml[2 * row] = mx;
      part_ml[2 * row + 1] = lsum;
    }
  }
}

// one warp per (b, h): the live splits' partials, rescaled and summed
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ valid_len, T* __restrict__ out,
                      int B, int H, int S, int hd, int split, int nsplit,
                      Strides os, float empty_den) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * H) return;
  const int b = row / H, h = row % H;
  const int valid = valid_len[b];
  const bool empty = valid <= 0;
  const int n_keys = empty ? S : min(valid, S);
  const int live = (n_keys + split - 1) / split;
  const float* ml = part_ml + 2LL * row * nsplit;
  const float* pa = part_acc + static_cast<long long>(row) * nsplit * hd;

  float mx = -INFINITY;
  for (int i = lane; i < live; i += 32) mx = fmaxf(mx, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float lsum = 0.f;
  for (int i = lane; i < live; i += 32)
    lsum += ml[2 * i + 1] * exp2f(ml[2 * i] - mx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  const float inv = 1.f / (empty ? empty_den : fmaxf(lsum, 1e-30f));
  T* o = out + b * os.b + h * os.h;
  for (int d = lane; d < hd; d += 32) {
    float a = 0.f;
    for (int i = 0; i < live; ++i)
      a = fmaf(pa[i * hd + d], exp2f(ml[2 * i] - mx), a);
    o[d] = from_f<T>(a * inv);
  }
}

template <typename T, int HD, int GT>
void launch_split(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                  const void* v, const int* valid_len, float* ml, float* pa,
                  int H, int KV, int S, int split, Strides qs, Strides ks,
                  Strides vs, float scale_log2, int vec) {
  decode_split_kernel<T, HD, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, ml, pa, H, KV, S, split, qs, ks,
      vs, scale_log2, vec);
}

template <typename T, int HD>
void launch_heads(int gt, dim3 grid, cudaStream_t stream, const void* q,
                  const void* k, const void* v, const int* valid_len,
                  float* ml, float* pa, int H, int KV, int S, int split,
                  Strides qs, Strides ks, Strides vs, float scale_log2,
                  int vec) {
  switch (gt) {
    case 1: return launch_split<T, HD, 1>(grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, scale_log2, vec);
    case 2: return launch_split<T, HD, 2>(grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, scale_log2, vec);
    case 4: return launch_split<T, HD, 4>(grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, scale_log2, vec);
    default: return launch_split<T, HD, 8>(grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, scale_log2, vec);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           void* out, float* scratch, int B, int H, int KV, int S, int hd,
           int split, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, float empty_den, int vec, cudaStream_t stream) {
  const int g = H / KV;
  const int gt = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  const int nsplit = (S + split - 1) / split;
  const dim3 grid(nsplit, B * KV, (g + gt - 1) / gt);
  float* ml = scratch;                                    // (B H, nsplit, 2)
  float* pa = scratch + 2LL * B * H * nsplit;             // (B H, nsplit, hd)
  const float sl = scale * kLog2e;
  switch (hd) {
    case 16: launch_heads<T, 16>(gt, grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, sl, vec); break;
    case 32: launch_heads<T, 32>(gt, grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, sl, vec); break;
    case 64: launch_heads<T, 64>(gt, grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, sl, vec); break;
    case 80: launch_heads<T, 80>(gt, grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, sl, vec); break;
    case 96: launch_heads<T, 96>(gt, grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, sl, vec); break;
    case 128: launch_heads<T, 128>(gt, grid, stream, q, k, v, valid_len, ml, pa, H, KV, S, split, qs, ks, vs, sl, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<(B * H + kWarps - 1) / kWarps, kThreads, 0,
                             stream>>>(
      ml, pa, valid_len, static_cast<T*>(out), B, H, S, hd, split, nsplit, os,
      empty_den);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (two kernels), does not synchronize, returns
// cudaGetLastError().  q (B, H, hd), k/v (B, KV, S, hd), out (B, H, hd),
// each given by its strides in elements (batch, seq, head; the head dim
// contiguous; q and out ignore their seq stride); valid_len (B,) int32 on
// the card.  scratch: B * H * ceil(S / split) * (hd + 2) floats on the
// card.  dtype 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 80, 96, 128}.
// vec = 1 when every K/V row is 16-byte aligned.  H % KV == 0,
// B * KV > 0, split > 0.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, void* out,
                                void* scratch, int B, int H, int KV, int S,
                                int hd, int split, long long qsb,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long vsb, long long vss,
                                long long vsh, long long osb, long long osh,
                                float scale, float empty_den, int dtype,
                                int vec, void* stream) {
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, 0, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(q, k, v, vl, out, scr, B, H, KV, S, hd, split, qs,
                         ks, vs, os, scale, empty_den, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vl, out, scr, B, H, KV, S, hd,
                                 split, qs, ks, vs, os, scale, empty_den, vec,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
