// Decode attention for one new token over a dense head-major KV cache.
//
// Replaces the TPU kernel megatron_llm_tpu/kernels/flash_decode.py:
// _decode_kernel (via flash_decode -> _decode_call).  Same function:
//   out[b, h] = softmax(q[b, h] . K[b, h/g, :len_b]^T * scale) V[b, h/g, :len_b]
// with fp32 scores, fp32 online softmax and fp32 accumulation; columns at or
// past the row's fill len_b get exactly zero weight.
//
// What bounds it on the H100: bytes.  Each (row, kv-head) reads its cache up
// to the fill once (2 * len * d elements) and does 4 * g * len * d flops on
// them: at g <= 8 that is under 8 flop/byte against the card's ~295, so the
// kernel can only be as fast as it streams K and V.
//
// Design for that:
// - one block per (row, kv-head); the g query heads of the GQA group are the
//   block's query rows, so each K/V element is read once for all g of them
//   (the TPU kernel does the same with the group as its q rows);
// - the walk stops at the row's own fill instead of masking a full
//   max_len walk: past the fill the TPU kernel's mask gives exactly zero
//   weight, so the output is the same and the bytes are the fill's;
// - a group of LANES threads owns one cache row at a time, each thread
//   loading 16 contiguous bytes, so a warp reads whole 128-byte lines; the
//   256 threads keep U rows per lane group in flight to cover latency;
// - every lane group runs its own online softmax over its rows; the groups'
//   partial (max, sum, acc) states are merged once at the end through shared
//   memory in a fixed order (deterministic).
// A row with fill 0 (no caller passes one: the decode call site passes
// cache_len + 1) gets what the TPU kernel's finite -1e30 mask gives it:
// every cache row scores the same, so the output is the mean of V over
// max_len.  The kernel walks the whole cache with zero scores there.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ out, int n_heads, int kv_heads,
                    int max_len, int group, float scale) {
  constexpr int VN = Vec16<T>::N;          // elements per 16-byte access
  constexpr int LANES = D / VN;            // threads covering one row
  constexpr int NGRP = kThreads / LANES;   // lane groups per block
  constexpr int U = (G >= 8) ? 2 : 4;      // rows in flight per lane group
  static_assert(LANES <= 32 && (32 % LANES) == 0, "row must fit a warp");

  const int bi = blockIdx.x / kv_heads;
  const int hk = blockIdx.x % kv_heads;
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  int len = lens[bi];
  const bool uniform = len <= 0;  // fill 0: equal scores over max_len
  len = (uniform || len > max_len) ? max_len : len;

  const size_t cache_off = ((size_t)bi * kv_heads + hk) * max_len * D;
  const T* kp = k + cache_off + lane * VN;
  const T* vp = v + cache_off + lane * VN;

  float qf[G][VN];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < group) {
      const T* qr = q + ((size_t)bi * n_heads + hk * group + r) * D + lane * VN;
      Vec16<T>::load(qr, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) qf[r][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][VN];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[r][e] = 0.f;
  }

  // every thread runs the same number of iterations (len is per block), so
  // the shuffles below always see the whole warp
  for (int it = 0; it < len; it += NGRP * U) {
    const int base = it + grp * U;
    // issue every K and V load of this step before using any of them
    float kf[U][VN], vf[U][VN];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u < len) {
        Vec16<T>::load(kp + (size_t)(base + u) * D, kf[u]);
        Vec16<T>::load(vp + (size_t)(base + u) * D, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e) part = fmaf(qf[r][e], kf[u][e], part);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u][r] = (base + u < len) ? (uniform ? 0.f : part * scale)
                                      : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      if (mx == -INFINITY) continue;  // nothing live yet in this group
      const float alpha = __expf(m[r] - mx);  // exp(-inf) = 0 on first hit
      float psum = 0.f;
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = __expf(s[u][r] - mx);
        psum += p[u];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[r][e] = a;
      }
    }
  }

  // merge the lane groups' partial states, one query row at a time
  __shared__ float sm_m[NGRP];
  __shared__ float sm_l[NGRP];
  __shared__ float sm_acc[NGRP][D];
  for (int r = 0; r < group && r < G; ++r) {
    // (r < G keeps the register arrays statically indexed after unrolling)
    float mr = -INFINITY, lr = 0.f, ar[VN];
#pragma unroll
    for (int rr = 0; rr < G; ++rr) {
      if (rr == r) {
        mr = m[rr];
        lr = l[rr];
#pragma unroll
        for (int e = 0; e < VN; ++e) ar[e] = acc[rr][e];
      }
    }
    if (lane == 0) {
      sm_m[grp] = mr;
      sm_l[grp] = lr;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) sm_acc[grp][lane * VN + e] = ar[e];
    __syncthreads();
    if (threadIdx.x < D) {
      float mtot = -INFINITY;
      for (int g2 = 0; g2 < NGRP; ++g2) mtot = fmaxf(mtot, sm_m[g2]);
      float ltot = 0.f, o = 0.f;
      if (mtot != -INFINITY) {
        for (int g2 = 0; g2 < NGRP; ++g2) {
          if (sm_m[g2] == -INFINITY) continue;
          const float w = __expf(sm_m[g2] - mtot);
          ltot = fmaf(sm_l[g2], w, ltot);
          o = fmaf(sm_acc[g2][threadIdx.x], w, o);
        }
      }
      const float res = ltot > 0.f ? o / ltot : 0.f;
      T* orow = out + ((size_t)bi * n_heads + hk * group + r) * D;
      orow[threadIdx.x] = static_cast<T>(res);
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* lens, void* out, int b, int n_heads,
                     int kv_heads, int max_len, int group, float scale,
                     cudaStream_t stream) {
  dim3 grid(b * kv_heads);
#define FD_LAUNCH(GV)                                                       \
  flash_decode_kernel<T, D, GV><<<grid, kThreads, 0, stream>>>(             \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), lens, static_cast<T*>(out), n_heads,        \
      kv_heads, max_len, group, scale)
  if (group <= 1) FD_LAUNCH(1);
  else if (group <= 2) FD_LAUNCH(2);
  else if (group <= 4) FD_LAUNCH(4);
  else if (group <= 8) FD_LAUNCH(8);
  else return cudaErrorInvalidValue;
#undef FD_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* lens, void* out, int b, int n_heads,
                     int kv_heads, int max_len, int d, int group, float scale,
                     cudaStream_t stream) {
  if (d == 64)
    return launch_g<T, 64>(q, k, v, lens, out, b, n_heads, kv_heads, max_len,
                           group, scale, stream);
  if (d == 128)
    return launch_g<T, 128>(q, k, v, lens, out, b, n_heads, kv_heads,
                            max_len, group, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, n_heads, d], k/v [b, kv_heads, max_len, d], lens int32 [b] (rows to
// attend, new token included), out [b, n_heads, d]; all contiguous, one
// dtype.  Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int b,
                                   int n_heads, int kv_heads, int max_len,
                                   int d, float scale, int dtype,
                                   void* stream) {
  if (b <= 0 || kv_heads <= 0 || n_heads % kv_heads != 0)
    return cudaErrorInvalidValue;
  const int group = n_heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  switch (dtype) {
    case kFloat32:
      return launch_d<float>(q, k, v, ln, out, b, n_heads, kv_heads, max_len,
                             d, group, scale, s);
    case kBFloat16:
      return launch_d<__nv_bfloat16>(q, k, v, ln, out, b, n_heads, kv_heads,
                                     max_len, d, group, scale, s);
    case kFloat16:
      return launch_d<__half>(q, k, v, ln, out, b, n_heads, kv_heads, max_len,
                              d, group, scale, s);
  }
  return cudaErrorInvalidValue;
}
