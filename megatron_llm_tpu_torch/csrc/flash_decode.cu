// Decode attention for one new token per row: the decode-attention family
// K8-K11, one device body for all four.
//
// Replaces the TPU kernels of megatron_llm_tpu/kernels/flash_decode.py:
//   K8  flash_decode            (_decode_kernel via _decode_call)
//   K9  flash_decode_int8       (_decode_kernel_int8 via _decode_call)
//   K10 flash_decode_paged      (_decode_kernel via _paged_decode_call)
//   K11 flash_decode_paged_int8 (_decode_kernel_int8 via _paged_decode_call)
// Same function for all:
//   out[b, h] = softmax(q[b, h] . K[b, h/g, :len_b]^T * scale) V[b, h/g, :len_b]
// with fp32 scores, fp32 online softmax and fp32 accumulation; columns at or
// past the row's fill len_b get exactly zero weight.
//
// The cache element is a template parameter: bf16 / fp16 / fp32 (K8, K10),
// or int8 with one fp32 scale per (row, kv head, position) (K9, K11).  The
// int8 variants fold the scales in as the TPU kernel does
// (flash_decode.py:103-126): score = (q . k_int8) * k_scale * softmax_scale,
// and each probability is multiplied by its row's v_scale before it meets
// the int8 V row; the softmax denominator sums the unscaled probabilities.
// No tile is dequantized to bf16 first, and q is widened to fp32.
//
// The row addressing is the other template parameter.  Dense (K8, K9):
// logical row j of (b, kv head) is cache[b, hk, j].  Paged (K10, K11): it is
// pool[table[b, j >> shift], hk, j & (block - 1)], the block size a power of
// two; table entries past the fill (the trash block 0) are never read.
// Everything else (lane groups, rows in flight, the softmax and the merge)
// depends on logical columns only, so a paged call gives the dense call's
// output bit for bit on the same logical cache.
//
// What bounds these on the H100: bytes.  Each (row, kv-head) reads its cache
// up to the fill once (2 * len * d elements, plus 2 * len fp32 scales for
// int8) and does 4 * g * len * d flops on them: at g <= 8 that is under 8
// flop/byte against the card's ~295, so a call can only be as fast as it
// streams K and V.  int8 halves those bytes.
//
// Design for that:
// - one block per (row, kv-head); the g query heads of the GQA group are the
//   block's query rows, so each K/V element is read once for all g of them
//   (the TPU kernel does the same with the group as its q rows);
// - the walk stops at the row's own fill instead of masking a full
//   max_len walk: past the fill the TPU kernel's mask gives exactly zero
//   weight, so the output is the same and the bytes are the fill's (the
//   paged TPU kernel clamps its block walk at the last live block the same
//   way, flash_decode.py:217-225);
// - a group of LANES threads owns one cache row at a time, each thread
//   loading 16 contiguous bytes (8 bf16, or 16 int8: a 128-wide int8 row is
//   8 threads), so a warp reads whole 128-byte lines; the 256 threads keep U
//   rows per lane group in flight to cover latency;
// - every lane group runs its own online softmax over its rows; the groups'
//   partial (max, sum, acc) states are merged once at the end through shared
//   memory in a fixed order (deterministic).
// A row with fill 0 (no caller passes one: the decode call site passes
// cache_len + 1) gets what the TPU kernel's finite -1e30 mask gives it:
// every cache row scores the same, so the output is the mean of V over the
// walked width (max_len, or table width x block when paged).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

// One 16-byte word of cache elements, held in registers, widened to fp32.
template <typename C>
struct Word;

template <>
struct Word<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    o[0] = __uint_as_float(w.x);
    o[1] = __uint_as_float(w.y);
    o[2] = __uint_as_float(w.z);
    o[3] = __uint_as_float(w.w);
  }
};

// bf16 is the top half of an fp32: widening is a shift (exact)
__device__ __forceinline__ void bf16x2(unsigned x, float* o) {
  o[0] = __uint_as_float(x << 16);
  o[1] = __uint_as_float(x & 0xffff0000u);
}

template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    bf16x2(w.x, o);
    bf16x2(w.y, o + 2);
    bf16x2(w.z, o + 4);
    bf16x2(w.w, o + 6);
  }
};

__device__ __forceinline__ void halfx2(unsigned x, float* o) {
  o[0] = __half2float(__ushort_as_half((unsigned short)(x & 0xffffu)));
  o[1] = __half2float(__ushort_as_half((unsigned short)(x >> 16)));
}

template <>
struct Word<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    halfx2(w.x, o);
    halfx2(w.y, o + 2);
    halfx2(w.z, o + 4);
    halfx2(w.w, o + 6);
  }
};

// four signed bytes, lowest address first, sign-extended by an arithmetic
// shift
__device__ __forceinline__ void s8x4(unsigned x, float* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (float)((int)(x << (24 - 8 * i)) >> 24);
}

template <>
struct Word<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    s8x4(w.x, o);
    s8x4(w.y, o + 4);
    s8x4(w.z, o + 8);
    s8x4(w.w, o + 12);
  }
};

template <typename C>
__device__ __forceinline__ uint4 load_word(const C* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Every operand of one launch.  width is the logical cache width: max_len
// for a dense cache, n_tbl << shift for a paged one.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;     // int8 only: [.., width] row scales
  const float* vs;
  const int* lens;     // [b] rows to attend, new token included
  const int* tables;   // paged only: [b, n_tbl] pool block ids
  void* out;
  int n_heads, kv_heads, width, n_tbl, shift, group;
  float scale;
};

template <typename T, typename C, int D, int G, bool PAGED>
__device__ __forceinline__ void decode_body(const Args& a) {
  constexpr bool QUANT = sizeof(C) == 1;
  constexpr int VN = Word<C>::N;           // cache elements per 16 bytes
  constexpr int LANES = D / VN;            // threads covering one row
  constexpr int NGRP = kThreads / LANES;   // lane groups per block
  // rows in flight per lane group: fewer where the group's registers are
  // already full (an int8 thread holds 16 columns of each query row)
  constexpr int U = QUANT ? ((G >= 8) ? 1 : (G >= 4) ? 2 : 4)
                          : ((G >= 8) ? 2 : 4);
  static_assert(LANES <= 32 && (32 % LANES) == 0, "row must fit a warp");
  static_assert(VN % Vec16<T>::N == 0, "q chunk must be whole 16-byte loads");

  const T* q = static_cast<const T*>(a.q);
  const C* k = static_cast<const C*>(a.k);
  const C* v = static_cast<const C*>(a.v);
  const int kv_heads = a.kv_heads;
  const int group = a.group;
  const int bi = blockIdx.x / kv_heads;
  const int hk = blockIdx.x % kv_heads;
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  int len = a.lens[bi];
  const bool uniform = len <= 0;  // fill 0: equal scores over the width
  len = (uniform || len > a.width) ? a.width : len;

  // logical row j -> row index into the cache (times D for elements)
  const size_t dense_base = ((size_t)bi * kv_heads + hk) * a.width;
  const int* tbl = PAGED ? a.tables + (size_t)bi * a.n_tbl : nullptr;
  const int off_mask = (1 << a.shift) - 1;
  auto row_of = [&](int j) -> size_t {
    if constexpr (PAGED) {
      const size_t blk = (size_t)tbl[j >> a.shift];
      return ((blk * kv_heads + hk) << a.shift) + (size_t)(j & off_mask);
    } else {
      return dense_base + (size_t)j;
    }
  };

  float qf[G][VN];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < group) {
      const T* qr = q + ((size_t)bi * a.n_heads + hk * group + r) * D
                    + lane * VN;
#pragma unroll
      for (int c = 0; c < VN; c += Vec16<T>::N)
        Vec16<T>::load(qr + c, qf[r] + c);
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
    uint4 kw[U], vw[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ksc[u] = vsc[u] = 0.f;
      if (base + u < len) {
        const size_t row = row_of(base + u);
        kw[u] = load_word(k + row * D + lane * VN);
        vw[u] = load_word(v + row * D + lane * VN);
        if constexpr (QUANT) {
          ksc[u] = a.ks[row];
          vsc[u] = a.vs[row];
        }
      } else {
        kw[u] = vw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float kf[U][VN], vf[U][VN];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Word<C>::to_float(kw[u], kf[u]);
      Word<C>::to_float(vw[u], vf[u]);
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
        const float sc = QUANT ? part * ksc[u] * a.scale : part * a.scale;
        s[u][r] = (base + u < len) ? (uniform ? 0.f : sc) : -INFINITY;
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
      if constexpr (QUANT) {
#pragma unroll
        for (int u = 0; u < U; ++u) p[u] *= vsc[u];  // dequantize V rows
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        float acc_e = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) acc_e = fmaf(p[u], vf[u][e], acc_e);
        acc[r][e] = acc_e;
      }
    }
  }

  // merge the lane groups' partial states, one query row at a time
  __shared__ float sm_m[NGRP];
  __shared__ float sm_l[NGRP];
  __shared__ float sm_acc[NGRP][D];
  T* out = static_cast<T*>(a.out);
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
      T* orow = out + ((size_t)bi * a.n_heads + hk * group + r) * D;
      orow[threadIdx.x] = static_cast<T>(res);
    }
    __syncthreads();
  }
}

// One entry point per family member, so a profile tells them apart.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Args a) {
  decode_body<T, T, D, G, false>(a);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) flash_decode_int8_kernel(Args a) {
  decode_body<T, int8_t, D, G, false>(a);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) flash_decode_paged_kernel(Args a) {
  decode_body<T, T, D, G, true>(a);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_int8_kernel(Args a) {
  decode_body<T, int8_t, D, G, true>(a);
}

template <typename T, int D, int G, bool QUANT, bool PAGED>
void launch_one(const Args& a, int b, cudaStream_t s) {
  const dim3 grid(b * a.kv_heads);
  if constexpr (!QUANT && !PAGED)
    flash_decode_kernel<T, D, G><<<grid, kThreads, 0, s>>>(a);
  else if constexpr (QUANT && !PAGED)
    flash_decode_int8_kernel<T, D, G><<<grid, kThreads, 0, s>>>(a);
  else if constexpr (!QUANT && PAGED)
    flash_decode_paged_kernel<T, D, G><<<grid, kThreads, 0, s>>>(a);
  else
    flash_decode_paged_int8_kernel<T, D, G><<<grid, kThreads, 0, s>>>(a);
}

template <typename T, int D, bool QUANT, bool PAGED>
cudaError_t launch_g(const Args& a, int b, cudaStream_t s) {
  if (a.group <= 1) launch_one<T, D, 1, QUANT, PAGED>(a, b, s);
  else if (a.group <= 2) launch_one<T, D, 2, QUANT, PAGED>(a, b, s);
  else if (a.group <= 4) launch_one<T, D, 4, QUANT, PAGED>(a, b, s);
  else if (a.group <= 8) launch_one<T, D, 8, QUANT, PAGED>(a, b, s);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <bool QUANT, bool PAGED>
int launch(const Args& a, int b, int d, int dtype, cudaStream_t s) {
  if (b <= 0 || a.kv_heads <= 0 || a.width <= 0) return cudaErrorInvalidValue;
#define FD_D(T)                                                           \
  if (d == 64) return launch_g<T, 64, QUANT, PAGED>(a, b, s);             \
  if (d == 128) return launch_g<T, 128, QUANT, PAGED>(a, b, s);           \
  return cudaErrorInvalidValue
  switch (dtype) {
    case kFloat32: { FD_D(float); }
    case kBFloat16: { FD_D(__nv_bfloat16); }
    case kFloat16: { FD_D(__half); }
  }
#undef FD_D
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* lens, const void* tables,
               void* out, int n_heads, int kv_heads, int width, int n_tbl,
               int shift, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.lens = static_cast<const int*>(lens);
  a.tables = static_cast<const int*>(tables);
  a.out = out;
  a.n_heads = n_heads;
  a.kv_heads = kv_heads;
  a.width = width;
  a.n_tbl = n_tbl;
  a.shift = shift;
  a.group = kv_heads > 0 ? n_heads / kv_heads : 0;
  a.scale = scale;
  return a;
}

// log2 of a power-of-two block size, or -1
int block_shift(int block) {
  if (block <= 0 || (block & (block - 1)) != 0) return -1;
  int s = 0;
  while ((1 << s) < block) ++s;
  return s;
}

bool heads_ok(int n_heads, int kv_heads) {
  return kv_heads > 0 && n_heads % kv_heads == 0;
}

}  // namespace

// The C interface.  Every pointer is a contiguous CUDA buffer; q and out
// are [b, n_heads, d] of one dtype (0 fp32, 1 bf16, 2 fp16); lens is int32
// [b] (rows to attend, the new token included).  Each returns the launch's
// cudaError_t (0 = launched).

// K8: k/v [b, kv_heads, max_len, d] in q's dtype.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int b,
                                   int n_heads, int kv_heads, int max_len,
                                   int d, float scale, int dtype,
                                   void* stream) {
  if (!heads_ok(n_heads, kv_heads)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, nullptr, nullptr, lens, nullptr, out,
                           n_heads, kv_heads, max_len, 0, 0, scale);
  return launch<false, false>(a, b, d, dtype,
                              static_cast<cudaStream_t>(stream));
}

// K9: kq/vq int8 [b, kv_heads, max_len, d], ks/vs fp32 [b, kv_heads,
// max_len].
extern "C" int flash_decode_int8_launch(const void* q, const void* kq,
                                        const void* ks, const void* vq,
                                        const void* vs, const void* lens,
                                        void* out, int b, int n_heads,
                                        int kv_heads, int max_len, int d,
                                        float scale, int dtype, void* stream) {
  if (!heads_ok(n_heads, kv_heads)) return cudaErrorInvalidValue;
  const Args a = make_args(q, kq, vq, ks, vs, lens, nullptr, out, n_heads,
                           kv_heads, max_len, 0, 0, scale);
  return launch<true, false>(a, b, d, dtype,
                             static_cast<cudaStream_t>(stream));
}

// K10: k/v pools [n_blocks, kv_heads, block, d] in q's dtype, tables int32
// [b, n_tbl]; block a power of two.
extern "C" int flash_decode_paged_launch(const void* q, const void* k,
                                         const void* v, const void* lens,
                                         const void* tables, void* out, int b,
                                         int n_heads, int kv_heads, int block,
                                         int n_tbl, int d, float scale,
                                         int dtype, void* stream) {
  const int shift = block_shift(block);
  if (!heads_ok(n_heads, kv_heads) || shift < 0 || n_tbl <= 0)
    return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, nullptr, nullptr, lens, tables, out,
                           n_heads, kv_heads, n_tbl * block, n_tbl, shift,
                           scale);
  return launch<false, true>(a, b, d, dtype,
                             static_cast<cudaStream_t>(stream));
}

// K11: kq/vq int8 pools [n_blocks, kv_heads, block, d], ks/vs fp32
// [n_blocks, kv_heads, block], tables int32 [b, n_tbl].
extern "C" int flash_decode_paged_int8_launch(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* lens, const void* tables, void* out, int b,
    int n_heads, int kv_heads, int block, int n_tbl, int d, float scale,
    int dtype, void* stream) {
  const int shift = block_shift(block);
  if (!heads_ok(n_heads, kv_heads) || shift < 0 || n_tbl <= 0)
    return cudaErrorInvalidValue;
  const Args a = make_args(q, kq, vq, ks, vs, lens, tables, out, n_heads,
                           kv_heads, n_tbl * block, n_tbl, shift, scale);
  return launch<true, true>(a, b, d, dtype,
                            static_cast<cudaStream_t>(stream));
}
