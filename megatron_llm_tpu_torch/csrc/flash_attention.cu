// FlashAttention-2 forward: O = softmax(Q K^T * scale + mask) V, plus the
// per-row logsumexp, without materializing the [sq, sk] score matrix.
//
// Replaces the TPU kernel megatron_llm_tpu/kernels/flash_attention.py:
// _fwd_kernel (via flash_attention -> _flash -> _fwd).  Same function:
// fp32 scores, online softmax (running max, running sum, fp32 accumulator)
// over k/v tiles; causal mask with the kv_len - q_len offset (query row i
// sees key columns j <= i + sk - sq); GQA by index (q head h reads kv head
// h / group, K/V are never tiled up); optional packed-sequence segment ids
// (q row and key column must share a segment); O in the input dtype and the
// logsumexp in fp32.  Rows with no visible key get O = 0 and lse = -1e30.
//
// What bounds it on the H100: operations.  At the serving prefill shape
// (sq = sk = 1024, d = 128) each (q-tile, k-tile) pair does 4 * 64 * 64 * 128
// flops on 2 * 64 * 128 loaded elements, far above the ~295 flop/byte the
// card needs before memory is the limit; with this kernel's fp32 FMA math
// (no tensor cores yet) the ceiling is the 67 TFLOP/s fp32 rate, not the
// 989 TFLOP/s bf16 tensor-core rate the bound in PERF.md is reckoned at.
//
// Design: one block per (batch, q head, 64-row q tile), 256 threads.  The
// q tile is staged once; a loop walks 64-column k/v tiles (stopping at the
// causal diagonal) staged in shared memory as fp32.  Each thread owns a 4x4
// patch of the score tile and a 4-row x d/16-column patch of the output, so
// both products are register-blocked FMAs fed by 16-byte shared loads.  The
// softmax statistics of a row are reduced across the 16 threads that share
// it with warp shuffles.  Ragged sq / sk edges are masked in the kernel, not
// padded by the caller.  (wgmma / TMA and bf16 tensor-core tiles are the
// later work that moves it toward the bound.)
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PAD = 4;            // keeps 16-byte alignment, spreads banks
constexpr float kNoKeyLse = -1e30f;

template <int D>
struct Smem {
  static constexpr int QS = D * (BQ + PAD);   // Q^T  [D][BQ+PAD]
  static constexpr int KS = D * (BK + PAD);   // K^T  [D][BK+PAD]
  static constexpr int VS = BK * D;           // V    [BK][D]
  static constexpr int PS = BQ * (BK + PAD);  // P    [BQ][BK+PAD]
  static constexpr int BYTES = (QS + KS + VS + PS) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                 int hq, int hk, float scale, int causal) {
  constexpr int VN = Vec16<T>::N;
  constexpr int CH = D / VN;          // 16-byte chunks per row
  constexpr int CPT = D / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::QS;
  float* Vs = Ks + Smem<D>::KS;
  float* Ps = Vs + Smem<D>::VS;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 4, c0 = tx * 4;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % hq;
  const int bi = blockIdx.x / (n_qt * hq);
  const int hkv = h / (hq / hk);
  const int qbase = qt * BQ;
  const int offset = sk - sq;

  // stage the q tile transposed (row-fastest thread order: conflict-free)
  for (int idx = tid; idx < BQ * CH; idx += kThreads) {
    const int r = idx % BQ, ch = idx / BQ;
    float tmp[VN];
    if (qbase + r < sq) {
      Vec16<T>::load(q + (((size_t)bi * sq + qbase + r) * hq + h) * D + ch * VN,
                     tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) Qs[(ch * VN + e) * (BQ + PAD) + r] = tmp[e];
  }

  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qbase + r0 + i;
    qseg[i] = (seg != nullptr && row < sq) ? seg[(size_t)bi * sk + row] : 0;
  }

  float m[4], l[4], o[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[i][e] = 0.f;
  }

  const int qlast = min(qbase + BQ, sq) - 1;
  const int kend = causal ? min(sk, qlast + offset + 1) : sk;

  for (int kbase = 0; kbase < kend; kbase += BK) {
    // K tile transposed (row-fastest), V tile row-major (chunk-fastest)
    for (int idx = tid; idx < BK * CH; idx += kThreads) {
      const int r = idx % BK, ch = idx / BK;
      float tmp[VN];
      if (kbase + r < sk) {
        Vec16<T>::load(
            k + (((size_t)bi * sk + kbase + r) * hk + hkv) * D + ch * VN, tmp);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) tmp[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) Ks[(ch * VN + e) * (BK + PAD) + r] = tmp[e];
    }
    for (int idx = tid; idx < BK * CH; idx += kThreads) {
      const int r = idx / CH, ch = idx % CH;
      float tmp[VN];
      if (kbase + r < sk) {
        Vec16<T>::load(
            v + (((size_t)bi * sk + kbase + r) * hk + hkv) * D + ch * VN, tmp);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) tmp[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(&Vs[r * D + ch * VN + e]) =
            make_float4(tmp[e], tmp[e + 1], tmp[e + 2], tmp[e + 3]);
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[kk * (BQ + PAD) + r0]);
      const float4 b = *reinterpret_cast<const float4*>(&Ks[kk * (BK + PAD) + c0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    int kseg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kbase + c0 + j;
      kseg[j] = (seg != nullptr && col < sk) ? seg[(size_t)bi * sk + col] : 0;
    }

    // mask, online softmax, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qbase + r0 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kbase + c0 + j;
        bool keep = row < sq && col < sk;
        if (causal) keep = keep && (col <= row + offset);
        if (seg != nullptr) keep = keep && (qseg[i] == kseg[j]);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mnew = fmaxf(m[i], rmax);
      float alpha = 1.f;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      if (mnew != -INFINITY) {
        alpha = __expf(m[i] - mnew);
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = __expf(s[i][j] - mnew);
      }
      float rsum = p[0] + p[1] + p[2] + p[3];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = mnew;
#pragma unroll
      for (int e = 0; e < CPT; ++e) o[i][e] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(r0 + i) * (BK + PAD) + c0]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // O += P V for this thread's 4 rows x CPT columns
    for (int c = 0; c < BK; c += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&Ps[(r0 + i) * (BK + PAD) + c]);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vr[CPT];
#pragma unroll
        for (int e = 0; e < CPT; e += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&Vs[(c + cc) * D + tx * CPT + e]);
          vr[e] = t.x; vr[e + 1] = t.y; vr[e + 2] = t.z; vr[e + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < CPT; ++e) o[i][e] = fmaf(pv[i][cc], vr[e], o[i][e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qbase + r0 + i;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float res[CPT];
#pragma unroll
    for (int e = 0; e < CPT; ++e) res[e] = o[i][e] * inv;
    T* orow = out + (((size_t)bi * sq + row) * hq + h) * D + tx * CPT;
    if constexpr (CPT % VN == 0) {
#pragma unroll
      for (int e = 0; e < CPT; e += VN) Vec16<T>::store(orow + e, res + e);
    } else {
#pragma unroll
      for (int e = 0; e < CPT; ++e) orow[e] = static_cast<T>(res[e]);
    }
    if (tx == 0)
      lse[((size_t)bi * hq + h) * sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kNoKeyLse;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, void* out, float* lse, int b, int sq,
                   int sk, int hq, int hk, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  static bool smem_set = false;  // the opt-in above 48 KB, once per variant
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_qt = (sq + BQ - 1) / BQ;
  dim3 grid(b * hq * n_qt);
  kern<<<grid, kThreads, Smem<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), lse, sq, sk, hq,
      hk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* seg, void* out, float* lse, int b, int sq,
                     int sk, int hq, int hk, int d, float scale, int causal,
                     cudaStream_t stream) {
  if (d == 128)
    return launch<T, 128>(q, k, v, seg, out, lse, b, sq, sk, hq, hk, scale,
                          causal, stream);
  if (d == 64)
    return launch<T, 64>(q, k, v, seg, out, lse, b, sq, sk, hq, hk, scale,
                         causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, sq, hq, d], k/v [b, sk, hk, d], seg int32 [b, sk] or null (requires
// sq == sk), out [b, sq, hq, d] in q's dtype, lse fp32 [b, hq, sq]; all
// contiguous.  Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* seg,
                                      void* out, void* lse, int b, int sq,
                                      int sk, int hq, int hk, int d,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0)
    return cudaErrorInvalidValue;
  if (seg != nullptr && sq != sk) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case kFloat32:
      return launch_d<float>(q, k, v, sg, out, ls, b, sq, sk, hq, hk, d,
                             scale, causal, s);
    case kBFloat16:
      return launch_d<__nv_bfloat16>(q, k, v, sg, out, ls, b, sq, sk, hq, hk,
                                     d, scale, causal, s);
    case kFloat16:
      return launch_d<__half>(q, k, v, sg, out, ls, b, sq, sk, hq, hk, d,
                              scale, causal, s);
  }
  return cudaErrorInvalidValue;
}
