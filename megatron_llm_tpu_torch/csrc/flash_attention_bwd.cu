// FlashAttention-2 backward: dQ (one kernel) and dK/dV (a second), with
// P = exp(S * scale - lse) recomputed tile by tile from the forward's fp32
// logsumexp, so the [sq, sk] score matrix never reaches device memory.
//
// Replaces the TPU kernels megatron_llm_tpu/kernels/flash_attention.py:
// _dq_kernel and _dkv_kernel (via _bwd_impl).  Same function:
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO,
// with delta = rowsum(dO * O) computed by the caller in fp32, as the JAX
// wrapper does outside its kernels.  Masks as in the forward kernel: the
// causal offset sk - sq (query row i sees key columns j <= i + sk - sq),
// packed-sequence segment ids (sq == sk) and the ragged sq / sk edges, all
// in the kernel; the caller neither pads nor transposes.  A masked pair
// has P = 0 exactly, so a row that sees no key (lse = -1e30) gets dQ = 0.
// GQA by index: q head h reads kv head h / group.  dK and dV of one kv head
// sum its whole q-head group in fp32 registers, the JAX grid
// (b, hk, nk, group * nq): no atomics (deterministic) and no per-q-head
// fp32 intermediate.  Outputs in the inputs' dtype.
//
// What bounds them on the H100: operations.  Per (q tile, k tile) pair the
// dQ kernel does three 64 x 64 x d products and the dK/dV kernel four, on
// 64 x d tiles it loads once per pair: far above the ~295 flop/byte where
// memory would be the limit.  With this first version's fp32 FMA math (no
// tensor cores) the ceiling is the 67 TFLOP/s fp32 rate, not the
// 989 TFLOP/s bf16 rate the bound in PERF.md is reckoned at.
//
// Design: 256 threads per block; 64-row tiles staged in shared memory as
// fp32, row-major with a 4-float pad.  Each thread computes a 4 x 4 patch
// of S and dP: rows 4*ty + a and columns tx + 16*c, so that the 8 threads
// of a quarter-warp read 8 different K rows whose 4-bank groups tile all 32
// banks, while all of them read the same Q row (a broadcast).  The patch
// goes to shared memory as P / dS, and each thread then accumulates 4
// output rows x d/16 columns (columns 4*tx + 64*g: again conflict-free).
//   dQ kernel:   one block per (batch, q head, q tile); loops over k tiles
//                up to the causal diagonal.
//   dK/dV kernel: one block per (batch, kv head, k tile); loops over the
//                q heads of the group and the q tiles from the diagonal on.
// (mma.sync / wgmma tiles and TMA are the later work that moves these
// toward the bound.)
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PAD = 4;            // keeps 16-byte alignment, spreads banks
constexpr int LDP = BK + PAD;     // row stride of the P / dS tiles

template <int D>
struct DqSmem {  // Q, dO [BQ][D+PAD]; K, V [BK][D+PAD]; dS; lse, delta
  static constexpr int LD = D + PAD;
  static constexpr int FLOATS = 2 * BQ * LD + 2 * BK * LD + BQ * LDP + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

template <int D>
struct DkvSmem {  // K, V, Q, dO [64][D+PAD]; P, dS; lse, delta
  static constexpr int LD = D + PAD;
  static constexpr int FLOATS = 2 * BK * LD + 2 * BQ * LD + 2 * BQ * LDP
                                + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

// Stage rows [base, base + ROWS) of one head's [seq, D] slice (row i at
// src + i * stride) as fp32 rows of D + PAD floats; rows past `limit` are 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int base, int limit,
                                          int tid) {
  constexpr int VN = Vec16<T>::N;
  constexpr int CH = D / VN;
  for (int idx = tid; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx % CH;
    float tmp[VN];
    if (base + r < limit) {
      Vec16<T>::load(src + (size_t)(base + r) * stride + ch * VN, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(&dst[r * (D + PAD) + ch * VN + e]) =
          make_float4(tmp[e], tmp[e + 1], tmp[e + 2], tmp[e + 3]);
  }
}

// acc[a][c] = sum_k A[r0 + a][k] * B[tx + 16 c][k] over two staged tiles.
template <int D>
__device__ __forceinline__ void dot_patch(const float* A, const float* B,
                                          int r0, int tx, float acc[4][4]) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(&A[(r0 + a) * LD + k]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(&B[(tx + 16 * c) * LD + k]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = fmaf(av[a].x, bv[c].x, acc[a][c]);
        acc[a][c] = fmaf(av[a].y, bv[c].y, acc[a][c]);
        acc[a][c] = fmaf(av[a].z, bv[c].z, acc[a][c]);
        acc[a][c] = fmaf(av[a].w, bv[c].w, acc[a][c]);
      }
  }
}

// out[a][4g + u] += sum_t coef(t, a) * B[t][64 g + 4 tx + u], t < 64, where
// coef(t, a) = M[r0 + a][t] (TRANS = false) or M[t][r0 + a] (TRANS = true)
// for the [64][LDP] tile M.
template <int D, bool TRANS>
__device__ __forceinline__ void accumulate(const float* M, const float* B,
                                           int r0, int tx,
                                           float out[4][D / 16]) {
  constexpr int LD = D + PAD;
  constexpr int G = D / 64;
#pragma unroll 2
  for (int t = 0; t < 64; t += 4) {
    float coef[4][4];  // [a][t offset]
    if (TRANS) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 m = *reinterpret_cast<const float4*>(&M[(t + u) * LDP + r0]);
        coef[0][u] = m.x; coef[1][u] = m.y; coef[2][u] = m.z; coef[3][u] = m.w;
      }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 m = *reinterpret_cast<const float4*>(&M[(r0 + a) * LDP + t]);
        coef[a][0] = m.x; coef[a][1] = m.y; coef[a][2] = m.z; coef[a][3] = m.w;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b =
            *reinterpret_cast<const float4*>(&B[(t + u) * LD + 64 * g + 4 * tx]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          out[a][4 * g + 0] = fmaf(coef[a][u], b.x, out[a][4 * g + 0]);
          out[a][4 * g + 1] = fmaf(coef[a][u], b.y, out[a][4 * g + 1]);
          out[a][4 * g + 2] = fmaf(coef[a][u], b.z, out[a][4 * g + 2]);
          out[a][4 * g + 3] = fmaf(coef[a][u], b.w, out[a][4 * g + 3]);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v);

template <>
__device__ __forceinline__ void store4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float* v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v[0], v[1]);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <>
__device__ __forceinline__ void store4<__half>(__half* p, const float* v) {
  reinterpret_cast<__half2*>(p)[0] = __floats2half2_rn(v[0], v[1]);
  reinterpret_cast<__half2*>(p)[1] = __floats2half2_rn(v[2], v[3]);
}

// Write this thread's 4 rows x d/16 columns of a [seq, heads, D] output.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, size_t stride, int base,
                                           int limit, int r0, int tx,
                                           float acc[4][D / 16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = base + r0 + a;
    if (row >= limit) continue;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4<T>(out + (size_t)row * stride + 64 * g + 4 * tx, &acc[a][4 * g]);
  }
}

// P and dS for this thread's 4 x 4 patch (rows qbase + r0 + a, columns
// kbase + tx + 16 c) from the S and dP patches, into the [64][LDP] tiles.
__device__ __forceinline__ void p_and_ds(
    const float s[4][4], const float dp[4][4], const float* rowL,
    const float* rowD, const int* seg, size_t seg_row, int qbase, int kbase,
    int r0, int tx, int sq, int sk, float scale, int causal, float* Ps,
    float* dSs) {
  const int offset = sk - sq;
  int kseg[4], qseg[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = kbase + tx + 16 * c;
    kseg[c] = (seg != nullptr && col < sk) ? seg[seg_row + col] : 0;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = qbase + r0 + a;
    qseg[a] = (seg != nullptr && row < sq) ? seg[seg_row + row] : 0;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = qbase + r0 + a;
    const float lse = rowL[r0 + a], delta = rowD[r0 + a];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = kbase + tx + 16 * c;
      bool keep = row < sq && col < sk;
      if (causal) keep = keep && (col <= row + offset);
      if (seg != nullptr) keep = keep && (qseg[a] == kseg[c]);
      // a kept pair's row saw a key, so its lse is finite and P <= 1
      const float p = keep ? __expf(s[a][c] * scale - lse) : 0.f;
      if (Ps != nullptr) Ps[(r0 + a) * LDP + tx + 16 * c] = p;
      dSs[(r0 + a) * LDP + tx + 16 * c] = p * (dp[a][c] - delta) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, T* __restrict__ dq, int sq,
                    int sk, int hq, int hk, float scale, int causal) {
  constexpr int LD = D + PAD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* rowL = dSs + BQ * LDP;
  float* rowD = rowL + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 4;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % hq;
  const int bi = blockIdx.x / (n_qt * hq);
  const int hkv = h / (hq / hk);
  const int qbase = qt * BQ;
  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hk * D;
  const size_t q_off = (size_t)bi * sq * hq * D + (size_t)h * D;
  const size_t k_off = (size_t)bi * sk * hk * D + (size_t)hkv * D;
  const size_t row_off = ((size_t)bi * hq + h) * sq;

  load_tile<T, D, BQ>(Qs, q + q_off, q_stride, qbase, sq, tid);
  load_tile<T, D, BQ>(dOs, dout + q_off, q_stride, qbase, sq, tid);
  for (int r = tid; r < BQ; r += kThreads) {
    const int row = qbase + r;
    rowL[r] = row < sq ? lse[row_off + row] : 0.f;
    rowD[r] = row < sq ? delta[row_off + row] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[a][e] = 0.f;

  const int qlast = min(qbase + BQ, sq) - 1;
  const int kend = causal ? min(sk, qlast + (sk - sq) + 1) : sk;
  for (int kbase = 0; kbase < kend; kbase += BK) {
    load_tile<T, D, BK>(Ks, k + k_off, k_stride, kbase, sk, tid);
    load_tile<T, D, BK>(Vs, v + k_off, k_stride, kbase, sk, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_patch<D>(Qs, Ks, r0, tx, s);
    dot_patch<D>(dOs, Vs, r0, tx, dp);
    p_and_ds(s, dp, rowL, rowD, seg, (size_t)bi * sk, qbase, kbase, r0, tx,
             sq, sk, scale, causal, nullptr, dSs);
    __syncthreads();
    accumulate<D, false>(dSs, Ks, r0, tx, acc);
    __syncthreads();  // K, V and dS are overwritten by the next tile
  }
  store_rows<T, D>(dq + q_off, q_stride, qbase, sq, r0, tx, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int hq, int hk,
                     float scale, int causal) {
  constexpr int LD = D + PAD;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* rowL = dSs + BQ * LDP;
  float* rowD = rowL + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 4;
  const int n_kt = (sk + BK - 1) / BK;
  const int kt = blockIdx.x % n_kt;
  const int hkv = (blockIdx.x / n_kt) % hk;
  const int bi = blockIdx.x / (n_kt * hk);
  const int group = hq / hk;
  const int kbase = kt * BK;
  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hk * D;
  const size_t k_off = (size_t)bi * sk * hk * D + (size_t)hkv * D;

  load_tile<T, D, BK>(Ks, k + k_off, k_stride, kbase, sk, tid);
  load_tile<T, D, BK>(Vs, v + k_off, k_stride, kbase, sk, tid);

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;

  // under the causal mask the first q row that sees key kbase is
  // kbase - (sk - sq): earlier q tiles are skipped
  const int n_qt = (sq + BQ - 1) / BQ;
  const int first = kbase - (sk - sq);
  const int qt0 = (causal && first > 0) ? first / BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hkv * group + gi;
    const size_t q_off = (size_t)bi * sq * hq * D + (size_t)h * D;
    const size_t row_off = ((size_t)bi * hq + h) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int qbase = qt * BQ;
      __syncthreads();  // the previous pair's readers are done
      load_tile<T, D, BQ>(Qs, q + q_off, q_stride, qbase, sq, tid);
      load_tile<T, D, BQ>(dOs, dout + q_off, q_stride, qbase, sq, tid);
      for (int r = tid; r < BQ; r += kThreads) {
        const int row = qbase + r;
        rowL[r] = row < sq ? lse[row_off + row] : 0.f;
        rowD[r] = row < sq ? delta[row_off + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_patch<D>(Qs, Ks, r0, tx, s);
      dot_patch<D>(dOs, Vs, r0, tx, dp);
      p_and_ds(s, dp, rowL, rowD, seg, (size_t)bi * sk, qbase, kbase, r0,
               tx, sq, sk, scale, causal, Ps, dSs);
      __syncthreads();
      // this thread's rows are now key rows kbase + r0 + a
      accumulate<D, true>(Ps, dOs, r0, tx, acc_v);
      accumulate<D, true>(dSs, Qs, r0, tx, acc_k);
    }
  }
  store_rows<T, D>(dk + k_off, k_stride, kbase, sk, r0, tx, acc_k);
  store_rows<T, D>(dv + k_off, k_stride, kbase, sk, r0, tx, acc_v);
}

template <typename Kern>
cudaError_t opt_in_smem(Kern kern, int bytes, bool* done) {
  if (*done) return cudaSuccess;  // the opt-in above 48 KB, once per variant
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* seg, void* dq, int b, int sq, int sk, int hq,
                      int hk, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, DqSmem<D>::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + BQ - 1) / BQ;
  kern<<<dim3(b * hq * n_qt), kThreads, DqSmem<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, seg,
      static_cast<T*>(dq), sq, sk, hq, hk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const int* seg, void* dk, void* dv,
                       int b, int sq, int sk, int hq, int hk, float scale,
                       int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, DkvSmem<D>::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_kt = (sk + BK - 1) / BK;
  kern<<<dim3(b * hk * n_kt), kThreads, DkvSmem<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, seg,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, hq, hk, scale,
      causal);
  return cudaGetLastError();
}

// Dispatch on dtype and head dim: F<T, D>(args...).
#define BWD_DISPATCH(F, ...)                                           \
  switch (dtype * 1000 + d) {                                          \
    case kFloat32 * 1000 + 64: return F<float, 64>(__VA_ARGS__);       \
    case kFloat32 * 1000 + 128: return F<float, 128>(__VA_ARGS__);     \
    case kBFloat16 * 1000 + 64: return F<__nv_bfloat16, 64>(__VA_ARGS__);   \
    case kBFloat16 * 1000 + 128: return F<__nv_bfloat16, 128>(__VA_ARGS__); \
    case kFloat16 * 1000 + 64: return F<__half, 64>(__VA_ARGS__);      \
    case kFloat16 * 1000 + 128: return F<__half, 128>(__VA_ARGS__);    \
  }                                                                    \
  return cudaErrorInvalidValue;

bool bad_shape(int b, int sq, int sk, int hq, int hk, const void* seg) {
  return b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0 ||
         (seg != nullptr && sq != sk);
}

}  // namespace

// q / dout [b, sq, hq, d], k / v [b, sk, hk, d], lse and delta fp32
// [b, hq, sq], seg int32 [b, sk] or null (requires sq == sk); dq
// [b, sq, hq, d] in q's dtype.  All contiguous.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dq, int b,
    int sq, int sk, int hq, int hk, int d, float scale, int causal, int dtype,
    void* stream) {
  if (bad_shape(b, sq, sk, hq, hk, seg)) return cudaErrorInvalidValue;
  BWD_DISPATCH(launch_dq, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg), dq, b, sq, sk, hq, hk, scale,
               causal, static_cast<cudaStream_t>(stream))
}

// As above, writing dk / dv [b, sk, hk, d] in k's dtype.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
    int b, int sq, int sk, int hq, int hk, int d, float scale, int causal,
    int dtype, void* stream) {
  if (bad_shape(b, sq, sk, hq, hk, seg)) return cudaErrorInvalidValue;
  BWD_DISPATCH(launch_dkv, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg), dk, dv, b, sq, sk, hq, hk,
               scale, causal, static_cast<cudaStream_t>(stream))
}
