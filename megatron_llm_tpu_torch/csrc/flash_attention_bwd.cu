// FlashAttention-2 backward: dQ (one kernel) and dK/dV (a second), with
// P = exp(S * scale - lse) recomputed tile by tile from the forward's fp32
// logsumexp, so the [sq, sk] score matrix never reaches device memory.
//
// Replaces the TPU kernels megatron_llm_tpu/kernels/flash_attention.py:
// _dq_kernel and _dkv_kernel (via _bwd_impl).  Same function:
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO,
// with delta = rowsum(dO * O) computed by the caller in fp32, as the JAX
// wrapper does outside its kernels, and the products' operands rounded
// where JAX rounds them: dS to the input dtype before dS K and dS^T Q, P
// before P^T dO (the identity for fp32).  Masks as in the forward kernel:
// the causal offset sk - sq (query row i sees key columns j <= i + sk - sq),
// packed-sequence segment ids (sq == sk) and the ragged sq / sk edges, all
// in the kernel; the caller neither pads nor transposes.  A masked pair
// has P = 0 exactly, so a row that sees no key (lse = -1e30) gets dQ = 0.
// GQA by index: q head h reads kv head h / group.  dK and dV of one kv head
// sum its whole q-head group in fp32 (the JAX grid (b, hk, nk, group * nq)):
// no atomics, so the result is deterministic.  Outputs in the inputs' dtype.
//
// What bounds them on the H100: operations.  Per (q tile, k tile) pair the
// dQ kernel does three 64 x 64 x d products and the dK/dV kernel four, on
// 64 x d tiles it loads once per pair: far above the ~295 flop/byte where
// memory would be the limit, so the ceiling is the tensor cores' rate
// (989 TFLOP/s bf16 dense; mma.sync reaches roughly two thirds of it).
//
// dK/dV, bf16 / fp16: tensor cores (flash_bwd_dkv_mma_kernel).  One block
// per (batch, kv head, 64-key tile[, split]), 4 warps of 16 key rows each;
// the K and V tiles are loaded once into shared memory.  The block walks
// (q head of the group, q tile from the causal diagonal on); the Q and dO
// tiles, with their lse and delta rows, go through a two-stage cp.async
// ring, so item i + 1 is in flight while item i is computed.  Per item,
// each warp computes S^T = K Q^T directly in the transposed orientation
// (it owns key rows), P^T from the accumulators, dV += P^T dO with P^T
// packed to b16 in registers as the A operand and dO read by
// ldmatrix.trans, dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, and
// dK += dS^T Q the same way.  dK and dV stay fp32 accumulators in
// registers (2 x 16 rows x d per warp: 128 registers a thread at d = 128).
// A grid of b * hk * ceil(sk / 64) blocks below about twice the SM count
// (Falcon-7B: one kv head, 32 blocks at seq 2048) splits each block's walk
// over `splits` blocks: each writes fp32 partial dK and dV to a scratch
// [2, splits, b, sk, hk, d] and a second small kernel sums the partials in
// split order and writes the input dtype, so the result stays
// deterministic.  Blocks of low key tiles (the most q tiles under the
// causal mask) are issued first.  Shared memory at d = 128: K and V 17 KB
// each plus the ring 2 x 2 x 17 KB and 1 KB of lse / delta, 103 KB: two
// blocks on an SM.  nvcc -Xptxas -v (CUDA 12.8, sm_90a): 255 registers a
// thread at d = 128 with 8 bytes spilled (the two 16 x 128 fp32
// accumulators, P^T and dP^T live at once), 233 at d = 64 without spills.
// What holds it back: mma.sync's rate (as the forward), the spill, and
// the K and V operands read again from shared memory for every item.
//
// dQ, bf16 / fp16: tensor cores (flash_bwd_dq_mma_kernel), K1's walk with
// K3's products.  One block per (batch, q head, 64-row q tile), 4 warps of
// 16 q rows each, the heavy (late) q tiles issued first under the causal
// mask.  The Q and dO tiles arrive by cp.async and their fragments are
// loaded once with ldmatrix and held in registers for the whole walk; the
// 64-key K and V tiles go through a two-stage cp.async ring, tile j + 1 in
// flight while tile j is computed.  Per K/V tile each warp computes S = Q
// K^T, P = 2^(S scale log2 e - lse log2 e) (one FFMA and one ex2 a score;
// the mask, K1's predicate, only on tiles that cross the diagonal or the
// key edge, or any tile with segment ids: a row that sees no key, lse
// -1e30, always lies in such a tile), dP = dO V^T, dS = P (dP - delta)
// scale in place, and dQ += dS K with dS packed to b16 in registers as the
// A operand (the JAX rounding) and K read by ldmatrix.trans: dS never
// touches shared memory.  dQ stays in fp32 registers (16 x d a warp, 64 a
// thread at d = 128) and the epilogue stores coalesced 16-byte rows
// through the warp's own rows of the Q tile.  A block owns its dQ rows (as
// JAX's grid, unlike FlashAttention-2's atomicAdd dQ), so runs agree bit
// for bit; Falcon-7B's grid is 71 x 32 = 2272 blocks, no split needed.
// Shared memory: Q, dO and the ring, 6 tiles of 64 padded rows, 102 KB at
// d = 128 (55 KB at d = 64): two blocks on an SM.  nvcc -Xptxas -v (CUDA
// 12.8, sm_90a): 255 registers a thread at d = 128 with 36 bytes spilled
// (Q and dO fragments 64, dQ 64, P and dP 64), 208 at d = 64 without
// spills.  Reading dO from shared memory with ldmatrix for every tile
// instead, as FlashAttention-2 does, spilled nothing (255 and 206
// registers) but was 2.2-3.5% slower at every shape timed, d = 128 and
// Falcon-7B's d = 64 (an earlier version of attention_probe.py built both
// bodies; NVIDIA H100 80GB HBM3, 700 W), so dO's fragments are held.
// What holds it back: mma.sync's rate (as K1 and K3), the spill, and K
// and V read again from L2 by each of a head's q tiles.
//
// fp32: CUDA-core FMAs (flash_bwd_dq_kernel, flash_bwd_dkv_kernel), the
// bodies of the first port (the tensor cores have no fp32 product but
// TF32, which would change what fp32 computes).  256 threads per block;
// 64-row tiles staged in shared memory, row-major with a 4-float pad.
// Each thread
// computes a 4 x 4 patch of S and dP: rows 4*ty + a and columns tx + 16*c,
// so that the 8 threads of a quarter-warp read 8 different K rows whose
// 4-bank groups tile all 32 banks, while all of them read the same Q row
// (a broadcast).  The patch goes to shared memory as P / dS, and each
// thread then accumulates 4 output rows x d/16 columns (columns
// 4*tx + 64*g: again conflict-free).
//   dQ kernel:   one block per (batch, q head, q tile); loops over k tiles
//                up to the causal diagonal.
//   dK/dV kernel: one block per (batch, kv head, k tile); loops over the
//                q heads of the group and the q tiles from the diagonal on.
#include "common.cuh"
#include "mma.cuh"

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

// Stage rows [base, base + ROWS) of one head's [seq, D] fp32 slice (row i
// at src + i * stride) as rows of D + PAD floats; rows past `limit` are 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int base, int limit,
                                          int tid) {
  constexpr int CH = D / 4;
  for (int idx = tid; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx % CH;
    *reinterpret_cast<float4*>(&dst[r * (D + PAD) + ch * 4]) =
        base + r < limit ? *reinterpret_cast<const float4*>(
                               src + (size_t)(base + r) * stride + ch * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
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

// Write this thread's 4 rows x d/16 columns of a [seq, heads, D] output.
template <int D>
__device__ __forceinline__ void store_rows(float* out, size_t stride, int base,
                                           int limit, int r0, int tx,
                                           float acc[4][D / 16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = base + r0 + a;
    if (row >= limit) continue;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(out + (size_t)row * stride + 64 * g +
                                 4 * tx) =
          make_float4(acc[a][4 * g], acc[a][4 * g + 1], acc[a][4 * g + 2],
                      acc[a][4 * g + 3]);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, float* __restrict__ dq,
                    int sq, int sk, int hq, int hk, float scale, int causal) {
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

  load_tile<D, BQ>(Qs, q + q_off, q_stride, qbase, sq, tid);
  load_tile<D, BQ>(dOs, dout + q_off, q_stride, qbase, sq, tid);
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
    load_tile<D, BK>(Ks, k + k_off, k_stride, kbase, sk, tid);
    load_tile<D, BK>(Vs, v + k_off, k_stride, kbase, sk, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_patch<D>(Qs, Ks, r0, tx, s);
    dot_patch<D>(dOs, Vs, r0, tx, dp);
    p_and_ds(s, dp, rowL, rowD, seg, (size_t)bi * sk, qbase, kbase, r0,
                tx, sq, sk, scale, causal, nullptr, dSs);
    __syncthreads();
    accumulate<D, false>(dSs, Ks, r0, tx, acc);
    __syncthreads();  // K, V and dS are overwritten by the next tile
  }
  store_rows<D>(dq + q_off, q_stride, qbase, sq, r0, tx, acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int hq, int hk,
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

  load_tile<D, BK>(Ks, k + k_off, k_stride, kbase, sk, tid);
  load_tile<D, BK>(Vs, v + k_off, k_stride, kbase, sk, tid);

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
      load_tile<D, BQ>(Qs, q + q_off, q_stride, qbase, sq, tid);
      load_tile<D, BQ>(dOs, dout + q_off, q_stride, qbase, sq, tid);
      for (int r = tid; r < BQ; r += kThreads) {
        const int row = qbase + r;
        rowL[r] = row < sq ? lse[row_off + row] : 0.f;
        rowD[r] = row < sq ? delta[row_off + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_patch<D>(Qs, Ks, r0, tx, s);
      dot_patch<D>(dOs, Vs, r0, tx, dp);
      p_and_ds(s, dp, rowL, rowD, seg, (size_t)bi * sk, qbase, kbase,
                  r0, tx, sq, sk, scale, causal, Ps, dSs);
      __syncthreads();
      // this thread's rows are now key rows kbase + r0 + a
      accumulate<D, true>(Ps, dOs, r0, tx, acc_v);
      accumulate<D, true>(dSs, Qs, r0, tx, acc_k);
    }
  }
  store_rows<D>(dk + k_off, k_stride, kbase, sk, r0, tx, acc_k);
  store_rows<D>(dv + k_off, k_stride, kbase, sk, r0, tx, acc_v);
}

// ---------------------------------------------------------------------------
// dK/dV, bf16 / fp16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kDkvWarps = 4;  // 16 key rows each: one 64-key tile a block
constexpr int kDkvThreads = kDkvWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvMmaSmem {  // elements of T: K, V, then 2 x {Q, dO}; 2 x {lse, delta}
  static constexpr int LDS = mma::kLd<D>;
  static constexpr int TILE = 64 * LDS;
  static constexpr int ROWS_OFF = 6 * TILE * 2;  // bytes to the fp32 rows
  static constexpr int BYTES = ROWS_OFF + 2 * 2 * 64 * 4;
};

// Write a warp's 16 rows x D accumulators (rows kbase + 16 warp + g and
// + 8, columns 8 dn + 2 t) to a [.., sk, hk, D] output at `base`: T when
// `part` is null, else fp32 to the partial sums.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, float* part,
                                          const float acc[D / 8][4],
                                          size_t row_stride, int row0,
                                          int sk, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= sk) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const size_t at = (size_t)row * row_stride + dn * 8 + 2 * t;
      const float x = acc[dn][2 * half], y = acc[dn][2 * half + 1];
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + at) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(out + at) = mma::pack2<T>(x, y);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads, 2)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ part,
                         int b, int sq, int sk, int hq, int hk, float scale,
                         int causal, int splits) {
  using S = DkvMmaSmem<D>;
  constexpr int LDS = S::LDS, TILE = S::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* ring = Vs + TILE;  // stage s: Q at ring + 2 s TILE, dO after it
  float* rows = reinterpret_cast<float*>(smem_raw + S::ROWS_OFF);
  // stage s: lse at rows + 128 s, delta at rows + 128 s + 64

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int per_kt = b * hk * splits;
  const int kt = blockIdx.x / per_kt;  // low key tiles (most work) first
  const int rem = blockIdx.x % per_kt;
  const int split = rem % splits;
  const int hkv = (rem / splits) % hk, bi = rem / splits / hk;
  const int group = hq / hk;
  const int kbase = kt * 64;
  const int offset = sk - sq;
  const float scale2 = scale * kLog2e;  // exp(x) = 2^(x log2 e)
  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hk * D;
  const size_t k_off = (size_t)bi * sk * k_stride + (size_t)hkv * D;

  // the items (q head of the group, q tile from the causal diagonal on)
  const int n_qt = (sq + 63) / 64;
  const int first = kbase - offset;  // first q row that sees key kbase
  const int qt0 = (causal && first > 0) ? min(first / 64, n_qt) : 0;
  const int n_item_q = n_qt - qt0;
  const int total = group * n_item_q;
  const int per_split = (total + splits - 1) / splits;
  const int i0 = min(total, split * per_split);
  const int i1 = min(total, i0 + per_split);

  auto tile_async = [&](T* dst, const T* src, size_t stride, int base,
                        int limit) {
    mma::cp_async_rows<T, D, 64, kDkvThreads>(dst, src, stride, base, limit,
                                             tid);
  };
  auto issue = [&](int item, int stage) {
    const int h = hkv * group + item / n_item_q;
    const int qbase = (qt0 + item % n_item_q) * 64;
    const size_t q_off = (size_t)bi * sq * q_stride + (size_t)h * D;
    T* Qd = ring + stage * 2 * TILE;
    tile_async(Qd, q + q_off, q_stride, qbase, sq);
    tile_async(Qd + TILE, dout + q_off, q_stride, qbase, sq);
    const int r = tid % 64;
    const float* src = (tid < 64 ? lse : delta) +
                       ((size_t)bi * hq + h) * sq;
    const bool ok = qbase + r < sq;
    mma::cp_async4(rows + stage * 128 + tid, src + (ok ? qbase + r : 0), ok);
  };

  tile_async(Ks, k + k_off, k_stride, kbase, sk);
  tile_async(Vs, v + k_off, k_stride, kbase, sk);
  mma::cp_async_commit();
  if (i0 < i1) issue(i0, 0);
  mma::cp_async_commit();

  const int key0 = kbase + warp * 16 + g, key1 = key0 + 8;
  int kseg0 = 0, kseg1 = 0;
  if (seg != nullptr) {
    kseg0 = key0 < sk ? seg[(size_t)bi * sk + key0] : -1;
    kseg1 = key1 < sk ? seg[(size_t)bi * sk + key1] : -1;
  }
  const T* Kw = Ks + warp * 16 * LDS;
  const T* Vw = Vs + warp * 16 * LDS;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  for (int it = i0; it < i1; ++it) {
    const int stage = (it - i0) & 1;
    if (it + 1 < i1) issue(it + 1, stage ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // K, V and this item have landed
    __syncthreads();
    const T* Qt = ring + stage * 2 * TILE;
    const T* dOt = Qt + TILE;
    const float* L = rows + stage * 128;
    const float* Dl = L + 64;
    const int qbase = (qt0 + it % n_item_q) * 64;

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T
    float p[8][4];
    mma::rows_by_rows<T, D>(p, Kw, Qt, lane);
    const bool edge = qbase + 64 > sq || kbase + 64 > sk ||
                      (causal && kbase + 63 > qbase + offset) ||
                      seg != nullptr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);  // query column in the tile
        bool keep = true;
        if (edge) {
          const int key = e < 2 ? key0 : key1, row = qbase + c;
          keep = row < sq && key < sk;
          if (causal) keep = keep && key <= row + offset;
          if (seg != nullptr && keep)
            keep = seg[(size_t)bi * sk + row] == (e < 2 ? kseg0 : kseg1);
        }
        // a kept pair's row saw a key, so its lse is finite and P <= 1
        p[nt][e] = keep ? mma::ex2(fmaf(p[nt][e], scale2, -L[c] * kLog2e))
                        : 0.f;
      }

    // dV += P^T dO (P^T rounded to T in registers)
    mma::acc_times_tile<T, D>(acc_v, p, dOt, lane);

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in place
    float ds[8][4];
    mma::rows_by_rows<T, D>(ds, Vw, dOt, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - Dl[nt * 8 + 2 * t + (e & 1)]) *
                    scale;

    // dK += dS^T Q (dS^T rounded to T in registers)
    mma::acc_times_tile<T, D>(acc_k, ds, Qt, lane);
    __syncthreads();  // the stage is refilled two items on
  }

  mma::cp_async_wait<0>();  // a block with no item still has K, V landing
  const size_t out_off = (size_t)bi * sk * k_stride + (size_t)hkv * D;
  const size_t part_n = (size_t)b * sk * k_stride;
  float* pk = part == nullptr ? nullptr : part + split * part_n + out_off;
  float* pv = part == nullptr ? nullptr
                              : part + (splits + split) * part_n + out_off;
  store_acc<T, D>(dk + out_off, pk, acc_k, k_stride, key0, sk, t);
  store_acc<T, D>(dv + out_off, pv, acc_v, k_stride, key0, sk, t);
}

// out[i] = sum over s of part[s][i], s in order, for dK (part[0..splits))
// then dV (part[splits..2 splits)), written as T; n divisible by 4.
template <typename T>
__global__ void dkv_sum_splits_kernel(const float* __restrict__ part,
                                      T* __restrict__ dk, T* __restrict__ dv,
                                      size_t n, int splits) {
  const size_t stride = (size_t)gridDim.x * blockDim.x * 4;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < 2 * n; i += stride) {
    const int which = i < n ? 0 : 1;
    const size_t at = i - which * n;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + ((size_t)which * splits + sp) * n + at);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    T* out = (which == 0 ? dk : dv) + at;
    reinterpret_cast<uint32_t*>(out)[0] = mma::pack2<T>(acc.x, acc.y);
    reinterpret_cast<uint32_t*>(out)[1] = mma::pack2<T>(acc.z, acc.w);
  }
}

// ---------------------------------------------------------------------------
// dQ, bf16 / fp16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kDqWarps = 4;  // 16 q rows each: one 64-row q tile a block
constexpr int kDqThreads = kDqWarps * 32;

template <int D>
struct DqMmaSmem {  // elements of T: Q, dO [64][LDS], then 2 x {K, V}
  static constexpr int LDS = mma::kLd<D>;
  static constexpr int TILE = 64 * LDS;
  static constexpr int BYTES = 6 * TILE * 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads, 2)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg, T* __restrict__ dq,
                        int sq, int sk, int hq, int hk, float scale,
                        int causal) {
  using S = DqMmaSmem<D>;
  constexpr int LDS = S::LDS, TILE = S::TILE;
  constexpr int KS = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int DN = D / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE;
  T* ring = dOs + TILE;  // stage s: K at ring + 2 s TILE, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (sq + 63) / 64;
  const int n_bh = gridDim.x / n_qt;            // b * hq
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;  // heavy tiles first
  const int h = bh % hq, bi = bh / hq;
  const int hkv = h / (hq / hk);
  const int qbase = qt * 64;
  const int offset = sk - sq;
  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hk * D;
  const size_t q_off = (size_t)bi * sq * q_stride + (size_t)h * D;
  const T* kp = k + (size_t)bi * sk * k_stride + (size_t)hkv * D;
  const T* vp = v + (size_t)bi * sk * k_stride + (size_t)hkv * D;

  const int qlast = min(qbase + 64, sq) - 1;
  const int kend = causal ? min(sk, qlast + offset + 1) : sk;
  const int n_kt = kend > 0 ? (kend + 63) / 64 : 0;

  mma::cp_async_rows<T, D, 64, kDqThreads>(Qs, q + q_off, q_stride, qbase,
                                           sq, tid);
  mma::cp_async_rows<T, D, 64, kDqThreads>(dOs, dout + q_off, q_stride,
                                           qbase, sq, tid);
  mma::cp_async_commit();
  if (n_kt > 0) {
    mma::cp_async_rows<T, D, 64, kDqThreads>(ring, kp, k_stride, 0, sk, tid);
    mma::cp_async_rows<T, D, 64, kDqThreads>(ring + TILE, vp, k_stride, 0,
                                             sk, tid);
  }
  mma::cp_async_commit();

  // this thread's rows: lse in log2 units, delta, segment
  const int row0 = qbase + warp * 16 + g, row1 = row0 + 8;
  const float* lrow = lse + ((size_t)bi * hq + h) * sq;
  const float* drow = delta + ((size_t)bi * hq + h) * sq;
  const float lse0 = row0 < sq ? lrow[row0] * kLog2e : 0.f;
  const float lse1 = row1 < sq ? lrow[row1] * kLog2e : 0.f;
  const float delta0 = row0 < sq ? drow[row0] : 0.f;
  const float delta1 = row1 < sq ? drow[row1] : 0.f;
  int qseg0 = 0, qseg1 = 0;
  if (seg != nullptr) {
    qseg0 = row0 < sq ? seg[(size_t)bi * sk + row0] : -1;
    qseg1 = row1 < sq ? seg[(size_t)bi * sk + row1] : -1;
  }

  mma::cp_async_wait<1>();  // the Q and dO tiles have landed
  __syncthreads();
  // this warp's 16 query rows as A fragments, for the whole key walk
  uint32_t qf[KS][4];
  uint32_t dof[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma::load_a<D>(qf[kk], Qs, warp * 16, kk * 16, lane);
    mma::load_a<D>(dof[kk], dOs, warp * 16, kk * 16, lane);
  }

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  const float scale2 = scale * kLog2e;  // exp(x scale) = 2^(x scale2)

  for (int j = 0; j < n_kt; ++j) {
    const int kbase = j * 64;
    if (j + 1 < n_kt) {  // tile j + 1 into the other stage
      T* nk = ring + ((j + 1) & 1) * 2 * TILE;
      mma::cp_async_rows<T, D, 64, kDqThreads>(nk, kp, k_stride, kbase + 64,
                                               sk, tid);
      mma::cp_async_rows<T, D, 64, kDqThreads>(nk + TILE, vp, k_stride,
                                               kbase + 64, sk, tid);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const T* Kt = ring + (j & 1) * 2 * TILE;
    const T* Vt = Kt + TILE;

    // S = Q K^T (16 rows x 64 keys), then P = 2^(S scale2 - lse2)
    float p[8][4];
    mma::frags_by_rows<T, D>(p, qf, Kt, lane);
    // the mask only where the tile crosses the diagonal or an edge (or
    // any tile with segment ids): a row that sees no key (lse -1e30) lies
    // in such a tile, so its overflowing exponent is never taken
    const bool edge = kbase + 64 > sk ||
                      (causal && kbase + 63 > qbase + offset) ||
                      seg != nullptr;
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = kbase + nt * 8 + 2 * t + (e & 1);
          bool keep = col < sk;
          if (causal) keep = keep && col <= row + offset;
          if (seg != nullptr && keep)
            keep = seg[(size_t)bi * sk + col] == (e < 2 ? qseg0 : qseg1);
          p[nt][e] = keep ? mma::ex2(fmaf(p[nt][e], scale2,
                                          -(e < 2 ? lse0 : lse1)))
                          : 0.f;
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = mma::ex2(fmaf(p[nt][e], scale2, -(e < 2 ? lse0 : lse1)));
    }

    // dP = dO V^T, then dS = P (dP - delta) scale in place
    float ds[8][4];
    mma::frags_by_rows<T, D>(ds, dof, Vt, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - (e < 2 ? delta0 : delta1)) *
                    scale;

    // dQ += dS K (dS rounded to T in registers, K read by ldmatrix.trans)
    mma::acc_times_tile<T, D>(acc, ds, Kt, lane);
    __syncthreads();  // the stage is refilled two tiles on
  }

  // stage dQ in this warp's own rows of the Q tile (only it read them)
  T* Os = Qs + warp * 16 * LDS;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(Os + g * LDS + col) =
        mma::pack2<T>(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * LDS + col) =
        mma::pack2<T>(acc[dn][2], acc[dn][3]);
  }
  __syncwarp();
  T* op = dq + q_off;
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int idx = lane + i * 32;
    const int r = idx / CH, c = idx % CH;
    const int row = qbase + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(op + (size_t)row * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LDS + c * 8);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t opt_in_smem(Kern kern, int bytes, bool* done) {
  if (*done) return cudaSuccess;  // the opt-in above 48 KB, once per variant
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int D>
cudaError_t launch_dq_simt(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const int* seg, void* dq,
                           int b, int sq, int sk, int hq, int hk, float scale,
                           int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, DqSmem<D>::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + BQ - 1) / BQ;
  kern<<<dim3(b * hq * n_qt), kThreads, DqSmem<D>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, seg, static_cast<float*>(dq), sq, sk, hq, hk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const int* seg, void* dq, int b,
                          int sq, int sk, int hq, int hk, float scale,
                          int causal, cudaStream_t stream) {
  using S = DqMmaSmem<D>;
  auto kern = flash_bwd_dq_mma_kernel<T, D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, S::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + 63) / 64;
  kern<<<dim3(b * hq * n_qt), kDqThreads, S::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, seg,
      static_cast<T*>(dq), sq, sk, hq, hk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_simt(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* seg, void* dk,
                            void* dv, float* part, int b, int sq, int sk,
                            int hq, int hk, float scale, int causal,
                            int splits, cudaStream_t stream) {
  if (splits != 1 || part != nullptr) return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_kernel<D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, DkvSmem<D>::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_kt = (sk + BK - 1) / BK;
  kern<<<dim3(b * hk * n_kt), kThreads, DkvSmem<D>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, seg, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk,
      hq, hk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const int* seg, void* dk,
                           void* dv, float* part, int b, int sq, int sk,
                           int hq, int hk, float scale, int causal,
                           int splits, cudaStream_t stream) {
  if (splits < 1 || (splits > 1) != (part != nullptr))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_mma_kernel<T, D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, DkvMmaSmem<D>::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_kt = (sk + 63) / 64;
  kern<<<dim3(n_kt * b * hk * splits), kDkvThreads, DkvMmaSmem<D>::BYTES,
         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, seg,
      static_cast<T*>(dk), static_cast<T*>(dv), part, b, sq, sk, hq, hk,
      scale, causal, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)b * sk * hk * D;
  const size_t want = (2 * n / 4 + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  dkv_sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), n, splits);
  return cudaGetLastError();
}

bool bad_shape(int b, int sq, int sk, int hq, int hk, const void* seg) {
  return b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0 ||
         (seg != nullptr && sq != sk);
}

// the body a launcher ran, reported through its `body` argument
constexpr int kBodySimt = 0;  // CUDA cores (fp32)
constexpr int kBodyMma = 1;   // tensor cores (bf16 / fp16)

int ran(cudaError_t err, int which, int* body) {
  if (err == cudaSuccess) *body = which;
  return err;
}

}  // namespace

// q / dout [b, sq, hq, d], k / v [b, sk, hk, d], lse and delta fp32
// [b, hq, sq], seg int32 [b, sk] or null (requires sq == sk); dq
// [b, sq, hq, d] in q's dtype.  All contiguous.  fp32 runs the CUDA-core
// body, bf16 and fp16 the tensor-core body; *body is set to the body that
// was launched (kBodySimt or kBodyMma), and left as it is when nothing
// was.  Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dq, int b,
    int sq, int sk, int hq, int hk, int d, float scale, int causal, int dtype,
    void* stream, int* body) {
  if (bad_shape(b, sq, sk, hq, hk, seg)) return cudaErrorInvalidValue;
#define DQ_ARGS                                                           \
  q, k, v, dout, static_cast<const float*>(lse),                          \
      static_cast<const float*>(delta), static_cast<const int*>(seg), dq, \
      b, sq, sk, hq, hk, scale, causal, static_cast<cudaStream_t>(stream)
  switch (dtype * 1000 + d) {
    case kFloat32 * 1000 + 64:
      return ran(launch_dq_simt<64>(DQ_ARGS), kBodySimt, body);
    case kFloat32 * 1000 + 128:
      return ran(launch_dq_simt<128>(DQ_ARGS), kBodySimt, body);
    case kBFloat16 * 1000 + 64:
      return ran(launch_dq_mma<__nv_bfloat16, 64>(DQ_ARGS), kBodyMma, body);
    case kBFloat16 * 1000 + 128:
      return ran(launch_dq_mma<__nv_bfloat16, 128>(DQ_ARGS), kBodyMma, body);
    case kFloat16 * 1000 + 64:
      return ran(launch_dq_mma<__half, 64>(DQ_ARGS), kBodyMma, body);
    case kFloat16 * 1000 + 128:
      return ran(launch_dq_mma<__half, 128>(DQ_ARGS), kBodyMma, body);
  }
#undef DQ_ARGS
  return cudaErrorInvalidValue;
}

// As above, writing dk / dv [b, sk, hk, d] in k's dtype.  fp32 runs the
// CUDA-core body (splits 1, no scratch); bf16 and fp16 the tensor-core
// body, whose walk is split over `splits` blocks when splits > 1, with
// `scratch` fp32 [2, splits, b, sk, hk, d] for the partial sums (null when
// splits == 1).  *body as for dQ.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
    void* scratch, int b, int sq, int sk, int hq, int hk, int d, float scale,
    int causal, int splits, int dtype, void* stream, int* body) {
  if (bad_shape(b, sq, sk, hq, hk, seg)) return cudaErrorInvalidValue;
#define DKV_ARGS                                                            \
  q, k, v, dout, static_cast<const float*>(lse),                            \
      static_cast<const float*>(delta), static_cast<const int*>(seg), dk,   \
      dv, static_cast<float*>(scratch), b, sq, sk, hq, hk, scale, causal,   \
      splits, static_cast<cudaStream_t>(stream)
  switch (dtype * 1000 + d) {
    case kFloat32 * 1000 + 64:
      return ran(launch_dkv_simt<64>(DKV_ARGS), kBodySimt, body);
    case kFloat32 * 1000 + 128:
      return ran(launch_dkv_simt<128>(DKV_ARGS), kBodySimt, body);
    case kBFloat16 * 1000 + 64:
      return ran(launch_dkv_mma<__nv_bfloat16, 64>(DKV_ARGS), kBodyMma, body);
    case kBFloat16 * 1000 + 128:
      return ran(launch_dkv_mma<__nv_bfloat16, 128>(DKV_ARGS), kBodyMma,
                 body);
    case kFloat16 * 1000 + 64:
      return ran(launch_dkv_mma<__half, 64>(DKV_ARGS), kBodyMma, body);
    case kFloat16 * 1000 + 128:
      return ran(launch_dkv_mma<__half, 128>(DKV_ARGS), kBodyMma, body);
  }
#undef DKV_ARGS
  return cudaErrorInvalidValue;
}
