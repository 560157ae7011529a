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
// card needs before memory is the limit, so the tensor cores' rate is the
// ceiling (989 TFLOP/s bf16 dense; mma.sync reaches roughly two thirds of
// it, wgmma the rest).
//
// Two bodies, chosen by dtype in the launcher (explicit routing: neither
// is a fallback for the other):
//
// bf16 / fp16: tensor cores (flash_fwd_mma_kernel).  It rounds where JAX
// _fwd_kernel rounds: S = Q K^T from b16 operands with fp32 sums, the
// online softmax in fp32, P rounded to the input dtype for P V with fp32
// sums, l the fp32 sum of the unrounded P.  One block per (batch, q head,
// q tile of 16 * kFwdWarps rows), each warp 16 query rows; the blocks walk
// the q tiles in reverse so that under the causal mask the heaviest go
// first.  The Q fragments are loaded once with ldmatrix and stay in
// registers.  64-key K and V tiles (b16, rows padded by 16 bytes so the
// eight rows an ldmatrix phase reads fall on distinct banks) sit in a
// two-stage ring in shared memory filled with 16-byte cp.async: tile j + 1
// is in flight while tile j is computed.  S = Q K^T and O += P V are
// mma.sync.m16n8k16 products; the row max and sum are taken on the
// accumulator fragments (a row's 4 threads, two shuffles) in log2 units,
// so that each score costs one FFMA and one ex2, and only tiles that cross
// the causal diagonal or the ragged key edge (or any tile when segment ids
// are given) evaluate the mask.  P is packed to b16 in
// registers and used directly as the A operand of P V: the m16n8
// accumulators of two n-tiles are the m16n8k16 A layout, so P never goes
// through shared memory.  The epilogue scales O by 1 / l, stages it in the
// Q tile's shared memory and stores coalesced 16-byte rows.
// Shared memory at d = 128: the Q tile 17 KB plus the ring 2 x 2 x 17 KB,
// 85 KB, so two blocks fit on an SM.  nvcc -Xptxas -v (CUDA 12.8, sm_90a):
// 242 registers a thread at d = 128, 168 at d = 64, no spills, so two
// 128-thread blocks a SM fit the register file too.  4 warps (64-row
// tiles) against 8 (128 rows, one block a SM by registers), timed with
// kernels/attention_probe.py: 4 faster at the serving prefill shape (by
// 3%) and at Falcon-7B's (71 heads, d = 64; by 22%), 8 faster at seq 4096
// (by 4%).  The serving shapes decide: 4.  What holds it back from the
// bound: mma.sync issues a 16 x 8 x 16 product per warp instruction and
// reaches about two thirds of the tensor cores' rate at best; wgmma with
// TMA and a producer warp (one warpgroup of 64 rows a product) is the way
// to the rest.
//
// fp32: CUDA-core FMAs (flash_fwd_kernel), the body of the first port.  The
// tensor cores have no fp32 product other than TF32, which would change
// what fp32 computes.  One block per (batch, q head, 64-row q tile), 256
// threads; the q tile is staged once; a loop walks 64-column k/v tiles
// (stopping at the causal diagonal) staged in shared memory as fp32.  Each
// thread owns a 4x4 patch of the score tile and a 4-row x d/16-column patch
// of the output, so both products are register-blocked FMAs fed by 16-byte
// shared loads; a row's softmax statistics are reduced across the 16
// threads that share it with warp shuffles.
//
// Ragged sq / sk edges are masked in the kernel, not padded by the caller.
#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core body
// ---------------------------------------------------------------------------

// Warps per block, 16 query rows each (64-row q tiles).  A thread holds its
// Q fragments (32 registers at d = 128), the O accumulators (64) and a
// score tile (32), so two 4-warp blocks a SM (255 registers a thread at
// most) fit in registers and in shared memory (2 x 85 KB).
constexpr int kFwdWarps = 4;
constexpr int MBK = 64;  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int W>
struct MmaSmem {  // elements of T: Q [BQ][LDS], then 2 x {K, V} [MBK][LDS]
  static constexpr int BQ = 16 * W;
  static constexpr int LDS = mma::kLd<D>;
  static constexpr int TILE = MBK * LDS;
  static constexpr int BYTES = (BQ * LDS + 4 * TILE) * 2;
};

template <typename T, int D, int W>
__global__ void __launch_bounds__(W * 32, 8 / W)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ out, float* __restrict__ lse, int sq,
                     int sk, int hq, int hk, float scale, int causal) {
  using S = MmaSmem<D, W>;
  constexpr int NT = W * 32, BQ = S::BQ, LDS = S::LDS, TILE = S::TILE;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int DN = D / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + BQ * LDS;  // stage s: K at ring + 2 s TILE, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;                 // b * hq
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;       // heavy tiles first
  const int h = bh % hq, bi = bh / hq;
  const int hkv = h / (hq / hk);
  const int qbase = qt * BQ;
  const int offset = sk - sq;
  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hk * D;
  const T* qp = q + (size_t)bi * sq * q_stride + (size_t)h * D;
  const T* kp = k + (size_t)bi * sk * k_stride + (size_t)hkv * D;
  const T* vp = v + (size_t)bi * sk * k_stride + (size_t)hkv * D;

  const int qlast = min(qbase + BQ, sq) - 1;
  const int kend = causal ? min(sk, qlast + offset + 1) : sk;
  const int n_kt = kend > 0 ? (kend + MBK - 1) / MBK : 0;

  mma::cp_async_rows<T, D, BQ, NT>(Qs, qp, q_stride, qbase, sq, tid);
  mma::cp_async_commit();
  if (n_kt > 0) {
    mma::cp_async_rows<T, D, MBK, NT>(ring, kp, k_stride, 0, sk, tid);
    mma::cp_async_rows<T, D, MBK, NT>(ring + TILE, vp, k_stride, 0, sk,
                                        tid);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole key loop
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    mma::load_a<D>(qf[kk], Qs, warp * 16, kk * 16, lane);

  const int row0 = qbase + warp * 16 + g, row1 = row0 + 8;
  int qseg0 = 0, qseg1 = 0;
  if (seg != nullptr) {
    qseg0 = row0 < sq ? seg[(size_t)bi * sk + row0] : -1;
    qseg1 = row1 < sq ? seg[(size_t)bi * sk + row1] : -1;
  }

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  const float scale2 = scale * kLog2e;   // exp(x scale) = 2^(x scale2)

  for (int j = 0; j < n_kt; ++j) {
    const int kbase = j * MBK;
    if (j + 1 < n_kt) {  // tile j + 1 into the other stage
      T* nk = ring + ((j + 1) & 1) * 2 * TILE;
      mma::cp_async_rows<T, D, MBK, NT>(nk, kp, k_stride, kbase + MBK, sk,
                                          tid);
      mma::cp_async_rows<T, D, MBK, NT>(nk + TILE, vp, k_stride,
                                          kbase + MBK, sk, tid);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const T* Kt = ring + (j & 1) * 2 * TILE;
    const T* Vt = Kt + TILE;

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        mma::load_b_rows<D>(b, Kt, np * 16, kk * 16, lane);
        mma::mma16816<T>(s[2 * np], qf[kk], b[0], b[1]);
        mma::mma16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // the mask only where the tile crosses the diagonal or an edge
    const bool edge = kbase + MBK > sk ||
                      (causal && kbase + MBK - 1 > qbase + offset) ||
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
          if (!keep) s[nt][e] = -INFINITY;
        }
    }

    // online softmax on the fragments, in log2 units (m0, m1 are running
    // maxima of S scale log2 e; scale > 0 keeps the raw max the max): a
    // row's 4 threads share its max through two shuffles
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m0, mx0 * scale2);
    mx1 = fmaxf(m1, mx1 * scale2);
    // a row with no visible key yet keeps max -inf: P = 0, alpha = 1
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float a0 = mma::ex2(m0 - base0), a1 = mma::ex2(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = mma::ex2(fmaf(s[nt][0], scale2, -base0));
      s[nt][1] = mma::ex2(fmaf(s[nt][1], scale2, -base0));
      s[nt][2] = mma::ex2(fmaf(s[nt][2], scale2, -base1));
      s[nt][3] = mma::ex2(fmaf(s[nt][3], scale2, -base1));
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }

    // O += P V: P rounded to T in registers as the A operand
    mma::acc_times_tile<T, D>(o, s, Vt, lane);
    __syncthreads();  // the stage is refilled two tiles on
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  // stage O in this warp's own rows of the Q tile (only it read them)
  T* Os = Qs + warp * 16 * LDS;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(Os + g * LDS + col) =
        mma::pack2<T>(o[dn][0] * inv0, o[dn][1] * inv0);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * LDS + col) =
        mma::pack2<T>(o[dn][2] * inv1, o[dn][3] * inv1);
  }
  __syncwarp();
  T* op = out + (size_t)bi * sq * q_stride + (size_t)h * D;
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
  if (t == 0) {
    float* lrow = lse + ((size_t)bi * hq + h) * sq;
    if (row0 < sq) lrow[row0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kNoKeyLse;
    if (row1 < sq) lrow[row1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kNoKeyLse;
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
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const int* seg, void* out, float* lse, int b, int sq,
                        int sk, int hq, int hk, float scale, int causal,
                        cudaStream_t stream) {
  auto kern = flash_fwd_kernel<float, D>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, Smem<D>::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + BQ - 1) / BQ;
  kern<<<dim3(b * hq * n_qt), kThreads, Smem<D>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, static_cast<float*>(out), lse, sq,
      sk, hq, hk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* seg, void* out, float* lse, int b, int sq,
                       int sk, int hq, int hk, float scale, int causal,
                       cudaStream_t stream) {
  using S = MmaSmem<D, kFwdWarps>;
  auto kern = flash_fwd_mma_kernel<T, D, kFwdWarps>;
  static bool smem_set = false;
  cudaError_t err = opt_in_smem(kern, S::BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + S::BQ - 1) / S::BQ;
  kern<<<dim3(b * hq * n_qt), kFwdWarps * 32, S::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), lse, sq, sk, hq,
      hk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [b, sq, hq, d], k/v [b, sk, hk, d], seg int32 [b, sk] or null (requires
// sq == sk), out [b, sq, hq, d] in q's dtype, lse fp32 [b, hq, sq]; all
// contiguous.  fp32 runs the CUDA-core body, bf16 and fp16 the tensor-core
// body; *body is set to the body that was launched (kBodySimt or kBodyMma),
// and left as it is when nothing was.  Returns the launch's cudaError_t (0
// = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* seg,
                                      void* out, void* lse, int b, int sq,
                                      int sk, int hq, int hk, int d,
                                      float scale, int causal, int dtype,
                                      void* stream, int* body) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0)
    return cudaErrorInvalidValue;
  if (seg != nullptr && sq != sk) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  float* ls = static_cast<float*>(lse);
#define FWD_ARGS q, k, v, sg, out, ls, b, sq, sk, hq, hk, scale, causal, s
  switch (dtype * 1000 + d) {
    case kFloat32 * 1000 + 64:
      return ran(launch_simt<64>(FWD_ARGS), kBodySimt, body);
    case kFloat32 * 1000 + 128:
      return ran(launch_simt<128>(FWD_ARGS), kBodySimt, body);
    case kBFloat16 * 1000 + 64:
      return ran(launch_mma<__nv_bfloat16, 64>(FWD_ARGS), kBodyMma, body);
    case kBFloat16 * 1000 + 128:
      return ran(launch_mma<__nv_bfloat16, 128>(FWD_ARGS), kBodyMma, body);
    case kFloat16 * 1000 + 64:
      return ran(launch_mma<__half, 64>(FWD_ARGS), kBodyMma, body);
    case kFloat16 * 1000 + 128:
      return ran(launch_mma<__half, 128>(FWD_ARGS), kBodyMma, body);
  }
#undef FWD_ARGS
  return cudaErrorInvalidValue;
}
