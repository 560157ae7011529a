// Tensor-core and asynchronous-copy helpers shared by the port's CUDA
// kernels (sm_80 and later instructions, built here for sm_90a):
//   - cp.async: 16-byte global -> shared copies (zero-filled when the
//     source row lies past the edge), 4-byte ones, commit and wait;
//   - ldmatrix: four 8 x 8 b16 matrices from shared memory into the
//     m16n8k16 operand layouts, plain or transposed;
//   - mma.sync m16n8k16 with bf16 or fp16 operands and fp32 sums;
//   - ex2: 2^x on the special-function unit, for softmax in log2 units;
//   - packing two fp32 values into one register of two b16 values;
//   - b16 tiles of D-column rows in shared memory: their cp.async fill,
//     their ldmatrix operands, and the product of a 16 x 64 block of
//     accumulators with a 64 x D tile.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 g + t):
//   A 16 x 16: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//              a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, those cols);
//   B 16 x 8:  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C 16 x 8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same).
// So the accumulators of two neighbouring n-tiles, packed pairwise, are
// the A operand of a product over those 16 columns (FlashAttention-2's
// P kept in registers).
#pragma once

#include "common.cuh"

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; writes zeros when !valid (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and r[i] receives matrix i in the fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores, b16 operands of type T, fp32 sums.
template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float c[4],
                                                        const uint32_t a[4],
                                                        uint32_t b0,
                                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float c[4],
                                                 const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (what __expf runs after its multiply
// by log2 e); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to T (nearest even), lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a product over 16 columns from the fp32 accumulators of
// the two n-tiles that cover them (c0 columns 0-7, c1 columns 8-15),
// rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Tiles: rows of D b16 values padded by 16 bytes (kLd<D> elements), so the
// eight rows that one ldmatrix phase reads fall on distinct banks.
template <int D>
constexpr int kLd = D + 8;

// cp.async rows [base, base + ROWS) of one head's [seq, D] slice (row i at
// src + i * stride) into a [ROWS][kLd<D>] tile, by NT threads; rows past
// `limit` are zeros.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void cp_async_rows(T* dst, const T* src,
                                              size_t stride, int base,
                                              int limit, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CH) % NT == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / CH, c = idx % CH;
    const bool ok = base + r < limit;
    cp_async16(dst + r * kLd<D> + c * 8,
               src + (size_t)(ok ? base + r : 0) * stride + c * 8, ok);
  }
}

// The A operand: the 16 x 16 block at rows r, columns c of a tile.
template <int D, typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* tile, int r,
                                       int c, int lane) {
  ldmatrix_x4(a, tile + (r + (lane & 15)) * kLd<D> + c + (lane >> 4) * 8);
}

// The B operands of two n-tiles whose n runs along the tile's rows r..r+15
// and k along its columns c..c+15 (the tile transposed, as K in Q K^T):
// b[0], b[1] for rows r..r+7, b[2], b[3] for rows r+8..r+15.
template <int D, typename T>
__device__ __forceinline__ void load_b_rows(uint32_t b[4], const T* tile,
                                            int r, int c, int lane) {
  ldmatrix_x4(b, tile + (r + (lane & 7) + ((lane >> 4) << 3)) * kLd<D> + c +
                     ((lane >> 3) & 1) * 8);
}

// The B operands of two n-tiles whose k runs along the tile's rows r..r+15
// and n along its columns c..c+15 (the tile as it is, as V in P V), read
// transposed: b[0], b[1] for columns c..c+7, b[2], b[3] for c+8..c+15.
template <int D, typename T>
__device__ __forceinline__ void load_b_cols(uint32_t b[4], const T* tile,
                                            int r, int c, int lane) {
  ldmatrix_x4_trans(b,
                    tile + (r + (lane & 15)) * kLd<D> + c + (lane >> 4) * 8);
}

// out (16 rows x D: D / 8 n-tiles) += M (16 x 64 fp32 accumulators in 8
// n-tiles, rounded to T as the A operand) times the 64 x D tile: O += P V
// in the forward, dV += P^T dO and dK += dS^T Q in the backward.
template <typename T, int D>
__device__ __forceinline__ void acc_times_tile(float out[D / 8][4],
                                               const float m[8][4],
                                               const T* tile, int lane) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    uint32_t a[4];
    acc_to_a<T>(a, m[2 * kq], m[2 * kq + 1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      load_b_cols<D>(b, tile, kq * 16, dp * 16, lane);
      mma16816<T>(out[2 * dp], a, b[0], b[1]);
      mma16816<T>(out[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace mma
