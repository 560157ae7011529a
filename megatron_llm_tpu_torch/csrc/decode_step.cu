// The whole decoder stack for one new token per row, in one cooperative
// launch: K12 (dense cache), K13 (paged pool) and K14 (paged pool, a W-wide
// speculative window per slot, a linear run or a candidate tree), one
// device body for all of them.
//
// Replaces the TPU kernels of megatron_llm_tpu/kernels/decode_step.py:
//   K12 fused_decode_step          (_decode_step_kernel)
//   K13 fused_decode_step_paged    (_decode_step_kernel_paged, W = 1)
//   K14 fused_decode_verify_paged  (_decode_step_kernel_paged, linear W,
//       and its tree mode: depths / anc, the splice of :638-673)
// Per layer, for every row: RMSNorm; the q/k/v GEMVs (int8 weights: the
// column scale after the dot; int4: group-dequantized as the tile loads);
// interleaved-pair RoPE at the row's own position; attention over the
// row's cache columns [0, fill) with the row's own new K/V folded in last;
// wo and the residual; RMSNorm; gate/up; act(gate) * up in the compute
// dtype; w_down as nm partial sums, each added to the residual in turn.
// The residual stays fp32 from the first layer to the last.
//
// What bounds it on the H100: bytes.  A decode step with a handful of rows
// does ~2 flops per weight byte it reads, and the attention a few per
// cache byte, against the card's ~295: a step can only be as fast as it
// streams the layer weights (13 GB for Llama-2-7B in bf16) and the live
// cache once.  The composed route also pays hundreds of launches per step
// and a gather of the cache; this one pays one launch and no copy.
//
// Design.  One cooperative launch, one block a SM.  A grid-wide barrier (a
// counter in global memory; the launch guarantees every block is
// resident) separates the five phases of a layer: norm+qkv | attention |
// wo | norm+gate/up | w_down.  Two bodies run the GEMV phases, chosen by
// dtype in the C launcher, which reports the one it ran:
// - bf16: the TMA weight stream (kernels/decode_probe.py split the
//   CUDA-core body's time by phase: its GEMV phases ran at 0.8-1.1 TB/s,
//   one chunk of loads in flight a thread and the stream idle behind
//   every barrier and restaging).
//   * Tiles of 1 KB of a stored weight row (512 bf16 or 1024 int8 / packed
//     int4 columns; 1 KB contiguous runs of device memory), contraction
//     chunks of 128 stored rows; an item is (tile, chunk).  Items are dealt
//     round robin over the blocks, so the phases are balanced whatever the
//     matrix widths (wo's and w_down's too).
//   * Each stage of a 3-stage ring in shared memory is 16 stored rows of a
//     tile (48 KB in flight a SM; a 5-stage ring timed slower on the
//     H100, PERF.md: it leaves the L1 less room for register spills):
//     TMA boxes (cp.async.bulk.tensor, one 3-D map [L, K, N] per
//     weight built on the host through cudaGetDriverEntryPoint, passed as
//     __grid_constant__) land on an mbarrier with their byte count.  The
//     zero fill past the matrix edges covers ragged tiles; the epilogue
//     masks its stores.
//   * A producer warpgroup whose first thread issues every box of every
//     item the block will take (the schedule is fixed by the shapes), in
//     order, across phases and layers: it waits only for a free stage, so
//     the next phase's and the next layer's boxes land while the compute
//     warps attend, run a LoRA x . A phase or wait at a grid barrier.  The
//     compute warps synchronise on named barrier 1 (csync); registers move
//     to them (setmaxnreg).
//   * The products on the CUDA cores: at 4 rows a weight byte takes 4 FMAs
//     (bf16: 2), under the card's FMA rate at 3.35 TB/s; at K14's 16 rows
//     about its rate.  mma.sync would have to widen every int8 and int4
//     weight to bf16 anyway and pad 4 rows to 16; it is left for a later
//     PR.  A thread owns 4 columns of 8 (bf16) or 16 rows of each stage
//     and sums each row over the chunk in order in registers.  Weights
//     widen exactly (int8 through 2^23 + byte); an int8 column scale comes
//     after the combine, an int4 group scale per nibble as before.
//   * Each item's fp32 partial goes to scratch (it stays in L2).  After a
//     grid barrier every block takes its share of the phase's (tile, 32
//     columns) units, adds their chunks in chunk order and runs the
//     epilogue (RoPE, the residual, the LoRA delta, w_down's nm segment
//     sums added to the residual in turn): one more barrier a GEMV phase,
//     which the producer streams through, and no block waits for another's
//     chunks.
//   * The rows' inputs are staged as fp32 values rounded to T: whole when
//     16 rows x K fit 64 KB (K13's q/k/v, wo, gate/up), else each item's
//     chunk.  A row's bits depend on the chunk partition (the shapes'), its
//     own inputs and the fixed orders above, never on the grid or the row
//     count, so K12, K13 and K14 give a row the same bits.
// - fp32: the CUDA-core body.  A block owns a tile of 32 output columns
//   and does the whole contraction over it.  The rows' inputs (normed, or
//   the context, or act(gate) * up, each rounded to the compute dtype) are
//   staged in shared memory once for all of the block's tiles of the phase
//   (in pieces where they do not fit), so each weight element is read from
//   device memory once per layer for up to 16 rows.  The contraction rows
//   are split into 64 fixed streams, each summed in order in registers,
//   then combined in a fixed tree (three shuffle levels, then the 8 warps
//   in order).  A thread loads 8 columns of 4 rows of its stream at a time
//   and the next chunk's loads are issued before this one's products.
//   Nothing depends on the grid size or on how many rows the call has
//   (rows go 16 at a time, each with its own accumulators).
// Each block recomputes the rows' RMS statistics itself (identical code,
// identical bits), which saves two barriers a layer.
// - Attention phase: one block per (row, kv head) at a time, laid out as
//   csrc/flash_decode.cu's decode body: lane groups own cache columns, 16
//   bytes a thread, each group with its own online softmax, merged in a
//   fixed order.  Which group takes column j depends on j alone, whatever
//   the cache layout: column j is cache[slot][head][j] (dense) or
//   pool[table[slot][j >> shift]][head][j & (block - 1)] (paged).  For a
//   window row j at depth t > 0 (t = j in a linear window), the columns
//   fill .. fill + t - 1 are spliced from the slot's in-flight window rows
//   (a linear window: rows 0 .. j - 1; a tree: the row's ancestors
//   anc[j][0 .. t - 1]), converted to exactly what a pool round trip
//   returns (cast through the pool's dtype, or fake-quantized twice for an
//   int8 pool), so K14's row j sees the values and columns of the t-th
//   sequential K13 step down its root path, bit for bit.  The row's own
//   key and value fold in last, raw.  A tree costs no template
//   instantiation: null depths mean the linear window, whose code and bits
//   are the same as before the tree mode.  No column past the fill is read, and a group that
//   saw no live column keeps m = -inf, l = 0: a free slot at fill 0
//   attends its own token only, with no 0 x inf.
// - The int8 requantization of the new rows and of the splice rounds as
//   ops/kv_quant.py does: scale = amax * fp32(1/127), a true division,
//   round half to even (__fmul_rn / __fdiv_rn / rintf: no contraction).
// Scratch (residual, q, new K/V, context, gate, up) is allocated by the
// wrapper and stays in L2.
//
// The LoRA epilogue (JAX _decode_step_kernel's lora_add, with the arenas of
// ops/lora.py): for each target t with an arena, y_t += ((x_t . A_t) (.)
// mask) . B_t in fp32, where x_t is the projection's fp32 input before any
// rounding (the normed residual, the context, act(gate) * up: the staged
// GEMV copy is rounded to T, so the epilogue never reads it), A_t [in, Sr]
// and B_t [Sr, out] are the layer's arena slices (alpha / r folded into B)
// and the mask [rows, Sr] selects each row's adapter columns.
// - x . A needs the whole contraction before any B column can use it, so
//   it is a phase of its own before each consumer (a grid barrier between):
//   q/k/v (before RoPE), wo, gate/up, and w_down (added to the residual
//   once, after the last MLP chunk).  A work item is (target, 512-row
//   contraction chunk, 32 arena columns) for every row: its sum runs in a
//   fixed order (32 streams of 16 rows, the streams of a warp by shuffles,
//   the warps in order) into a partial-sum scratch; the consumer adds a
//   column's chunks in chunk order.  Items of 32 columns that no row's mask
//   selects are skipped, and a launch whose mask is all zero takes no
//   LoRA phase at all.
// - The consumer's tile (32 output columns, up to 16 rows) sums, per row,
//   (x . A)[j] * mask[j] * B[j][col] over the arena columns j in order,
//   skipping zero terms (each would add +-0), and adds it to y; a row whose
//   mask row is zero keeps y as it is, so it has the no-arena bits.
// - Nothing of it depends on T or C: the functions are shared by the four
//   instantiations.  Bits depend on a row's own inputs only, as above.
//
// Limits (kernels/decode_step.py checks them before the launch): head dim
// 64 or 128, a GQA group up to 8, h, nq * d, nkv * d and each w_down chunk
// in whole 32-column tiles, at most 64 rows and a window up to 8, pool
// blocks powers of two, x fp32 or bf16 with plain weights in x's dtype;
// a LoRA arena of whole 32-column tiles, at most 1024 columns (one bit per
// tile in a 32-bit word).
#include "common.cuh"

#include <cuda.h>
#include <math.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 32;                    // GEMV output columns
constexpr int kStreams = 64;                  // contraction streams
// stored rows of a weight chunk each contraction stream of the fp32 body
// loads at once (32 bytes of fp32, 8 of int8 or packed int4 columns).  A
// constant, never a function of the row count, so a row's sums run in one
// order in every call.
template <typename T, int KIND>
constexpr int kRowsPerStream = 4;
constexpr int kMaxRB = 16;                    // rows per GEMV pass
constexpr int kMaxRows = 64;
constexpr int kMaxGroup = 8;
constexpr int kMaxWindow = 8;
constexpr float kRcp127 = 1.0f / 127.0f;      // the fp32 reciprocal
constexpr int kLoraChunk = 512;               // x . A contraction rows
constexpr int kLoraPiece = 256;               // arena columns staged at once
constexpr int kMaxLoraSr = 1024;

// shared memory, in floats: the GEMV layout and the attention layout
// overlap (a phase uses one)
constexpr int kXs = 32768;                    // staged inputs (128 KB)
constexpr int kPart = kWarps * kMaxRB * kTileN;
// the LoRA epilogue's products [kMaxRB][kLoraPiece], delta tile, live rows
// and the key of the products held
constexpr int kLoraFloats =
    kMaxRB * kLoraPiece + kMaxRB * kTileN + kMaxRB + 1;
constexpr int kGemvFloats =
    kXs + kPart + 2 * kMaxRB * kTileN + kMaxRows + kLoraFloats;

struct Args {
  const void* x;           // [rows, h] T
  void* hidden;            // [rows, h] T
  const float* c_rows;     // [rows, d] RoPE factors
  const float* s_rows;
  const void* nw1;         // [L, h] T
  const void* nw2;
  const void* w[7];        // wq wk wv wo w_gate w_up w_down: [L, K, N]
  const float* ws[7];      // int8 [L, N]; int4 [L, K / gsz, N]; or null
  const void* kc;          // cache leaves
  const void* vc;
  const float* kcs;        // int8 cache: row scales
  const float* vcs;
  const int* tables;       // paged: [S, n_tbl]
  const int* fills;        // [S]
  const int* depths;       // tree: [S, W] node depths, or null (linear)
  const int* anc;          // tree: [S, W, W] ancestor node at each depth
  void* k_rows;            // [L, rows, nkv, d]: C, or fp32 for int8
  void* v_rows;
  float* res;              // scratch, fp32
  float* q;
  float* kn;
  float* vn;
  float* ctx;
  float* gate;
  float* up;
  unsigned* bar;
  const float* la[7];      // LoRA arenas: A [L, K, lsr], B [L, lsr, N] of
  const float* lb[7];      //   each target, or null (not adapted)
  const float* lmask;      // [rows, lsr], or null (no LoRA)
  float* lpart;            // scratch: x . A partials [7, lch, rows, lsr]
  float* gpart;            // bf16: GEMV chunk partials, gcap floats
  int L, rows, W, h, nq, nkv, d, ffn, nm, aq, mq, gsz, act;
  int paged, n_ent, width, shift, n_tbl, lsr, lch;
  int gcap;
  float eps, scale;
};

// ---------------------------------------------------------------------------
// Elements
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float round_to<int8_t>(float v) { return v; }

template <typename T>
__device__ __forceinline__ float ld1(const T* p);
template <>
__device__ __forceinline__ float ld1<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld1<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void st1(T* p, float v);
template <>
__device__ __forceinline__ void st1<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void st1<__nv_bfloat16>(__nv_bfloat16* p,
                                                   float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void s8x4(unsigned x, float* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (float)((int)(x << (24 - 8 * i)) >> 24);
}

// eight consecutive fp32 values (an int4 group's column scales)
__device__ __forceinline__ void ld8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// The block's compute threads (kThreads) synchronise among themselves on
// named barrier 1: the bf16 kernel's producer warpgroup runs ahead and
// never joins them.
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kThreads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier: every block adds one to the counter and waits for all
// of this barrier's arrivals.  The counter only grows (zeroed before the
// launch); the cooperative launch keeps every block resident.  Scratch that
// another block wrote is read with __ldcg (at L2, never from this SM's L1,
// which may hold the line from before the write).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  csync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < target) __nanosleep(64);
    __threadfence();
  }
  csync();
}

// Per-phase time stamps, in a probe build only (nvcc -DDECODE_STEP_STAMPS,
// kernels/decode_probe.py), into [L][kStampPhases][kStampGrid][kStampSlots]
// u64 at g_stamps (set by decode_step_stamps; null: no stamps): for each
// layer, phase and block, %globaltimer at the phase's entry (slot 0), at
// the end of the block's work (1) and at the exit of the grid barrier after
// it (2); and for the bf16 body's GEMV phases, thread 0's nanoseconds
// waiting for boxes to land (3), staging inputs (4), in the items
// otherwise (5), in the grid barrier before the combine (6), and in the
// combine (7).  The package's build compiles none of it.
constexpr int kStampPhases = 9;  // xa_qkv qkv attn xa_wo wo xa_gu gu xa_dn dn
constexpr int kStampGrid = 1024;
constexpr int kStampSlots = 8;
// the stamp phase of GEMV phase 0-3 (q/k/v, wo, gate/up, w_down)
__device__ __forceinline__ int stamp_of(int ph) {
  return ph == 0 ? 1 : ph == 1 ? 4 : ph == 2 ? 6 : 8;
}
#ifdef DECODE_STEP_STAMPS
__device__ unsigned long long* g_stamps;
__device__ unsigned long long g_box_wait[kStampGrid];  // slot 3, running
__device__ __forceinline__ unsigned long long* stamp_at(int l, int ph,
                                                        int k) {
  return g_stamps + (((size_t)l * kStampPhases + ph) * kStampGrid
                     + blockIdx.x) * kStampSlots + k;
}
__device__ __forceinline__ void stamp(int l, int ph, int k) {
  if (threadIdx.x == 0 && g_stamps && blockIdx.x < kStampGrid)
    *stamp_at(l, ph, k) = now_ns();
}
// thread 0: add the ns since t0 to slot k (t0 = 0: read the clock only)
__device__ __forceinline__ unsigned long long stamp_add(int l, int ph, int k,
                                                        unsigned long long t0) {
  if (threadIdx.x != 0 || !g_stamps || blockIdx.x >= kStampGrid) return 0;
  const unsigned long long t = now_ns();
  if (t0) *stamp_at(l, ph, k) += t - t0;
  return t;
}
#else
__device__ __forceinline__ void stamp(int, int, int) {}
__device__ __forceinline__ unsigned long long stamp_add(int, int, int,
                                                        unsigned long long) {
  return 0;
}
#endif

__device__ __forceinline__ float act_fn(int act, float x) {
  switch (act) {
    case 0: return x / (1.0f + expf(-x));                      // silu
    case 1:                                                    // gelu tanh
      return 0.5f * x
             * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x
                                                         * x)));
    case 2: return fmaxf(x, 0.0f);                             // relu
    default: return x;                                         // linear
  }
}

// ---------------------------------------------------------------------------
// GEMV
// ---------------------------------------------------------------------------

// One layer's [K, N] weight: kind 0 plain (T), 8 int8 codes with a column
// scale s[N], 4 int4 packed two rows a byte ([K/2, N], even row in the low
// nibble) with group scales s[K / gsz, N].
struct Mat {
  const void* w;
  const float* s;
  int kind, N, gsz;
};

// Where a GEMV's staged inputs come from: mode 0 the residual RMS-normed
// (res * rstd * nw), 1 a copy, 2 act(a) * b; every value rounded to T.
struct Src {
  int mode;
  const float* a;
  const float* b;
  const void* nw;
  const float* rs;
  int ld, act;
};

// xs[r * ldx + i] = input row r0 + r at contraction index k0 + i, for r <
// rb (rows from nr on are zero) and i < cnt (a multiple of 4): four
// consecutive inputs a thread, each thread's loads issued together
template <typename T>
__device__ void stage(const Src& src, int r0, int nr, int rb, int k0,
                      int cnt, int ldx, float* xs) {
  constexpr int B = 4;
  const int per_row = cnt / 4;
  const int total = rb * per_row;
  for (int i0 = threadIdx.x; i0 < total; i0 += B * kThreads) {
    float4 av[B], bv[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      av[j] = bv[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int idx = i0 + j * kThreads;
      const int r = idx / per_row;
      if (idx < total && r < nr) {
        const size_t at = (size_t)(r0 + r) * src.ld + k0
                          + 4 * (idx - r * per_row);
        av[j] = __ldcg(reinterpret_cast<const float4*>(src.a + at));
        if (src.mode == 2)
          bv[j] = __ldcg(reinterpret_cast<const float4*>(src.b + at));
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int idx = i0 + j * kThreads;
      if (idx >= total) break;
      const int r = idx / per_row;
      const int i = 4 * (idx - r * per_row);
      const float a4[4] = {av[j].x, av[j].y, av[j].z, av[j].w};
      const float b4[4] = {bv[j].x, bv[j].y, bv[j].z, bv[j].w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (r >= nr) {
          v[e] = 0.0f;
          continue;
        }
        if (src.mode == 0)
          v[e] = __fmul_rn(__fmul_rn(a4[e], src.rs[r0 + r]),
                           ld1<T>(static_cast<const T*>(src.nw) + k0 + i + e));
        else if (src.mode == 1)
          v[e] = a4[e];
        else
          v[e] = __fmul_rn(act_fn(src.act, a4[e]), b4[e]);
        v[e] = round_to<T>(v[e]);
      }
      *reinterpret_cast<float4*>(xs + (size_t)r * ldx + i) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The stored words of 8 consecutive columns of one weight row: 16 bytes of
// bf16, 32 of fp32 (a and b), 8 of int8 codes or packed int4 pairs (a.x,
// a.y).
struct Raw {
  uint4 a, b;
};

template <typename T, int KIND>
__device__ __forceinline__ Raw load_raw(const Mat& m, size_t at) {
  Raw r;
  if constexpr (KIND == 0 && sizeof(T) == 4) {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const float*>(m.w) + at);
    r.a = p[0];
    r.b = p[1];
  } else if constexpr (KIND == 0) {
    r.a = *reinterpret_cast<const uint4*>(static_cast<const T*>(m.w) + at);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(m.w) + at);
    r.a.x = v.x;
    r.a.y = v.y;
  }
  return r;
}

// the loads of one chunk's rows [c0, min(c0 + PER, k1)) for this thread's
// stream (int4: packed rows, two stored rows a byte)
template <typename T, int KIND>
__device__ __forceinline__ void load_chunk(const Mat& m, int c0, int k1,
                                           int st, int col, Raw* w) {
  constexpr int U = kRowsPerStream<T, KIND>;
  const int cnt = min((KIND == 4 ? 2 : 1) * kStreams * U, k1 - c0);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int pp = u * kStreams + st;
    const int ii = KIND == 4 ? 2 * pp : pp;
    if (ii < cnt) {
      const size_t row = KIND == 4 ? (size_t)(c0 / 2 + pp) : (size_t)(c0 + ii);
      w[u] = load_raw<T, KIND>(m, row * m.N + col);
    }
  }
}

// the 8 columns of a loaded plain or int8 row in fp32 (exact)
template <typename T, int KIND>
__device__ __forceinline__ void widen(const Raw& r, float* o) {
  if constexpr (KIND == 8) {
    s8x4(r.a.x, o);
    s8x4(r.a.y, o + 4);
  } else if constexpr (sizeof(T) == 4) {
    o[0] = __uint_as_float(r.a.x); o[1] = __uint_as_float(r.a.y);
    o[2] = __uint_as_float(r.a.z); o[3] = __uint_as_float(r.a.w);
    o[4] = __uint_as_float(r.b.x); o[5] = __uint_as_float(r.b.y);
    o[6] = __uint_as_float(r.b.z); o[7] = __uint_as_float(r.b.w);
  } else {
    const unsigned u[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// out[r * 32 + c] = sum_i x[r0 + r][i] * W[i][n0 + c] over i in [k0, k1),
// fp32, before any int8 column scale.
// ``staged``: xs already holds rows [r0, r0 + RB) of the inputs over [k0,
// k1) (``stage_rows``); else the tile stages SUP contraction rows at a time.
template <typename T, int KIND, int RB>
__device__ __noinline__ void gemv_tile(const Mat m, const Src src, int r0,
                                       int nr, int n0, int k0, int k1,
                                       bool staged, float* smem, float* out) {
  constexpr int U = kRowsPerStream<T, KIND>;
  constexpr int PER = (KIND == 4 ? 2 : 1) * kStreams * U;
  constexpr int SUP = kXs / RB / PER * PER;
  float* xs = smem;
  float* part = smem + kXs;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, cg = lane & 3;
  const int st = warp * 8 + (lane >> 2);
  const int col = n0 + cg * 8;
  const int N = m.N;
  float acc[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;

  // The weight words of chunk c + 1 are loaded while chunk c is staged
  // and multiplied, so a thread keeps two chunks' loads in flight.
  Raw nxt[U];
  load_chunk<T, KIND>(m, k0, k1, st, col, nxt);
  const int ldx = staged ? k1 - k0 : SUP;
  int s0 = k0;                              // first row staged in xs
  for (int c0 = k0; c0 < k1; c0 += PER) {
    const int cnt = min(PER, k1 - c0);
    if (!staged && (c0 - k0) % SUP == 0) {
      s0 = c0;
      csync();
      stage<T>(src, r0, nr, RB, c0, min(SUP, k1 - c0), ldx, xs);
      csync();
    }
    Raw cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    if (c0 + PER < k1) load_chunk<T, KIND>(m, c0 + PER, k1, st, col, nxt);
    const float* xc = xs + (c0 - s0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pp = u * kStreams + st;     // stored row in the chunk
      const int ii = KIND == 4 ? 2 * pp : pp;
      if (ii >= cnt) continue;
      if constexpr (KIND != 4) {
        float wv[8];
        widen<T, KIND>(cur[u], wv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = xc[r * ldx + ii];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xv, wv[e], acc[r][e]);
        }
      } else {
        const float* sc = m.s + (size_t)((c0 + ii) / m.gsz) * N + col;
        float s8[8], lo[8], hi[8];
        ld8(sc, s8);
        const unsigned wd[2] = {cur[u].a.x, cur[u].a.y};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int p = (int)(signed char)((wd[e >> 2] >> (8 * (e & 3)))
                                           & 0xffu);
          const int nl = (int)((unsigned)p << 28) >> 28;
          const int nh = (int)((unsigned)p << 24) >> 28;
          lo[e] = round_to<T>(__fmul_rn((float)nl, s8[e]));
          hi[e] = round_to<T>(__fmul_rn((float)nh, s8[e]));
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float x0 = xc[r * ldx + ii];
          const float x1 = xc[r * ldx + ii + 1];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[r][e] = fmaf(x0, lo[e], acc[r][e]);
            acc[r][e] = fmaf(x1, hi[e], acc[r][e]);
          }
        }
      }
    }
  }
  // the eight streams of a warp (lane bits 2-4), then the warps in order
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = acc[r][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][e] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        part[(warp * RB + r) * kTileN + cg * 8 + e] = acc[r][e];
  }
  csync();
  for (int idx = tid; idx < RB * kTileN; idx += kThreads) {
    float s = part[idx];
    for (int w = 1; w < kWarps; ++w) s += part[w * RB * kTileN + idx];
    out[idx] = s;
  }
  csync();
}

// rows of one GEMV pass: nr rounded up to 1, 2, 4, 8 or 16
__device__ __forceinline__ int rb_of(int nr) {
  return nr <= 1 ? 1 : nr <= 2 ? 2 : nr <= 4 ? 4 : nr <= 8 ? 8 : 16;
}

// Stage the pass's inputs over the whole contraction [k0, k1) once, for
// every tile of the phase, when they fit; false when they do not (each
// tile then stages them in pieces).
template <typename T>
__device__ bool stage_rows(const Src& src, int r0, int nr, int k0, int k1,
                           float* smem) {
  const int rb = rb_of(nr);
  if (rb * (k1 - k0) > kXs) return false;
  csync();
  stage<T>(src, r0, nr, rb, k0, k1 - k0, k1 - k0, smem);
  csync();
  return true;
}

template <typename T, int KIND>
__device__ __forceinline__ void gemv_rb(const Mat& m, const Src& src, int r0,
                                        int nr, int n0, int k0, int k1,
                                        bool staged, float* smem,
                                        float* out) {
  switch (rb_of(nr)) {
    case 1: gemv_tile<T, KIND, 1>(m, src, r0, nr, n0, k0, k1, staged, smem,
                                  out); break;
    case 2: gemv_tile<T, KIND, 2>(m, src, r0, nr, n0, k0, k1, staged, smem,
                                  out); break;
    case 4: gemv_tile<T, KIND, 4>(m, src, r0, nr, n0, k0, k1, staged, smem,
                                  out); break;
    case 8: gemv_tile<T, KIND, 8>(m, src, r0, nr, n0, k0, k1, staged, smem,
                                  out); break;
    default: gemv_tile<T, KIND, 16>(m, src, r0, nr, n0, k0, k1, staged,
                                    smem, out);
  }
}

template <typename T>
__device__ __forceinline__ void gemv(const Mat& m, const Src& src, int r0,
                                     int nr, int n0, int k0, int k1,
                                     bool staged, float* smem, float* out) {
  if (m.kind == 8)
    gemv_rb<T, 8>(m, src, r0, nr, n0, k0, k1, staged, smem, out);
  else if (m.kind == 4)
    gemv_rb<T, 4>(m, src, r0, nr, n0, k0, k1, staged, smem, out);
  else gemv_rb<T, 0>(m, src, r0, nr, n0, k0, k1, staged, smem, out);
}

// layer l of weight `which` (0-6), [K, N]
template <typename T>
__device__ __forceinline__ Mat layer_mat(const Args& a, int which, int l,
                                         int K, int N) {
  const int kind = which < 4 ? a.aq : a.mq;
  Mat m;
  m.kind = kind;
  m.N = N;
  m.gsz = a.gsz;
  const size_t lkn = (size_t)l * K * N;
  if (kind == 0) {
    m.w = static_cast<const T*>(a.w[which]) + lkn;
    m.s = nullptr;
  } else if (kind == 8) {
    m.w = static_cast<const int8_t*>(a.w[which]) + lkn;
    m.s = a.ws[which] + (size_t)l * N;
  } else {
    m.w = static_cast<const int8_t*>(a.w[which]) + lkn / 2;
    m.s = a.ws[which] + (size_t)l * (K / a.gsz) * N;
  }
  return m;
}

// rs[r] = 1 / sqrt(mean(res[r]^2) + eps) for every row, in every block
// (the same code, so the same bits, everywhere)
__device__ void row_rstd(const float* res, int rows, int h, float eps,
                         float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 4 * lane; i < h; i += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          res + (size_t)r * h + i));
      acc = __fmaf_rn(v.x, v.x, acc);
      acc = __fmaf_rn(v.y, v.y, acc);
      acc = __fmaf_rn(v.z, v.z, acc);
      acc = __fmaf_rn(v.w, v.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) rs[r] = rsqrtf(__fadd_rn(__fdiv_rn(acc, (float)h), eps));
  }
  csync();
}

constexpr int kOut = kXs + kPart;             // GEMV result tile
constexpr int kOut2 = kOut + kMaxRB * kTileN;
constexpr int kRs = kOut2 + kMaxRB * kTileN;
constexpr int kLs = kRs + kMaxRows;           // the LoRA epilogue's floats

// ---------------------------------------------------------------------------
// The LoRA epilogue (nothing here depends on T or C)
// ---------------------------------------------------------------------------

// Where an x . A pass reads its fp32 inputs, never rounded: mode 0 the
// residual RMS-normed (res * rstd * nw, nw bf16 when nwb), 1 a copy, 2
// act(a) * b.  The same products as ``stage`` before its rounding.
struct LSrc {
  int mode;
  const float* a;
  const float* b;
  const void* nw;
  int nwb;
  const float* rs;
  int ld, act;
};

// 32-bit word of the arena's 32-column tiles that some row's mask selects
// (every block computes the same word)
// (``red``: kWarps scratch words; ``ls``: the epilogue's floats, whose
// products key is cleared)
__device__ __noinline__ unsigned lora_tiles(const Args& a, float* red_f,
                                            float* ls) {
  if (threadIdx.x == 0)  // no products held yet
    reinterpret_cast<int*>(ls)[kMaxRB * kLoraPiece + kMaxRB * kTileN
                               + kMaxRB] = -1;
  unsigned used = 0;
  for (int i = threadIdx.x; i < a.rows * a.lsr; i += kThreads)
    if (a.lmask[i] != 0.0f) used |= 1u << ((i % a.lsr) >> 5);
  used = __reduce_or_sync(0xffffffffu, used);
  unsigned* red = reinterpret_cast<unsigned*>(red_f);
  csync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = used;
  csync();
  used = 0;
  for (int w = 0; w < kWarps; ++w) used |= red[w];
  csync();
  return used;
}

// xs[r * kLoraChunk + i] = fp32 input row r0 + r at index k0 + i, for r <
// kMaxRB (rows from nr on zero) and i < cnt (a multiple of 4)
__device__ __noinline__ void lora_stage(const LSrc& src, int r0, int nr,
                                        int k0, int cnt, float* xs) {
  const int per_row = cnt / 4;
  for (int idx = threadIdx.x; idx < kMaxRB * per_row; idx += kThreads) {
    const int r = idx / per_row, i = 4 * (idx - r * per_row);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < nr) {
      const size_t at = (size_t)(r0 + r) * src.ld + k0 + i;
      const float4 av = __ldcg(reinterpret_cast<const float4*>(src.a + at));
      float4 bv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (src.mode == 2)
        bv = __ldcg(reinterpret_cast<const float4*>(src.b + at));
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (src.mode == 0) {
          const size_t wi = (size_t)k0 + i + e;
          const float nw =
              src.nwb ? __bfloat162float(
                            static_cast<const __nv_bfloat16*>(src.nw)[wi])
                      : static_cast<const float*>(src.nw)[wi];
          v[e] = __fmul_rn(__fmul_rn(a4[e], src.rs[r0 + r]), nw);
        } else if (src.mode == 1) {
          v[e] = a4[e];
        } else {
          v[e] = __fmul_rn(act_fn(src.act, a4[e]), b4[e]);
        }
      }
    }
    *reinterpret_cast<float4*>(xs + (size_t)r * kLoraChunk + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// One x . A item: contraction rows [k0, k0 + cnt) of the layer's A [in,
// lsr] and arena columns [c0, c0 + 32), for every row of the call, into
// part [rows, lsr].  A thread owns 4 columns of one of 32 streams, which
// sums rows k0 + st, k0 + st + 32, ... in order; the warp's 4 streams add
// by shuffles, then the 8 warps in order.
__device__ __noinline__ void lora_xa_item(const Args& a, const LSrc& src,
                                          const float* A, int k0, int cnt,
                                          int c0, float* part, float* smem) {
  constexpr int PER = kLoraChunk / 32;
  float* xs = smem;                             // [kMaxRB][kLoraChunk]
  float* red = smem + kMaxRB * kLoraChunk;      // [kWarps][kMaxRB][32]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = lane & 7, st = tid >> 3;
  const int lsr = a.lsr;
  for (int r0 = 0; r0 < a.rows; r0 += kMaxRB) {
    const int nr = min(kMaxRB, a.rows - r0);
    float4 av[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = st + 32 * i;
      av[i] = k < cnt ? __ldg(reinterpret_cast<const float4*>(
                            A + (size_t)(k0 + k) * lsr + c0 + 4 * cg))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    csync();
    lora_stage(src, r0, nr, k0, cnt, xs);
    csync();
    float acc[kMaxRB][4];
#pragma unroll
    for (int r = 0; r < kMaxRB; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = st + 32 * i;
      if (k < cnt) {
        const float w4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int r = 0; r < kMaxRB; ++r) {
          const float xv = xs[r * kLoraChunk + k];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(xv, w4[e], acc[r][e]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRB; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[r][e];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][e] = v;
      }
    if (lane < 8) {
#pragma unroll
      for (int r = 0; r < kMaxRB; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * kMaxRB + r) * kTileN + 4 * cg + e] = acc[r][e];
    }
    csync();
    for (int idx = tid; idx < nr * kTileN; idx += kThreads) {
      const int r = idx >> 5, c = idx & 31;
      float sum = red[r * kTileN + c];
      for (int w = 1; w < kWarps; ++w) sum += red[(w * kMaxRB + r) * kTileN + c];
      part[(size_t)(r0 + r) * lsr + c0 + c] = sum;
    }
  }
  csync();
}

// The x . A phase of targets [t0, t1), which share the contraction ``in``
// and the inputs ``src``: items (target, chunk, 32-column tile) over the
// grid, a tile no row selects skipped.
__device__ void lora_xa_phase(const Args& a, int l, int t0, int t1, int in,
                              const LSrc& src, unsigned used, float* smem) {
  const int ntile = a.lsr / kTileN;
  const int nch = (in + kLoraChunk - 1) / kLoraChunk;
  const int per_t = nch * ntile;
  for (int it = blockIdx.x; it < (t1 - t0) * per_t; it += gridDim.x) {
    const int t = t0 + it / per_t, rem = it % per_t;
    const int ch = rem / ntile, tile = rem % ntile;
    if (!a.la[t] || !((used >> tile) & 1u)) continue;
    const int k0 = ch * kLoraChunk;
    lora_xa_item(a, src, a.la[t] + (size_t)l * in * a.lsr, k0,
                 min(kLoraChunk, in - k0), tile * kTileN,
                 a.lpart + ((size_t)t * a.lch + ch) * a.rows * a.lsr, smem);
  }
}

// The B product of target t for rows [r0, r0 + nr) and output columns [n,
// n + 32): dl[r * 32 + c] = sum over arena columns j in order of
// (x . A)[j] * mask[j] * B[j][n + c], zero terms skipped; live[r] = 1 when
// row r0 + r's mask row is not all zero.  (x . A)[j] adds the chunks'
// partials in chunk order (their loads issued 8 at a time).  ``ls`` holds
// the pass's products (x . A) * mask, dl, live and the products' key: a
// block's next tile of the same layer, target and rows reuses them when
// the arena fits one piece.
__device__ __noinline__ void lora_delta(const Args& a, int t, int l, int in,
                                        int N, int r0, int nr, int n,
                                        float* ls) {
  float* xm = ls;                               // [kMaxRB][kLoraPiece]
  float* dl = xm + kMaxRB * kLoraPiece;         // [kMaxRB][32]
  int* live = reinterpret_cast<int*>(dl + kMaxRB * kTileN);
  int* key = live + kMaxRB;
  const float* B = a.lb[t] + (size_t)l * a.lsr * N;
  const int nch = (in + kLoraChunk - 1) / kLoraChunk;
  const size_t cstride = (size_t)a.rows * a.lsr;
  const float* part = a.lpart + (size_t)t * a.lch * cstride;
  const int tid = threadIdx.x, c = tid & 31, rr = tid >> 5;
  const bool one_piece = a.lsr <= kLoraPiece;
  const int want = (l * 8 + t) * kMaxRows + r0;
  csync();
  const bool held = one_piece && *key == want;
  csync();                              // key read before rewritten
  if (!held && tid < kMaxRB) live[tid] = 0;
  float acc[2] = {0.0f, 0.0f};
  for (int p0 = 0; p0 < a.lsr; p0 += kLoraPiece) {
    const int pw = min(kLoraPiece, a.lsr - p0);
    if (!held) {
      csync();
      for (int idx = tid; idx < kMaxRB * pw; idx += kThreads) {
        const int r = idx / pw, j = idx - r * pw;
        float v = 0.0f;
        if (r < nr) {
          const size_t at = (size_t)(r0 + r) * a.lsr + p0 + j;
          const float m = a.lmask[at];
          if (m != 0.0f) {
            float sum = 0.0f;
            for (int c0 = 0; c0 < nch; c0 += 8) {
              float pv[8];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                pv[e] = c0 + e < nch
                            ? __ldcg(part + (size_t)(c0 + e) * cstride + at)
                            : 0.0f;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (c0 + e < nch) sum = c0 + e ? __fadd_rn(sum, pv[e]) : pv[e];
            }
            v = __fmul_rn(sum, m);
            live[r] = 1;
          }
        }
        xm[r * kLoraPiece + j] = v;
      }
      csync();
      if (tid == 0) *key = one_piece ? want : -1;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = rr + 8 * q;
      if (r >= nr) continue;                    // the same for the warp
      const float* xr = xm + r * kLoraPiece;
      for (int j0 = 0; j0 < pw; j0 += 32) {
        float xv[32];
        bool any = false;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          xv[e] = xr[j0 + e];
          any |= xv[e] != 0.0f;
        }
        if (!any) continue;                     // the same for the warp
        float bv[32];
#pragma unroll
        for (int e = 0; e < 32; ++e)
          bv[e] = __ldg(B + (size_t)(p0 + j0 + e) * N + n + c);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (xv[e] != 0.0f) acc[q] = fmaf(xv[e], bv[e], acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (rr + 8 * q < nr) dl[(rr + 8 * q) * kTileN + c] = acc[q];
  csync();
}

// the epilogue's delta for output tile [n, n + 32) of target t, or null
// (no arena for t, or no LoRA in this launch), in the epilogue's floats
// ``ls``; then y + dl[idx] for a live row (lora_add's site)
__device__ __forceinline__ const float* lora_tile(const Args& a, bool on,
                                                  int t, int l, int in, int N,
                                                  int r0, int nr, int n,
                                                  float* ls) {
  if (!on || !a.la[t]) return nullptr;
  lora_delta(a, t, l, in, N, r0, nr, n, ls);
  return ls + kMaxRB * kLoraPiece;
}

__device__ __forceinline__ float lora_add(const float* dl, int idx, float y) {
  if (!dl) return y;
  const int* live = reinterpret_cast<const int*>(dl + kMaxRB * kTileN);
  return live[idx >> 5] ? __fadd_rn(y, dl[idx]) : y;
}

// norm + q/k/v + scale epilogue (+ the LoRA delta) + RoPE
template <typename T>
__device__ void phase_qkv(const Args& a, int l, bool lora, float* smem) {
  float* out = smem + kOut;
  float* out2 = smem + kOut2;
  float* rs = smem + kRs;
  const int h = a.h, d = a.d, nqd = a.nq * a.d, nkvd = a.nkv * a.d;
  row_rstd(a.res, a.rows, h, a.eps, rs);
  const Src src{0, a.res, nullptr,
                static_cast<const T*>(a.nw1) + (size_t)l * h, rs, h, 0};
  const int tiles = (nqd + 2 * nkvd) / kTileN;
  if ((int)blockIdx.x >= tiles) return;
  for (int r0 = 0; r0 < a.rows; r0 += kMaxRB) {
    const int nr = min(kMaxRB, a.rows - r0);
    const bool staged = stage_rows<T>(src, r0, nr, 0, h, smem);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int n = t * kTileN, which, N;
      if (n < nqd) { which = 0; N = nqd; }
      else if (n < nqd + nkvd) { which = 1; n -= nqd; N = nkvd; }
      else { which = 2; n -= nqd + nkvd; N = nkvd; }
      const Mat m = layer_mat<T>(a, which, l, h, N);
      float* dst = which == 0 ? a.q : which == 1 ? a.kn : a.vn;
      gemv<T>(m, src, r0, nr, n, 0, h, staged, smem, out);
      const float* dl = lora_tile(a, lora, which, l, h, N, r0, nr, n,
                                      smem + kLs);
      for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
        float y = out[idx];
        if (m.kind == 8) y = __fmul_rn(y, m.s[n + (idx & 31)]);
        out2[idx] = lora_add(dl, idx, y);
      }
      csync();
      for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
        const int r = r0 + (idx >> 5), c = n + (idx & 31);
        float y = out2[idx];
        if (which != 2) {            // y * C + swap(y) * S
          const int dc = c % d;
          y = __fadd_rn(__fmul_rn(y, a.c_rows[(size_t)r * d + dc]),
                        __fmul_rn(out2[idx ^ 1], a.s_rows[(size_t)r * d + dc]));
        }
        dst[(size_t)r * N + c] = y;
      }
      csync();
    }
  }
}

// y (the pass's rows x 32 columns of a GEMV, in ``out``) times an int8
// column scale, plus the LoRA delta ``dl`` (or none), added to the residual
__device__ __forceinline__ void add_to_residual(const Args& a, const Mat& m,
                                                int r0, int nr, int n,
                                                const float* out,
                                                const float* dl) {
  for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
    const int c = n + (idx & 31);
    float y = out[idx];
    if (m.kind == 8) y = __fmul_rn(y, m.s[c]);
    y = lora_add(dl, idx, y);
    float* rp = a.res + (size_t)(r0 + (idx >> 5)) * a.h + c;
    *rp = __fadd_rn(__ldcg(rp), y);
  }
  csync();
}

// wo (+ the LoRA delta) and the residual
template <typename T>
__device__ void phase_wo(const Args& a, int l, bool lora, float* smem) {
  float* out = smem + kOut;
  const int h = a.h, nqd = a.nq * a.d;
  const Src src{1, a.ctx, nullptr, nullptr, nullptr, nqd, 0};
  const Mat m = layer_mat<T>(a, 3, l, nqd, h);
  if ((int)blockIdx.x >= h / kTileN) return;
  for (int r0 = 0; r0 < a.rows; r0 += kMaxRB) {
    const int nr = min(kMaxRB, a.rows - r0);
    const bool staged = stage_rows<T>(src, r0, nr, 0, nqd, smem);
    for (int t = blockIdx.x; t < h / kTileN; t += gridDim.x) {
      gemv<T>(m, src, r0, nr, t * kTileN, 0, nqd, staged, smem, out);
      add_to_residual(a, m, r0, nr, t * kTileN, out,
                      lora_tile(a, lora, 3, l, nqd, h, r0, nr, t * kTileN,
                                smem + kLs));
    }
  }
}

// norm + gate/up (+ the LoRA deltas)
template <typename T>
__device__ void phase_gateup(const Args& a, int l, bool lora, float* smem) {
  float* out = smem + kOut;
  float* rs = smem + kRs;
  const int h = a.h, ffn = a.ffn;
  row_rstd(a.res, a.rows, h, a.eps, rs);
  const Src src{0, a.res, nullptr,
                static_cast<const T*>(a.nw2) + (size_t)l * h, rs, h, 0};
  if ((int)blockIdx.x >= 2 * ffn / kTileN) return;
  for (int r0 = 0; r0 < a.rows; r0 += kMaxRB) {
    const int nr = min(kMaxRB, a.rows - r0);
    const bool staged = stage_rows<T>(src, r0, nr, 0, h, smem);
    for (int t = blockIdx.x; t < 2 * ffn / kTileN; t += gridDim.x) {
      int n = t * kTileN;
      const int which = n < ffn ? 4 : 5;
      if (which == 5) n -= ffn;
      const Mat m = layer_mat<T>(a, which, l, h, ffn);
      float* dst = which == 4 ? a.gate : a.up;
      gemv<T>(m, src, r0, nr, n, 0, h, staged, smem, out);
      const float* dl = lora_tile(a, lora, which, l, h, ffn, r0, nr, n,
                                      smem + kLs);
      for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
        const int c = n + (idx & 31);
        float y = out[idx];
        if (m.kind == 8) y = __fmul_rn(y, m.s[c]);
        dst[(size_t)(r0 + (idx >> 5)) * ffn + c] = lora_add(dl, idx, y);
      }
      csync();
    }
  }
}

// act(gate) * up, w_down in nm chunks, each added to the residual in turn,
// then the LoRA delta of w_down (over the whole ffn contraction) once
template <typename T>
__device__ void phase_down(const Args& a, int l, bool lora, float* smem) {
  float* out = smem + kOut;
  const int h = a.h, ffn = a.ffn, fc = a.ffn / a.nm;
  const Src src{2, a.gate, a.up, nullptr, nullptr, ffn, a.act};
  const Mat m = layer_mat<T>(a, 6, l, ffn, h);
  if ((int)blockIdx.x >= h / kTileN) return;
  for (int r0 = 0; r0 < a.rows; r0 += kMaxRB) {
    const int nr = min(kMaxRB, a.rows - r0);
    for (int k = 0; k < a.nm; ++k) {
      const bool staged = stage_rows<T>(src, r0, nr, k * fc, (k + 1) * fc,
                                        smem);
      for (int t = blockIdx.x; t < h / kTileN; t += gridDim.x) {
        gemv<T>(m, src, r0, nr, t * kTileN, k * fc, (k + 1) * fc, staged,
                smem, out);
        add_to_residual(a, m, r0, nr, t * kTileN, out, nullptr);
      }
    }
    if (!lora || !a.la[6]) continue;
    // the same block owns tile t in every chunk, so its chunks are in
    for (int t = blockIdx.x; t < h / kTileN; t += gridDim.x) {
      const float* dl = lora_tile(a, lora, 6, l, ffn, h, r0, nr, t * kTileN,
                                  smem + kLs);
      for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
        float* rp = a.res + (size_t)(r0 + (idx >> 5)) * h + t * kTileN
                    + (idx & 31);
        *rp = lora_add(dl, idx, __ldcg(rp));
      }
      csync();
    }
  }
}

// ---------------------------------------------------------------------------
// Attention
// ---------------------------------------------------------------------------

// dst = fake_quantize_rows(src) over one row of D values (block-wide;
// dst may be src)
__device__ void fq_row(const float* src, float* dst, int D, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m = 0.0f;
  for (int e = threadIdx.x; e < D; e += kThreads) m = fmaxf(m, fabsf(src[e]));
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  csync();
  float amax = red[0];
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  float sc = __fmul_rn(amax, kRcp127);
  if (sc == 0.0f) sc = 1.0f;
  csync();
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float q = rintf(__fdiv_rn(src[e], sc));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    dst[e] = __fmul_rn(q, sc);
  }
  csync();
}

// element index (times D for the d axis) of logical column col of slot s,
// head hk, layer l
__device__ __forceinline__ size_t cache_row(const Args& a, int l, int s,
                                            int hk, int col) {
  if (a.paged) {
    const size_t blk = (size_t)a.tables[(size_t)s * a.n_tbl + (col >> a.shift)];
    return ((((size_t)l * a.n_ent + blk) * a.nkv + hk) << a.shift)
           + (size_t)(col & (a.width - 1));
  }
  return (((size_t)l * a.n_ent + s) * a.nkv + hk) * a.width + col;
}

// Words of the cache: one 16-byte load is VN elements of C, widened to fp32
// (bf16 and int8 exactly; an int8 cache's row scale multiplies after).
template <typename C>
struct Word;
template <>
struct Word<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    o[0] = __uint_as_float(w.x); o[1] = __uint_as_float(w.y);
    o[2] = __uint_as_float(w.z); o[3] = __uint_as_float(w.w);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <>
struct Word<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void to_float(const uint4& w, float* o) {
    s8x4(w.x, o); s8x4(w.y, o + 4); s8x4(w.z, o + 8); s8x4(w.w, o + 12);
  }
};

// shared memory of the attention phase, in floats
template <int D>
struct AttnSmem {
  static constexpr int kSplice = (kMaxWindow - 1) * D;
  static constexpr int kGroups = kThreads / (D / 16);   // most lane groups
  static constexpr int kFloats = 2 * kSplice + 2 * D + kWarps + 2 * kGroups
                                 + kGroups * D + kMaxGroup;
};

// One (row r, kv head hk) of the attention phase, the whole block.  Laid out
// as csrc/flash_decode.cu's decode body: LANES threads own one cache row at
// a time, 16 bytes each; each of the NGRP lane groups keeps U rows in flight
// and its own online softmax over the G query heads of the kv head; the
// groups' states merge in a fixed order.  Logical column j is the cache's
// for j < fill, the spliced row i = j - fill for fill <= j < fill + w, and
// the row's own K/V fold in last.  In a linear window w is the row's window
// position and spliced row i the slot's window row i; in a tree (a.depths
// set) w is the row's depth and spliced row i its ancestor at depth i.
// Which group takes which column depends on j alone, so a row gives the same
// bits whatever the call's rows or grid.  Scores at columns past the length
// are -inf and skipped; a group that saw none keeps m = -inf, l = 0, acc =
// 0, and the fold of the own token (a finite score) starts from there: a
// fill-0 row attends its own token only, and no 0 x inf arises.
template <typename C, int D, int G>
__device__ void attn_item(const Args& a, int l, int r, int hk, float* smem) {
  constexpr bool Q8 = sizeof(C) == 1;
  constexpr int VN = Word<C>::N;
  constexpr int LANES = D / VN;
  constexpr int NGRP = kThreads / LANES;
  constexpr int U = Q8 ? ((G >= 8) ? 1 : (G >= 4) ? 2 : 4)
                       : ((G >= 8) ? 2 : 4);
  static_assert(LANES <= 32 && 32 % LANES == 0, "a row within a warp");
  using S = AttnSmem<D>;
  float* spk = smem;                      // spliced window rows
  float* spv = spk + S::kSplice;
  float* ownk = spv + S::kSplice;         // the row's own K and V
  float* ownv = ownk + D;
  float* red = ownv + D;
  float* sm_m = red + kWarps;
  float* sm_l = sm_m + S::kGroups;
  float* sm_acc = sm_l + S::kGroups;
  float* s_new = sm_acc + S::kGroups * D;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int lane = tid % LANES, grp = tid / LANES;
  const int g = a.nq / a.nkv;
  const int s = r / a.W, j = r - s * a.W;
  const int depth = a.depths ? a.depths[r] : j;
  const int fill = a.fills[s], len = fill + depth;
  const int nqd = a.nq * D, nkvd = a.nkv * D;
  const C* kc = static_cast<const C*>(a.kc);
  const C* vc = static_cast<const C*>(a.vc);

  // the row's own K/V: folded raw (fake-quantized for an int8 cache), and
  // returned as the cache's new rows
  const float* kraw = a.kn + (size_t)r * nkvd + hk * D;
  const float* vraw = a.vn + (size_t)r * nkvd + hk * D;
  const size_t orow = ((size_t)l * a.rows + r) * nkvd + hk * D;
  for (int e = tid; e < D; e += kThreads) {
    ownk[e] = __ldcg(kraw + e);
    ownv[e] = __ldcg(vraw + e);
  }
  // the row's root path (earlier window rows, or its tree ancestors) as a
  // pool round trip returns them: cast through the cache's dtype, or
  // fake-quantized twice for an int8 pool
  for (int i = 0; i < depth; ++i) {
    const int src = a.depths ? a.anc[(size_t)r * a.W + i] : i;
    const size_t at = (size_t)(s * a.W + src) * nkvd + hk * D;
    for (int e = tid; e < D; e += kThreads) {
      spk[i * D + e] = round_to<C>(__ldcg(a.kn + at + e));
      spv[i * D + e] = round_to<C>(__ldcg(a.vn + at + e));
    }
  }
  csync();
  if constexpr (Q8) {
    fq_row(ownk, ownk, D, red);
    fq_row(ownv, ownv, D, red);
    for (int i = 0; i < depth; ++i) {
      for (int pass = 0; pass < 2; ++pass) {
        fq_row(spk + i * D, spk + i * D, D, red);
        fq_row(spv + i * D, spv + i * D, D, red);
      }
    }
  }
  // the row's own K/V (raw, or fake-quantized for an int8 cache) are the
  // cache's new rows
  for (int e = tid; e < D; e += kThreads) {
    if constexpr (Q8) {
      static_cast<float*>(a.k_rows)[orow + e] = ownk[e];
      static_cast<float*>(a.v_rows)[orow + e] = ownv[e];
    } else {
      st1<C>(static_cast<C*>(a.k_rows) + orow + e, ownk[e]);
      st1<C>(static_cast<C*>(a.v_rows) + orow + e, ownv[e]);
    }
  }
  csync();

  // this lane's columns of the group's query heads (RoPE already applied)
  float qf[G][VN];
#pragma unroll
  for (int rr = 0; rr < G; ++rr) {
    const float* qr = a.q + (size_t)r * nqd + (hk * g + rr) * D + lane * VN;
#pragma unroll
    for (int e = 0; e < VN; ++e) qf[rr][e] = rr < g ? __ldcg(qr + e) : 0.0f;
  }
  float m[G], lsum[G], acc[G][VN];
#pragma unroll
  for (int rr = 0; rr < G; ++rr) {
    m[rr] = -INFINITY;
    lsum[rr] = 0.0f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[rr][e] = 0.0f;
  }

  // every thread runs the same trip count (len is per block), so the
  // shuffles below always see the whole warp
  for (int it = 0; it < len; it += NGRP * U) {
    const int base = it + grp * U;
    uint4 kw[U], vw[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {   // issue every cache load of the step
      ksc[u] = vsc[u] = 1.0f;
      kw[u] = vw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (base + u < fill) {
        const size_t row = cache_row(a, l, s, hk, base + u);
        kw[u] = *reinterpret_cast<const uint4*>(kc + row * D + lane * VN);
        vw[u] = *reinterpret_cast<const uint4*>(vc + row * D + lane * VN);
        if constexpr (Q8) {
          ksc[u] = a.kcs[row];
          vsc[u] = a.vcs[row];
        }
      }
    }
    float kf[U][VN], vf[U][VN];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = base + u;
      if (col < fill) {
        Word<C>::to_float(kw[u], kf[u]);
        Word<C>::to_float(vw[u], vf[u]);
        if constexpr (Q8) {
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            kf[u][e] = __fmul_rn(kf[u][e], ksc[u]);
            vf[u][e] = __fmul_rn(vf[u][e], vsc[u]);
          }
        }
      } else {
        const int i = col - fill;
        const bool live = col < len;
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          kf[u][e] = live ? spk[i * D + lane * VN + e] : 0.0f;
          vf[u][e] = live ? spv[i * D + lane * VN + e] : 0.0f;
        }
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int rr = 0; rr < G; ++rr) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < VN; ++e) part = fmaf(qf[rr][e], kf[u][e], part);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[u][rr] = base + u < len ? __fmul_rn(part, a.scale) : -INFINITY;
      }
    }
#pragma unroll
    for (int rr = 0; rr < G; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][rr]);
      if (mx == -INFINITY) continue;            // nothing live in the group
      const float alpha = expf(m[rr] - mx);     // exp(-inf) = 0 at first
      float p[U], psum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = expf(sc[u][rr] - mx);
        psum += p[u];
      }
      lsum[rr] = __fadd_rn(__fmul_rn(lsum[rr], alpha), psum);
      m[rr] = mx;
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        float v = __fmul_rn(acc[rr][e], alpha);
#pragma unroll
        for (int u = 0; u < U; ++u) v = fmaf(p[u], vf[u][e], v);
        acc[rr][e] = v;
      }
    }
  }

  // the own token's score of each query head (warp rr)
  if (warp < g) {
    const float* qr = a.q + (size_t)r * nqd + (hk * g + warp) * D;
    float part = 0.0f;
    for (int e = wl; e < D; e += 32)
      part = fmaf(__ldcg(qr + e), ownk[e], part);
    part = warp_sum(part);
    if (wl == 0) s_new[warp] = __fmul_rn(part, a.scale);
  }
  // merge the groups in order, fold the own token, normalize
#pragma unroll
  for (int rr = 0; rr < G; ++rr) {
    if (rr >= g) break;
    if (lane == 0) {
      sm_m[grp] = m[rr];
      sm_l[grp] = lsum[rr];
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) sm_acc[grp * D + lane * VN + e] = acc[rr][e];
    csync();
    for (int e = tid; e < D; e += kThreads) {
      float mt = -INFINITY;
      for (int g2 = 0; g2 < NGRP; ++g2) mt = fmaxf(mt, sm_m[g2]);
      float lt = 0.0f, o = 0.0f;
      if (mt != -INFINITY) {
        for (int g2 = 0; g2 < NGRP; ++g2) {
          if (sm_m[g2] == -INFINITY) continue;
          const float w = expf(sm_m[g2] - mt);
          lt = fmaf(sm_l[g2], w, lt);
          o = fmaf(sm_acc[g2 * D + e], w, o);
        }
      }
      const float sn = s_new[rr];
      const float mf = fmaxf(mt, sn);
      const float alpha = expf(mt - mf);        // 0 when no column lived
      const float pn = expf(sn - mf);
      const float lf = __fadd_rn(__fmul_rn(lt, alpha), pn);
      const float v = __fadd_rn(__fmul_rn(o, alpha), __fmul_rn(pn, ownv[e]));
      a.ctx[(size_t)r * nqd + (hk * g + rr) * D + e] = __fdiv_rn(v, lf);
    }
    csync();
  }
}

// ---------------------------------------------------------------------------
// The bf16 weight stream: TMA boxes into a shared-memory ring, a producer
// warpgroup, split contraction chunks combined in a fixed order
// ---------------------------------------------------------------------------

constexpr int kStages = 3;                    // ring stages
constexpr int kStageRows = 16;                // stored rows a stage
constexpr int kRowBytes = 1024;               // a tile's stored row
constexpr int kStageBytes = kStageRows * kRowBytes;
constexpr int kBoxCols = 256;                 // a box: 16 rows x 256 elements
constexpr int kStagesPerItem = 8;             // an item: 128 stored rows
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kBarBytes = 256;                // full[kStages], empty[kStages]
constexpr int kXsT = 16384;                   // staged inputs, fp32 (64 KB)
constexpr int cmax(int x, int y) { return x > y ? x : y; }
// the compute warps' floats: the staged inputs, overlapping the attention
// and x . A layouts (a phase uses one), then the epilogue's tile, rstd and
// the LoRA epilogue's floats
constexpr int kUnionT =
    cmax(kXsT, cmax(kMaxRB * kLoraChunk + kWarps * kMaxRB * kTileN,
                    cmax(AttnSmem<64>::kFloats, AttnSmem<128>::kFloats)));
constexpr int kOutT = kUnionT;
constexpr int kRsT = kOutT + kMaxRB * kTileN;
constexpr int kLsT = kRsT + kMaxRows;
constexpr int kTmaSmemBytes = kRingBytes + kBarBytes + 4 * (kLsT + kLoraFloats);
static_assert(kTmaSmemBytes <= 232448, "one block a SM: 227 KB");
static_assert(2 * kStages * 8 <= kBarBytes, "the ring's barriers");
static_assert(kMaxRB * 2 * kStagesPerItem * kStageRows <= kXsT,
              "an item's inputs (int4: two rows a stored row) fit");

// one tensor map a weight: [L, K, N] (packed int4: [L, K / 2, N]), boxes of
// kStageRows stored rows x kBoxCols elements
struct Maps {
  CUtensorMap w[7];
};

// box (c0 columns, c1 stored rows, c2 layer) of `map` into shared `dst`,
// completing its bytes on barrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// One GEMV phase's work (the same arithmetic in the producer, the compute
// warps, the launcher's scratch check and decode_step.py's gemv_plan).
// Phase 0 q/k/v, 1 wo, 2 gate/up, 3 w_down (nm contraction segments, each
// added to the residual in turn).  Each matrix is cut into tiles of `cols`
// output columns, 1 KB of a stored row (512 bf16, 1024 int8 / int4; the
// last tile ragged, its columns past N zero-filled by the TMA); the
// contraction of each segment into chunks of 128 stored rows (`ci` rows:
// 128, int4 256; the last of a segment may be short).  An item is (tile,
// chunk), numbered tile-major; block b of a grid of G takes items b, b + G,
// b + 2 G, ...  Nothing but the assignment depends on G.
struct Geo {
  int kind, cols, rps, K, kseg, ci, cps, nch, nmat, ntiles, items;
  int which[3], N[3], t0[4];
};

__host__ __device__ inline Geo geo(const Args& a, int ph) {
  Geo g;
  const int nqd = a.nq * a.d, nkvd = a.nkv * a.d;
  int nseg = 1;
  if (ph == 0) {
    g.kind = a.aq; g.K = a.h; g.nmat = 3;
    g.which[0] = 0; g.N[0] = nqd;
    g.which[1] = 1; g.N[1] = nkvd;
    g.which[2] = 2; g.N[2] = nkvd;
  } else if (ph == 1) {
    g.kind = a.aq; g.K = nqd; g.nmat = 1;
    g.which[0] = 3; g.N[0] = a.h;
  } else if (ph == 2) {
    g.kind = a.mq; g.K = a.h; g.nmat = 2;
    g.which[0] = 4; g.N[0] = a.ffn;
    g.which[1] = 5; g.N[1] = a.ffn;
  } else {
    g.kind = a.mq; g.K = a.ffn; g.nmat = 1;
    g.which[0] = 6; g.N[0] = a.h;
    nseg = a.nm;
  }
  g.cols = g.kind ? kRowBytes : kRowBytes / 2;
  g.rps = g.kind == 4 ? 2 * kStageRows : kStageRows;   // logical rows
  g.ci = kStagesPerItem * g.rps;
  g.kseg = g.K / nseg;
  g.cps = (g.kseg + g.ci - 1) / g.ci;
  g.nch = nseg * g.cps;
  g.t0[0] = 0;
  for (int m = 0; m < g.nmat; ++m)
    g.t0[m + 1] = g.t0[m] + (g.N[m] + g.cols - 1) / g.cols;
  g.ntiles = g.t0[g.nmat];
  g.items = g.ntiles * g.nch;
  return g;
}

// item `it` of a phase: tile t (matrix m: weight `which`, N columns;
// columns [n0, n0 + cols)), chunk c, contraction rows [k0, k1)
struct Item {
  int t, c, m, which, N, n0, k0, k1;
};

__device__ __forceinline__ Item item_of(const Geo& g, int it) {
  Item i;
  i.t = it / g.nch;
  i.c = it - i.t * g.nch;
  const int seg = i.c / g.cps, cc = i.c - seg * g.cps;
  i.k0 = seg * g.kseg + cc * g.ci;
  i.k1 = min(i.k0 + g.ci, (seg + 1) * g.kseg);
  i.m = 0;
  while (i.m + 1 < g.nmat && i.t >= g.t0[i.m + 1]) ++i.m;
  i.which = g.which[i.m];
  i.N = g.N[i.m];
  i.n0 = (i.t - g.t0[i.m]) * g.cols;
  return i;
}

// The producer warpgroup's one thread: every box of every item this block
// will take, in the order the compute warps take them, across the phases, the
// passes of 16 rows and the layers.  A stage is kRowBytes / (kBoxCols x
// element) boxes side by side.  It waits only for a free stage, so it runs
// ahead through the attention and LoRA phases and the grid barriers, none
// of which reads a weight.
__device__ void produce(const Args& a, const Maps& mp, uint32_t ring,
                        uint32_t bars) {
  // (the stage loop keeps what it reads in scalars: the barriers' asm
  // clobbers memory, and a struct indexed at run time lives there)
  int stage = 0;
  uint32_t ph = 0;
  const int L = a.L, rows = a.rows, G = gridDim.x;
  for (int l = 0; l < L; ++l)
    for (int p = 0; p < 4; ++p) {
      const Geo g = geo(a, p);
      const int kind = g.kind, items = g.items, rps = g.rps;
      const int nb = kind ? kRowBytes / kBoxCols : kRowBytes / 2 / kBoxCols;
      const int box_bytes = kStageBytes / nb;
      for (int r0 = 0; r0 < rows; r0 += kMaxRB)
        for (int it = blockIdx.x; it < items; it += G) {
          const Item i = item_of(g, it);
          const CUtensorMap* map = &mp.w[i.which];
          const int n0 = i.n0, k1 = i.k1;
          for (int s0 = i.k0; s0 < k1; s0 += rps) {
            const uint32_t full = bars + 8 * stage;
            mbar_wait(bars + 8 * (kStages + stage), ph ^ 1);
            mbar_expect_tx(full, kStageBytes);
            for (int b = 0; b < nb; ++b)
              tma_load(ring + stage * kStageBytes + b * box_bytes, map,
                       n0 + b * kBoxCols, kind == 4 ? s0 / 2 : s0, l, full);
            if (++stage == kStages) {
              stage = 0;
              ph ^= 1;
            }
          }
        }
    }
}

// the compute warps' view of the ring: the next stage and its phase
struct Ring {
  uint32_t bars;
  int stage;
  uint32_t ph;
  const unsigned char* base;
};

__device__ __forceinline__ float f4at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One item's products on the CUDA cores (inlined, so that the ring and the
// staged inputs are read as shared memory): each stage, as it lands, against
// the staged inputs xs (rows at stride ldx, contraction index k at xs[k -
// xbase]).  A thread owns E = 4 columns (8 bytes of a bf16 row, 4 of an
// int8 or packed int4 row) of RG stored rows of each stage: lane = q + CW
// g, chunk c = CW w + q of the tile's 1 KB row (a warp's lanes of one row
// group read one contiguous run), row group g (rows g RG .. g RG + RG - 1;
// bf16 two groups of 8 rows, int8 / int4 one of 16).  Each thread sums
// each row r of the pass over its rows in order, in registers (4 RB
// independent sums, 64 at 16 rows); at the item's end the row groups add
// by a shuffle and the g = 0 lanes write the item's fp32 partials to
// `gout` [nr rows at stride NT][cols].  Nothing of it depends on the row
// count but the number of sums.  Weights widen exactly
// (bf16 by a shift, int8 through 2^23 + byte, int4 as before: each nibble
// times its group's scale, rounded to T); an int8 column scale comes after
// the chunks are combined.
template <typename T, int KIND, int RB>
__device__ __forceinline__ void tma_item(const Args& a, const Geo& g,
                                         const Item& it, int l, Ring& ring,
                                         const float* xs, int ldx, int xbase,
                                         float* gout, int NT, int nr) {
  constexpr int E = 4;                        // columns a thread
  constexpr int CB = KIND == 0 ? 2 * E : E;   // bytes of a thread's chunk
  constexpr int NG = kThreads * CB / kRowBytes;   // row groups: 1-4
  constexpr int CW = 32 / NG;                 // chunks a warp
  constexpr int RG = kStageRows / NG;         // stored rows a group
  constexpr int CPR = kBoxCols * (KIND == 0 ? 2 : 1) / CB;  // a box row
  constexpr int BOX = kStageRows * CPR * CB;
  constexpr int LR = KIND == 4 ? 2 * RG : RG; // logical rows a group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane % CW, grp = lane / CW;
  const int c = warp * CW + q;
  // byte offset of this thread's chunk in its group's first row
  const int off = (c / CPR) * BOX + grp * RG * CPR * CB + (c % CPR) * CB;
  float acc[RB][E];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  // the loop reads scalars only (the barriers' asm clobbers memory, and
  // the structs the phase indexes at run time live there)
  const int k0 = it.k0, k1 = it.k1, rps = g.rps, gsz = a.gsz;
  const uint32_t bars = ring.bars;
  const unsigned char* base = ring.base;
  int stage = ring.stage;
  uint32_t ph = ring.ph;
  // int4: this thread's group scales, [L, K / gsz, N] (a ragged tile's
  // columns past N read none: their codes are zero-filled)
  const int N = it.N;
  const int col = it.n0 + E * c;
  const float* sc = nullptr;
  if constexpr (KIND == 4)
    sc = a.ws[it.which] + (size_t)l * (g.K / gsz) * N + col;
  for (int s0 = k0; s0 < k1; s0 += rps) {
#ifdef DECODE_STEP_STAMPS
    const unsigned long long tw = threadIdx.x == 0 ? now_ns() : 0;
#endif
    mbar_wait(bars + 8 * stage, ph);
#ifdef DECODE_STEP_STAMPS
    if (threadIdx.x == 0 && blockIdx.x < kStampGrid)
      g_box_wait[blockIdx.x] += now_ns() - tw;
#endif
    const unsigned char* wp = base + stage * kStageBytes + off;
    // (an item's bounds are whole multiples of 32 rows: every row of each
    // of its stages is live)
    const float* xw = xs + (s0 + grp * LR - xbase);
    // the words of this thread's chunk of its RG rows
    using Chunk = typename std::conditional<CB == 8, uint2, unsigned>::type;
    Chunk wv[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
      wv[i] = *reinterpret_cast<const Chunk*>(wp + i * CPR * CB);
    if constexpr (KIND != 4) {
#pragma unroll
      for (int i4 = 0; i4 < RG / 4; ++i4) {
        float4 xv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          xv[r] = *reinterpret_cast<const float4*>(xw + r * ldx + 4 * i4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned u[CB / 4];
          memcpy(u, &wv[4 * i4 + i], CB);
          float wf[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if constexpr (KIND == 0)
              wf[e] = __uint_as_float(e & 1 ? u[e >> 1] & 0xffff0000u
                                            : u[e >> 1] << 16);
            else                                    // 2^23 + (byte + 128)
              wf[e] = __uint_as_float(__byte_perm(u[e >> 2] ^ 0x80808080u,
                                                  0x4B000000u,
                                                  0x7650u + (e & 3)))
                      - 8388736.0f;
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float x = f4at(xv[r], i);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] = fmaf(x, wf[e], acc[r][e]);
          }
        }
      }
    } else {
      int gcur = -1;
      float se[E];
#pragma unroll
      for (int e = 0; e < E; ++e) se[e] = 0.0f;
#pragma unroll
      for (int i4 = 0; i4 < RG / 2; ++i4) {       // 2 packed rows each
        float4 xv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          xv[r] = *reinterpret_cast<const float4*>(xw + r * ldx + 4 * i4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gi = (s0 + grp * LR + 4 * i4 + 2 * i) / gsz;
          if (gi != gcur) {
            gcur = gi;
            if (col < N) {
              const float4* sp =
                  reinterpret_cast<const float4*>(sc + (size_t)gi * N);
#pragma unroll
              for (int e4 = 0; e4 < E / 4; ++e4) {
                const float4 v = __ldg(sp + e4);
                se[4 * e4] = v.x; se[4 * e4 + 1] = v.y;
                se[4 * e4 + 2] = v.z; se[4 * e4 + 3] = v.w;
              }
            }
          }
          unsigned u[CB / 4];
          memcpy(u, &wv[2 * i4 + i], CB);
          float lo[E], hi[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int p = (int)(signed char)((u[e >> 2] >> (8 * (e & 3)))
                                             & 0xffu);
            const int nl = (int)((unsigned)p << 28) >> 28;
            const int nh = (int)((unsigned)p << 24) >> 28;
            lo[e] = round_to<T>(__fmul_rn((float)nl, se[e]));
            hi[e] = round_to<T>(__fmul_rn((float)nh, se[e]));
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float x0 = f4at(xv[r], 2 * i);
            const float x1 = f4at(xv[r], 2 * i + 1);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              acc[r][e] = fmaf(x0, lo[e], acc[r][e]);
              acc[r][e] = fmaf(x1, hi[e], acc[r][e]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + stage));
    if (++stage == kStages) {
      stage = 0;
      ph ^= 1;
    }
  }
  ring.stage = stage;
  ring.ph = ph;
  // the row groups' sums: a fixed shuffle tree over the lanes' group bits
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v = acc[r][e];
#pragma unroll
      for (int m = CW; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      acc[r][e] = v;
    }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < nr) {
        float4* o = reinterpret_cast<float4*>(gout + (size_t)r * NT + E * c);
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4)
          o[e4] = make_float4(acc[r][4 * e4], acc[r][4 * e4 + 1],
                              acc[r][4 * e4 + 2], acc[r][4 * e4 + 3]);
      }
  }
}

template <typename T, int KIND>
__device__ __forceinline__ void tma_item_k(int rb, const Args& a,
                                           const Geo& g, const Item& it,
                                           int l, Ring& ring, const float* xs,
                                           int ldx, int xbase, float* gout,
                                           int NT, int nr) {
  switch (rb) {
    case 1: tma_item<T, KIND, 1>(a, g, it, l, ring, xs, ldx, xbase, gout, NT,
                                 nr); break;
    case 2: tma_item<T, KIND, 2>(a, g, it, l, ring, xs, ldx, xbase, gout, NT,
                                 nr); break;
    case 4: tma_item<T, KIND, 4>(a, g, it, l, ring, xs, ldx, xbase, gout, NT,
                                 nr); break;
    case 8: tma_item<T, KIND, 8>(a, g, it, l, ring, xs, ldx, xbase, gout, NT,
                                 nr); break;
    default: tma_item<T, KIND, 16>(a, g, it, l, ring, xs, ldx, xbase, gout,
                                   NT, nr);
  }
}

// out[r * 32 + c] = the sum, in chunk order, of chunks [c0, c1) of the
// partials p (chunk stride cstr, row stride NT) at column j + c, the loads
// of 32 chunks issued together
__device__ __noinline__ void chunk_sum(const float* p, size_t cstr, int NT,
                                       int j, int c0, int c1, int nr,
                                       float* out) {
  constexpr int B = 32;
  for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
    const float* pp = p + (size_t)(idx >> 5) * NT + j + (idx & 31);
    float s = 0.0f;
    for (int b0 = c0; b0 < c1; b0 += B) {
      float pv[B];
#pragma unroll
      for (int e = 0; e < B; ++e)
        pv[e] = b0 + e < c1 ? __ldcg(pp + (size_t)(b0 + e) * cstr) : 0.0f;
#pragma unroll
      for (int e = 0; e < B; ++e)
        if (b0 + e < c1) s = b0 + e == c0 ? pv[e] : __fadd_rn(s, pv[e]);
    }
    out[idx] = s;
  }
  csync();
}

// Every chunk of tile `it.t` is in: add the chunks of its 32 columns [j, j
// + 32) in chunk order and run the phase's epilogue on them (the fp32
// body's, after its GEMV): q/k/v the int8 scale, the LoRA delta and RoPE;
// wo the scale, the delta and the residual; gate/up the scale and the
// delta; w_down each segment's sum times the scale added to the residual
// in turn, then the delta once.
template <typename T>
__device__ void tma_epilogue(const Args& a, const Geo& g, const Item& it,
                             int ph, int l, bool lora, int r0, int nr, int j,
                             float* cs) {
  float* tile = cs + kOutT;
  float* ls = cs + kLsT;
  const int which = it.which, N = it.N;
  const int h = a.h, d = a.d, nqd = a.nq * a.d;
  const int n = it.n0 + j;                      // column in the matrix
  const Mat m = layer_mat<T>(a, which, l, g.K, N);
  const int NT = g.ntiles * g.cols;
  const size_t cstr = (size_t)a.rows * NT;
  const float* p0 = a.gpart + (size_t)r0 * NT + it.t * g.cols;
  if (ph == 3) {
    for (int seg = 0; seg < a.nm; ++seg) {
      chunk_sum(p0, cstr, NT, j, seg * g.cps, (seg + 1) * g.cps, nr, tile);
      add_to_residual(a, m, r0, nr, n, tile, nullptr);
    }
    const float* dl = lora_tile(a, lora, 6, l, a.ffn, h, r0, nr, n, ls);
    if (dl) {
      for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
        float* rp = a.res + (size_t)(r0 + (idx >> 5)) * h + n + (idx & 31);
        *rp = lora_add(dl, idx, __ldcg(rp));
      }
      csync();
    }
    return;
  }
  chunk_sum(p0, cstr, NT, j, 0, g.nch, nr, tile);
  if (ph == 1) {
    add_to_residual(a, m, r0, nr, n, tile,
                    lora_tile(a, lora, 3, l, nqd, h, r0, nr, n, ls));
    return;
  }
  const float* dl = lora_tile(a, lora, which, l, g.K, N, r0, nr, n, ls);
  if (ph == 2) {
    float* dst = which == 4 ? a.gate : a.up;
    for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
      float y = tile[idx];
      if (m.kind == 8) y = __fmul_rn(y, m.s[n + (idx & 31)]);
      dst[(size_t)(r0 + (idx >> 5)) * N + n + (idx & 31)] =
          lora_add(dl, idx, y);
    }
    csync();
    return;
  }
  for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
    float y = tile[idx];
    if (m.kind == 8) y = __fmul_rn(y, m.s[n + (idx & 31)]);
    tile[idx] = lora_add(dl, idx, y);
  }
  csync();
  float* dst = which == 0 ? a.q : which == 1 ? a.kn : a.vn;
  for (int idx = threadIdx.x; idx < nr * kTileN; idx += kThreads) {
    const int r = r0 + (idx >> 5), c = n + (idx & 31);
    float y = tile[idx];
    if (which != 2) {                           // y * C + swap(y) * S
      const int dc = c % d;
      y = __fadd_rn(__fmul_rn(y, a.c_rows[(size_t)r * d + dc]),
                    __fmul_rn(tile[idx ^ 1], a.s_rows[(size_t)r * d + dc]));
    }
    dst[(size_t)r * N + c] = y;
  }
  csync();
}

// One GEMV phase on the compute warps: for each pass of up to 16 rows,
// the block's items in order; the inputs staged whole when the pass's rows
// x K fit kXsT floats, else each item's chunk; each item's partials go to
// scratch.  A grid barrier, then ``tma_combine``, finishes the phase.
template <typename T>
__device__ __forceinline__ void tma_phase(const Args& a, int ph, int l,
                                          Ring& ring, float* cs) {
  const Geo g = geo(a, ph);
  const int G = gridDim.x;
  if ((int)blockIdx.x >= g.items) return;
  float* rs = cs + kRsT;
  Src src;
  if (ph == 0 || ph == 2) {
    row_rstd(a.res, a.rows, a.h, a.eps, rs);
    src = Src{0, a.res, nullptr,
              static_cast<const T*>(ph == 0 ? a.nw1 : a.nw2)
                  + (size_t)l * a.h,
              rs, a.h, 0};
  } else if (ph == 1) {
    src = Src{1, a.ctx, nullptr, nullptr, nullptr, a.nq * a.d, 0};
  } else {
    src = Src{2, a.gate, a.up, nullptr, nullptr, a.ffn, a.act};
  }
  const int NT = g.ntiles * g.cols;
  for (int r0 = 0; r0 < a.rows; r0 += kMaxRB) {
    const int nr = min(kMaxRB, a.rows - r0), rb = rb_of(nr);
    const bool whole = rb * g.K <= kXsT;
    int s_lo = -1, s_hi = -1;                   // contraction rows staged
    for (int it = blockIdx.x; it < g.items; it += G) {
      const Item i = item_of(g, it);
      unsigned long long ts = stamp_add(l, stamp_of(ph), 4, 0);
      if (i.k0 < s_lo || i.k1 > s_hi) {
        s_lo = whole ? 0 : i.k0;
        s_hi = whole ? g.K : i.k1;
        csync();
        stage<T>(src, r0, nr, rb, s_lo, s_hi - s_lo, s_hi - s_lo, cs);
        csync();
      }
      ts = stamp_add(l, stamp_of(ph), 4, ts);
      float* gout = a.gpart + ((size_t)i.c * a.rows + r0) * NT + i.t * g.cols;
      if (g.kind == 8)
        tma_item_k<T, 8>(rb, a, g, i, l, ring, cs, s_hi - s_lo, s_lo, gout,
                         NT, nr);
      else if (g.kind == 4)
        tma_item_k<T, 4>(rb, a, g, i, l, ring, cs, s_hi - s_lo, s_lo, gout,
                         NT, nr);
      else
        tma_item_k<T, 0>(rb, a, g, i, l, ring, cs, s_hi - s_lo, s_lo, gout,
                         NT, nr);
#ifdef DECODE_STEP_STAMPS
      if (threadIdx.x == 0 && g_stamps && blockIdx.x < kStampGrid) {
        *stamp_at(l, stamp_of(ph), 3) += g_box_wait[blockIdx.x];
        ts += g_box_wait[blockIdx.x];
        g_box_wait[blockIdx.x] = 0;
      }
#endif
      stamp_add(l, stamp_of(ph), 5, ts);
    }
  }
}

// The end of a GEMV phase, after a grid barrier: every (pass, tile, 32
// output columns) unit of the phase, dealt round robin over the blocks,
// adds its chunks' partials in chunk order and runs the phase's epilogue
// (``tma_epilogue``).
template <typename T>
__device__ __forceinline__ void tma_combine(const Args& a, int ph, int l,
                                            bool lora, float* cs) {
  const Geo g = geo(a, ph);
  const int sub = g.cols / kTileN;              // units a tile
  const int passes = (a.rows + kMaxRB - 1) / kMaxRB;
  for (int u = blockIdx.x; u < passes * g.ntiles * sub; u += gridDim.x) {
    const int pass = u / (g.ntiles * sub), rem = u - pass * g.ntiles * sub;
    const Item i = item_of(g, rem / sub * g.nch);
    const int j = (rem % sub) * kTileN;
    if (i.n0 + j >= i.N) continue;              // past a ragged tile's edge
    const int r0 = pass * kMaxRB;
    tma_epilogue<T>(a, g, i, ph, l, lora, r0, min(kMaxRB, a.rows - r0), j,
                    cs);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename C, int D>
__device__ void attend_d(const Args& a, int l, int r, int hk, float* smem) {
  const int g = a.nq / a.nkv;
  if (g <= 1) attn_item<C, D, 1>(a, l, r, hk, smem);
  else if (g <= 2) attn_item<C, D, 2>(a, l, r, hk, smem);
  else if (g <= 4) attn_item<C, D, 4>(a, l, r, hk, smem);
  else attn_item<C, D, 8>(a, l, r, hk, smem);
}

template <typename C>
__device__ void attend(const Args& a, int l, int r, int hk, float* smem) {
  if (a.d == 64) attend_d<C, 64>(a, l, r, hk, smem);
  else attend_d<C, 128>(a, l, r, hk, smem);
}

// the GEMV and attention phases overlap in shared memory (a phase uses one)
constexpr int kSmemFloats =
    kGemvFloats > AttnSmem<64>::kFloats
        ? (kGemvFloats > AttnSmem<128>::kFloats ? kGemvFloats
                                                : AttnSmem<128>::kFloats)
        : AttnSmem<64>::kFloats;
constexpr int kSmemBytes = kSmemFloats * 4;

// threads and shared memory of an instantiation: the bf16 kernel has the
// 8 compute warps and a producer warpgroup (its first warp's first thread
// issues every load; registers move from it to the compute warps), and
// the ring
constexpr int kProducerRegs = 40, kComputeRegs = 232;
static_assert(kThreads * kComputeRegs + 128 * kProducerRegs <= 65536,
              "the register file of a SM");
template <typename T>
constexpr int kBlockOf = sizeof(T) == 2 ? kThreads + 128 : kThreads;
template <typename T>
constexpr int kSmemOf = sizeof(T) == 2 ? kTmaSmemBytes : kSmemBytes;

template <typename T, typename C>
__global__ void __launch_bounds__(kBlockOf<T>, 1)
    decode_step_kernel(const Args a, const __grid_constant__ Maps mp) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr bool kTma = sizeof(T) == 2;
  float* smem;                                  // the compute warps' floats
  float* ls;                                    // the LoRA epilogue's
  float* rs;                                    // rstd of every row
  Ring ring{0u, 0, 0u, smem_raw};
  if constexpr (kTma) {
    const uint32_t ring_at = smem_u32(smem_raw);
    const uint32_t bars = ring_at + kRingBytes;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(bars + 8 * s, 1);                     // full: the producer
        mbar_init(bars + 8 * (kStages + s), kWarps);    // empty: each warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kThreads) {              // the producer warpgroup
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                   :: "n"(kProducerRegs));
      if (threadIdx.x == kThreads) produce(a, mp, ring_at, bars);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kComputeRegs));
    ring.bars = bars;
    smem = reinterpret_cast<float*>(smem_raw + kRingBytes + kBarBytes);
    ls = smem + kLsT;
    rs = smem + kRsT;
  } else {
    smem = reinterpret_cast<float*>(smem_raw);
    ls = smem + kLs;
    rs = smem + kRs;
  }
  unsigned target = 0;
  const int nthr = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  for (int i = first; i < a.rows * a.h; i += nthr)
    a.res[i] = ld1<T>(static_cast<const T*>(a.x) + i);
  // LoRA: the arena tiles some row selects (none: no LoRA phase at all)
  const unsigned used = a.lsr ? lora_tiles(a, smem, ls) : 0u;
  const bool lora = used != 0u;
  const bool lq = lora && (a.la[0] || a.la[1] || a.la[2]);
  const bool lo = lora && a.la[3];
  const bool lgu = lora && (a.la[4] || a.la[5]);
  const bool ld = lora && a.la[6];
  const int nwb = sizeof(T) == 2;
  grid_sync(a.bar, target);
  // the end of phase ph of layer l: its stamps around the grid barrier
  auto done = [&](int l, int ph) {
    stamp(l, ph, 1);
    grid_sync(a.bar, target);
    stamp(l, ph, 2);
  };
  // GEMV phase p (0 q/k/v, 1 wo, 2 gate/up, 3 w_down) of layer l: the
  // bf16 body streams its items, then after a grid barrier combines them
  auto gemv_phase = [&](int p, int l, bool lor) {
    if constexpr (kTma) {
      tma_phase<T>(a, p, l, ring, smem);
      unsigned long long ts = stamp_add(l, stamp_of(p), 6, 0);
      grid_sync(a.bar, target);
      ts = stamp_add(l, stamp_of(p), 6, ts);
      tma_combine<T>(a, p, l, lor, smem);
      stamp_add(l, stamp_of(p), 7, ts);
    } else {
      if (p == 0) phase_qkv<T>(a, l, lor, smem);
      else if (p == 1) phase_wo<T>(a, l, lor, smem);
      else if (p == 2) phase_gateup<T>(a, l, lor, smem);
      else phase_down<T>(a, l, lor, smem);
    }
  };
  for (int l = 0; l < a.L; ++l) {
    const size_t lh = (size_t)l * a.h;
    if (lq) {
      stamp(l, 0, 0);
      row_rstd(a.res, a.rows, a.h, a.eps, rs);
      lora_xa_phase(a, l, 0, 3, a.h,
                    LSrc{0, a.res, nullptr, static_cast<const T*>(a.nw1) + lh,
                         nwb, rs, a.h, 0}, used, smem);
      done(l, 0);
    }
    stamp(l, 1, 0);
    gemv_phase(0, l, lq);
    done(l, 1);
    stamp(l, 2, 0);
    for (int it = blockIdx.x; it < a.rows * a.nkv; it += gridDim.x)
      attend<C>(a, l, it / a.nkv, it % a.nkv, smem);
    done(l, 2);
    if (lo) {
      stamp(l, 3, 0);
      lora_xa_phase(a, l, 3, 4, a.nq * a.d,
                    LSrc{1, a.ctx, nullptr, nullptr, 0, nullptr,
                         a.nq * a.d, 0}, used, smem);
      done(l, 3);
    }
    stamp(l, 4, 0);
    gemv_phase(1, l, lo);
    done(l, 4);
    if (lgu) {
      stamp(l, 5, 0);
      row_rstd(a.res, a.rows, a.h, a.eps, rs);
      lora_xa_phase(a, l, 4, 6, a.h,
                    LSrc{0, a.res, nullptr, static_cast<const T*>(a.nw2) + lh,
                         nwb, rs, a.h, 0}, used, smem);
      done(l, 5);
    }
    stamp(l, 6, 0);
    gemv_phase(2, l, lgu);
    done(l, 6);
    if (ld) {
      stamp(l, 7, 0);
      lora_xa_phase(a, l, 6, 7, a.ffn,
                    LSrc{2, a.gate, a.up, nullptr, 0, nullptr, a.ffn, a.act},
                    used, smem);
      done(l, 7);
    }
    stamp(l, 8, 0);
    gemv_phase(3, l, ld);
    done(l, 8);
  }
  for (int i = first; i < a.rows * a.h; i += nthr)
    st1<T>(static_cast<T*>(a.hidden) + i, __ldcg(a.res + i));
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// build links no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The seven weights' tensor maps ([L, K, N], int4 [L, K / 2, N]; boxes of
// kStageRows stored rows x kBoxCols elements, zero fill past the edges); 0
// or a cudaError_t.
int make_maps(const Args& a, Maps* mp) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const int nqd = a.nq * a.d, nkvd = a.nkv * a.d;
  const int K[7] = {a.h, a.h, a.h, nqd, a.h, a.h, a.ffn};
  const int N[7] = {nqd, nkvd, nkvd, a.h, a.ffn, a.ffn, a.h};
  for (int w = 0; w < 7; ++w) {
    const int kind = w < 4 ? a.aq : a.mq;
    const cuuint64_t es = kind ? 1 : 2;
    const cuuint64_t ks = kind == 4 ? K[w] / 2 : K[w];
    if (reinterpret_cast<uintptr_t>(a.w[w]) % 16) return cudaErrorInvalidValue;
    const cuuint64_t dim[3] = {(cuuint64_t)N[w], ks, (cuuint64_t)a.L};
    const cuuint64_t stride[2] = {N[w] * es, ks * N[w] * es};
    const cuuint32_t box[3] = {kBoxCols, kStageRows, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    if (encode(&mp->w[w],
               kind ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               3, const_cast<void*>(a.w[w]), dim, stride, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T, typename C>
int launch(const Args* args, cudaStream_t stream) {
  auto kern = decode_step_kernel<T, C>;
  constexpr int threads = kBlockOf<T>, bytes = kSmemOf<T>;
  static int per_sm = -1;  // blocks per SM, found once per instantiation
  cudaError_t err;
  if (per_sm < 0) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                        bytes);
    if (err != cudaSuccess) return err;
    per_sm = n;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  Args a = *args;
  Maps mp = {};
  if (sizeof(T) == 2) {
    // the split-contraction partials
    long long need = 0;
    for (int p = 0; p < 4; ++p) {
      const Geo g = geo(a, p);
      const long long n = (long long)g.nch * a.rows * g.ntiles * g.cols;
      need = n > need ? n : need;
    }
    if (!a.gpart || a.gcap < need) return cudaErrorInvalidValue;
    const int bad = make_maps(a, &mp);
    if (bad) return bad;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per_sm * sms);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a, mp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// A tree the kernel takes: per slot, node 0 is the root (depth 0), depths
// never fall with the node index and stay at or below it, and a node's
// ancestor at each depth below its own is an earlier node.  The operands
// are copied to the host once (a synchronisation with the stream: a verify
// step is synchronous in any case).  0 or a cudaError_t.
static int check_tree(const Args* a, cudaStream_t stream) {
  if (!a->depths) return a->anc ? cudaErrorInvalidValue : 0;
  if (!a->anc || !a->paged) return cudaErrorInvalidValue;
  const int n = a->rows, W = a->W;
  int dep[kMaxRows], anc[kMaxRows * kMaxWindow];
  cudaError_t err = cudaMemcpyAsync(dep, a->depths, n * sizeof(int),
                                    cudaMemcpyDeviceToHost, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(anc, a->anc, (size_t)n * W * sizeof(int),
                          cudaMemcpyDeviceToHost, stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return err;
  for (int r = 0; r < n; ++r) {
    const int j = r % W, t = dep[r];
    if (t < 0 || t > j || (j == 0 && t != 0) || (j > 0 && t < dep[r - 1]))
      return cudaErrorInvalidValue;
    for (int i = 0; i < t; ++i)
      if (anc[r * W + i] < 0 || anc[r * W + i] >= j)
        return cudaErrorInvalidValue;
  }
  return 0;
}

#ifdef DECODE_STEP_STAMPS
// Probe builds only: point the kernel's stamps at `buf` (device memory of
// L x kStampPhases x kStampGrid x 3 u64; null: none).  0 or a cudaError_t.
extern "C" int decode_step_stamps(void* buf) {
  return cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
}
#endif

// The C interface: ``args`` points at one Args describing the call (every
// pointer a contiguous CUDA buffer), dtype 0 fp32 / 1 bf16 for x, weights
// and norms, int8_cache 0 for a cache in x's dtype, 1 for the int8 form.
// fp32 runs the CUDA-core body, bf16 the TMA weight stream; *body is set to
// the body that was launched (kBodySimt or kBodyTma), and left as it is
// when nothing was.  Returns the launch's cudaError_t (0 = launched;
// cudaErrorInvalidValue for arguments out of the kernel's limits, scratch
// too small, or a tree it does not take).
extern "C" int decode_step_launch(const void* args, int dtype,
                                  int int8_cache, void* stream, int* body) {
  const Args* a = static_cast<const Args*>(args);
  const int g = a->nkv > 0 ? a->nq / a->nkv : 0;
  if ((a->d != 64 && a->d != 128) || a->nkv <= 0 || a->nq % a->nkv
      || g > kMaxGroup || a->rows < 1 || a->rows > kMaxRows || a->W < 1
      || a->W > kMaxWindow || a->rows % a->W || a->h % kTileN
      || a->nm < 1 || a->ffn % (a->nm * kTileN)
      || (a->paged && a->width != (1 << a->shift)))
    return cudaErrorInvalidValue;
  if (a->lsr) {
    const int nqd = a->nq * a->d;
    const int in_max = a->ffn > nqd ? (a->ffn > a->h ? a->ffn : a->h)
                                    : (nqd > a->h ? nqd : a->h);
    if (a->lsr < 0 || a->lsr % kTileN || a->lsr > kMaxLoraSr || !a->lmask
        || !a->lpart || a->lch * kLoraChunk < in_max)
      return cudaErrorInvalidValue;
    for (int t = 0; t < 7; ++t)
      if (!a->la[t] != !a->lb[t]) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tree_err = check_tree(a, s);
  if (tree_err) return tree_err;
  if (dtype == kFloat32)
    return ran((cudaError_t)(int8_cache ? launch<float, int8_t>(a, s)
                                        : launch<float, float>(a, s)),
               kBodySimt, body);
  if (dtype == kBFloat16)
    return ran((cudaError_t)(int8_cache
                                 ? launch<__nv_bfloat16, int8_t>(a, s)
                                 : launch<__nv_bfloat16, __nv_bfloat16>(a, s)),
               kBodyTma, body);
  return cudaErrorInvalidValue;
}
