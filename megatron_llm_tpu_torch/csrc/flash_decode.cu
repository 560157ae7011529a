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
// two; table entries past the fill (the trash block 0) are never copied.
// Only the copies differ: everything else (the splits, lane groups, the
// softmax and both merges) depends on logical columns only, so a paged call
// gives the dense call's output bit for bit on the same logical cache.
//
// What bounds these on the H100: bytes.  Each (row, kv-head) reads its cache
// up to the fill once (2 * len * d elements, plus 2 * len fp32 scales for
// int8) and does 4 * g * len * d flops on them: at g <= 8 that is under 8
// flop/byte against the card's ~295, so a call can only be as fast as it
// streams K and V, and the tensor cores would buy nothing.  int8 halves
// those bytes.
//
// Design for that (the split cache walk; it replaced one block per (row,
// kv head), where the longest row's heads set the time and a GQA grid of
// 4 rows x 8 kv heads filled a quarter of the card):
// - each row's walk is cut into splits of kSplitCols columns, a constant
//   of this file alone (mirrored by kernels/flash_decode.py:SPLIT_COLS),
//   never of the batch, the other rows' fills or the card; one block a
//   (row, kv head, split).  The grid, b x kv x ceil(width / kSplitCols),
//   follows from the shapes alone (no host sync); a block past its row's
//   live splits ceil(fill / kSplitCols) exits at once (blocks take the
//   last splits first: the long rows start early).  The g query heads
//   of the GQA group are the block's query rows, so each K/V element is
//   read once for all g of them (the TPU kernel does the same);
// - inside a split, one thread stages tiles of kTileRows cache rows of K
//   and V (and their int8 scales) into a ring of kStages in shared memory
//   with 1-D bulk copies (cp.async.bulk) that complete on an mbarrier: 64
//   logical rows are contiguous in a dense cache and inside one pool block
//   of 64 or more, and a smaller block is one copy per block.  A tile's
//   copies cover only rows below the split's end (its int8 scales rounded
//   up to 4 rows, 16 bytes, copied only where max_len or the pool block
//   is a multiple of 4, which keeps them inside the allocation; else the
//   threads load a tile's live scales into its stage), so nothing past a
//   row's allocation or its live blocks is read;
// - a lane group of kLanes threads owns one cache row at a time, each
//   thread kEpt columns of it; the lane groups of a set of 256 threads
//   take the tile's rows round robin and run their own online softmax.
//   At a group of 4 or more, two sets share the tiles, each with half of
//   the query rows (a 512-thread block: the dependent FMAs and shuffles
//   of 4-8 query rows need the warps).  Rows at or past the fill never
//   enter an FMA: the row loop masks them by bound (a selected zero, never
//   a weight times garbage);
// - at the split's end the lane groups of a warp merge by shuffles, a
//   set's eight warps' states through shared memory (the ring's bytes) in
//   warp order;
// - a row with one live split writes its output directly; a row with
//   several writes each split's fp32 partial (m, l, acc) to scratch, then
//   a ticket: the last arriver of the (row, kv head) stages every split's
//   (m, l) in shared memory and merges the partials in split order, so
//   the bits do not depend on which block finished last, and resets the
//   ticket to 0 for the next launch.  A partial is stored, then
//   announced by an acq_rel atomic after a block barrier.
// A row's bits are a function of its q, its cache and its fill only: a row
// alone equals its row in any batch, and run to run.
// A row with fill 0 (no caller passes one: the decode call site passes
// cache_len + 1) gets what the TPU kernel's finite -1e30 mask gives it:
// every cache row scores the same, so the output is the mean of V over the
// walked width (max_len, or table width x block when paged).
#include "common.cuh"

#include <math.h>

#include <type_traits>

namespace {

// Per-block time stamps, in a probe build only (nvcc -DFD_STAMPS,
// kernels/decode_attention_probe.py --stamps), into [grid][kStampSlots] u64
// at g_fd_stamps (null: none): the block's SM, %globaltimer at its entry,
// when its first tile landed, at the walk's end, when its output or
// partial was written, and at its exit.
constexpr int kStampSlots = 6;
#ifdef FD_STAMPS
__device__ unsigned long long* g_fd_stamps;
__device__ __forceinline__ void stamp(int slot) {
  if (threadIdx.x == 0 && g_fd_stamps != nullptr) {
    unsigned long long v;
    if (slot == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      v = sm;
    } else {
      v = now_ns();
    }
    g_fd_stamps[(size_t)blockIdx.x * kStampSlots + slot] = v;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

constexpr int kSetThreads = 256;           // threads a set of query rows
constexpr int kWarps = kSetThreads / 32;    // warps a set
constexpr int kTileRows = 64;               // cache rows a ring stage holds
constexpr int kSplitCols = 256;             // columns a block walks
// the ring's shared memory: 96 KB at bf16 d 128 is three stages and two
// blocks a SM (128- and 64-KB rings were slower or even, PERF.md)
constexpr int kRingBudget = 98304;
// the ring's mbarriers, the merge flag, then a split's pool block ids
constexpr int kHeadBytes = 128 + 4 * kSplitCols;
static_assert(kSplitCols % 128 == 0,
              "a split must end on a pool block of 16, 64 or 128");
static_assert(kSplitCols % kTileRows == 0, "whole tiles a split");

constexpr int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
constexpr int maxi(int x, int y) { return x > y ? x : y; }

// One 16-byte word of cache elements, widened to fp32.
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

// RUN contiguous cache elements from shared memory, widened: one 16-byte
// word, or (int8, RUN 8) 8 bytes
template <typename C, int RUN>
__device__ __forceinline__ void load_run(const C* p, float* o) {
  if constexpr (RUN == Word<C>::N) {
    Word<C>::to_float(*reinterpret_cast<const uint4*>(p), o);
  } else {
    static_assert(sizeof(C) == 1 && RUN == 8, "8-byte runs are int8");
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    s8x4(w.x, o);
    s8x4(w.y, o + 4);
  }
}

// Threads a block and blocks a SM for group bucket G: at G >= 4 the
// group's query rows are dealt to two sets of 256 threads that walk the
// same staged tiles (twice the warps a SM to cover the dependent FMAs and
// shuffles of 4-8 query rows: on an H100, 0.0146 against 0.0173 ms with
// one set at 32 q / 8 kv heads, PERF.md); a 512-thread block is one a SM.
#define FD_SETS(G) ((G) >= 4 ? 2 : 1)
#define FD_BLOCK(G) (kSetThreads * FD_SETS(G))
#define FD_MIN_BLOCKS(G) ((G) >= 4 ? 1 : 2)

// One more arrival at a ticket: a release of what the block stored before
// it and an acquire of what the earlier arrivals stored; the old count.
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The body's shape for a cache element C, head dim D and group bucket G.
template <typename C, int D, int G>
struct Geo {
  static constexpr bool kQuant = sizeof(C) == 1;
  static constexpr int kSets = FD_SETS(G);
  static constexpr int kGs = G / kSets;            // query rows a set
  static constexpr int kBlock = FD_BLOCK(G);
  // columns a thread holds of each row: 16 where the registers allow (q and
  // the accumulator are kGs x kEpt floats each), else 8
  static constexpr int kEpt = (D == 128 && kGs <= 2) ? 16 : 8;
  // contiguous columns a thread reads at once (16 bytes, or 8 int8)
  static constexpr int kRun = Word<C>::N < kEpt ? Word<C>::N : kEpt;
  static constexpr int kRuns = kEpt / kRun;
  static constexpr int kLanes = D / kEpt;          // threads a row
  static constexpr int kGroups = kSetThreads / kLanes;  // lane groups a set
  static constexpr int kRowsPer = kTileRows / kGroups;  // a group's, a tile
  static constexpr int kRowBytes = D * (int)sizeof(C);
  static constexpr int kTileBytes = kTileRows * kRowBytes;
  // K tile, V tile, then (int8) the tile's k and v scales
  static constexpr int kStageBytes =
      2 * kTileBytes + (kQuant ? 2 * kTileRows * 4 : 0);
  // the ring's budget: 96 KB at bf16 d 128 is three stages and two blocks
  // a SM; an int8 stage is half the size, and two thirds of the budget
  // (three stages) lets four blocks share a SM (on an H100, K9 at the
  // smoke's row 0.0159 against 0.0181 ms with four stages, PERF.md)
  static constexpr int kBudget =
      kQuant ? kRingBudget * 2 / 3 : kRingBudget;
  static constexpr int kStages = clampi(kBudget / kStageBytes, 2, 4);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the warps' (m, l, acc) states at the split's end, over the ring
  static constexpr int kMergeBytes = kSets * kWarps * kGs * (D + 2) * 4;
  static constexpr int kSmem = kHeadBytes + maxi(kRingBytes, kMergeBytes);
  // splits the merger stages (a weight and an l per split and row)
  static constexpr int kMaxSplits = (kRingBytes / 4 - G) / (2 * G);
  static_assert(kSets * kGs == G, "whole query rows a set");
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a row within a warp");
  static_assert(kTileRows % kGroups == 0, "whole rows a group");
  static_assert(kRuns * kRun == kEpt, "whole runs");
  static_assert(kStages * 8 <= 64, "barriers before the flag");
};

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
  float* part;         // n_splits > 1: [b, kv, n_splits, group] x (D + 2)
  int* tickets;        // n_splits > 1: [b * kv], zero between launches
  int rows, n_heads, kv_heads, width, n_tbl, shift, group, n_splits;
  bool stage_scales;   // int8: a tile's scales are bulk-copied with it
  float scale;
};

template <typename T, typename C, int D, int G, bool PAGED>
__device__ __forceinline__ void decode_body(const Args& a,
                                            unsigned char* smem) {
  using Gm = Geo<C, D, G>;
  constexpr bool QUANT = Gm::kQuant;
  constexpr int EPT = Gm::kEpt, RUN = Gm::kRun, NR = Gm::kRuns;
  constexpr int L = Gm::kLanes, NGRP = Gm::kGroups, U = Gm::kRowsPer;
  constexpr int GS = Gm::kGs, S = Gm::kStages, NT = Gm::kBlock;
  constexpr int ROWB = Gm::kRowBytes, TILEB = Gm::kTileBytes;
  constexpr int STAGEB = Gm::kStageBytes;
  static_assert(RUN % Vec16<T>::N == 0, "q runs must be whole 16-byte loads");

  stamp(0);
  stamp(1);
  const int bh_n = a.rows * a.kv_heads;
  const int bh = blockIdx.x % bh_n;      // (row, kv head)
  // split: the last splits first, so the long rows' walks start early,
  // most dead blocks exit while the first tiles land, and the grid ends on
  // the short rows' splits
  const int sp = a.n_splits - 1 - (int)blockIdx.x / bh_n;
  const int bi = bh / a.kv_heads;
  const int hk = bh % a.kv_heads;
  int len = a.lens[bi];
  const bool uniform = len <= 0;  // fill 0: equal scores over the width
  len = (uniform || len > a.width) ? a.width : len;
  const int nlive = (len + kSplitCols - 1) / kSplitCols;
  if (sp >= nlive) return stamp(5);
  const int s0 = sp * kSplitCols;
  const int s1 = min(s0 + kSplitCols, len);
  const int ntiles = (s1 - s0 + kTileRows - 1) / kTileRows;

  const C* k = static_cast<const C*>(a.k);
  const C* v = static_cast<const C*>(a.v);
  const uint32_t bars = smem_u32(smem);
  int* flag = reinterpret_cast<int*>(smem + 64);
  int* stbl = reinterpret_cast<int*>(smem + 128);  // the split's blocks
  unsigned char* ring = smem + kHeadBytes;
  const uint32_t ring_at = bars + kHeadBytes;

  // logical row j -> row index into the cache (times D for elements); the
  // copies come in pieces of whole rows that lie in one pool block, whose
  // ids the block reads once into shared memory
  const int e0 = PAGED ? s0 >> a.shift : 0;
  const int off_mask = (1 << a.shift) - 1;
  const int piece = PAGED ? min(1 << a.shift, kTileRows) : kTileRows;
  auto row_of = [&](int j) -> size_t {
    if constexpr (PAGED) {
      const size_t blk = (size_t)stbl[(j >> a.shift) - e0];
      return ((blk * a.kv_heads + hk) << a.shift) + (size_t)(j & off_mask);
    } else {
      return (size_t)bh * a.width + (size_t)j;
    }
  };
  // tile t's copies into stage t % S (one thread)
  auto issue = [&](int t) {
    const int ts = s0 + t * kTileRows;
    const int te = min(ts + kTileRows, s1);
    const uint32_t bar = bars + 8 * (t % S);
    const uint32_t dst = ring_at + (t % S) * STAGEB;
    uint32_t bytes = 0;
    for (int ps = ts; ps < te; ps += piece) {
      const int n = min(piece, te - ps);
      bytes += 2u * n * ROWB;
      if (QUANT && a.stage_scales) bytes += 8u * ((n + 3) & ~3);
    }
    mbar_expect_tx(bar, bytes);
    for (int ps = ts; ps < te; ps += piece) {
      const int n = min(piece, te - ps);
      const size_t row = row_of(ps);
      const uint32_t at = ps - ts;
      bulk_load(dst + at * ROWB, k + row * D, n * ROWB, bar);
      bulk_load(dst + TILEB + at * ROWB, v + row * D, n * ROWB, bar);
      if (QUANT && a.stage_scales) {
        const uint32_t sb = 4u * ((n + 3) & ~3);
        bulk_load(dst + 2 * TILEB + 4 * at, a.ks + row, sb, bar);
        bulk_load(dst + 2 * TILEB + 4 * (kTileRows + at), a.vs + row, sb,
                  bar);
      }
    }
  };

  if constexpr (PAGED) {
    const int* tbl = a.tables + (size_t)bi * a.n_tbl;
    for (int i = threadIdx.x; i <= ((s1 - 1) >> a.shift) - e0; i += NT)
      stbl[i] = tbl[e0 + i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if constexpr (!PAGED)  // the paged copies wait for the staged ids
      for (int t = 0; t < S && t < ntiles; ++t) issue(t);
  }
  const int set = threadIdx.x / kSetThreads;   // query rows set * GS + r
  const int lane = threadIdx.x % L;
  const int grp = (threadIdx.x % kSetThreads) / L;
  // the thread's columns: run i is columns (i * L + lane) * RUN + [0, RUN)
  float qf[GS][EPT];
  const T* q = static_cast<const T*>(a.q);
#pragma unroll
  for (int r = 0; r < GS; ++r) {
    if (set * GS + r < a.group) {
      const T* qr =
          q + ((size_t)bi * a.n_heads + hk * a.group + set * GS + r) * D;
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int c = 0; c < RUN; c += Vec16<T>::N)
          Vec16<T>::load(qr + (i * L + lane) * RUN + c, qf[r] + i * RUN + c);
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) qf[r][e] = 0.f;
    }
  }
  float m[GS], l[GS], acc[GS][EPT];
#pragma unroll
  for (int r = 0; r < GS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();  // the barriers are initialised, the block ids staged
  if (PAGED && threadIdx.x == 0)
    for (int t = 0; t < S && t < ntiles; ++t) issue(t);

  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(bars + 8 * (t % S), (t / S) & 1);
    if (t == 0) stamp(2);
    const unsigned char* stage = ring + (t % S) * STAGEB;
    const C* kt = reinterpret_cast<const C*>(stage);
    const C* vt = reinterpret_cast<const C*>(stage + TILEB);
    const float* kst = reinterpret_cast<const float*>(stage + 2 * TILEB);
    const float* vst = kst + kTileRows;
    const int n_live = min(kTileRows, s1 - (s0 + t * kTileRows));
    // only a split's last tile can hold rows past the fill: a full tile
    // skips the zeroing (a uniform branch)
    const bool full = n_live == kTileRows;
    if (QUANT && !a.stage_scales) {
      // rows not in fours: the threads load the tile's live scales into
      // the stage (its last reader passed the refill's barrier)
      float* sc = reinterpret_cast<float*>(ring + (t % S) * STAGEB + 2 * TILEB);
      for (int i = threadIdx.x; i < n_live; i += NT) {
        const size_t at = row_of(s0 + t * kTileRows + i);
        sc[i] = __ldg(a.ks + at);
        sc[kTileRows + i] = __ldg(a.vs + at);
      }
      __syncthreads();
    }

    // scores; every thread of a warp runs every u, so the shuffles see the
    // whole warp
    float s[U][GS];
    float vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = u * NGRP + grp;
      const bool live = row < n_live;
      float kf[EPT];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        load_run<C, RUN>(kt + row * D + (i * L + lane) * RUN, kf + i * RUN);
      if (!full && !live) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) kf[e] = 0.f;
      }
      float ksc = 1.f;
      vsc[u] = 0.f;
      if constexpr (QUANT) {
        ksc = (full || live) ? kst[row] : 0.f;
        vsc[u] = (full || live) ? vst[row] : 0.f;
      }
      // the GS partial dot products (two chains of FMAs each), summed
      // over the L lanes by a transposing butterfly: while a lane holds
      // several, each level sends half of them and keeps the other half,
      // so row r's sum ends in the lanes whose level bits spell r, and
      // comes back from there (GS = 4, L = 16: 9 shuffles, not 16)
      float v[GS];
#pragma unroll
      for (int r = 0; r < GS; ++r) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; e += 2) {
          p0 = fmaf(qf[r][e], kf[e], p0);
          p1 = fmaf(qf[r][e + 1], kf[e + 1], p1);
        }
        v[r] = p0 + p1;
      }
      int c = GS;
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        if (c > 1) {
          const int half = c / 2;
          const bool up = (lane & off) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? v[i] : v[i + half];
            const float keep = up ? v[i + half] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
          c = half;
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
        }
      }
#pragma unroll
      for (int r = 0; r < GS; ++r) {
        float part = v[0];
        if constexpr (GS > 1) {
          int src = threadIdx.x % 32 - lane;  // the lane group's first lane
#pragma unroll
          for (int bit = GS / 2, off = L / 2; bit > 0; bit >>= 1, off >>= 1)
            if (r & bit) src += off;
          part = __shfl_sync(0xffffffffu, v[0], src);
        }
        const float sc = QUANT ? part * ksc * a.scale : part * a.scale;
        s[u][r] = live ? (uniform ? 0.f : sc) : -INFINITY;
      }
    }
    // online softmax; s becomes the probabilities (times the v scales)
    float alpha[GS];
#pragma unroll
    for (int r = 0; r < GS; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      if (mx == -INFINITY) {  // nothing live yet in this group
        alpha[r] = 1.f;
#pragma unroll
        for (int u = 0; u < U; ++u) s[u][r] = 0.f;
        continue;
      }
      alpha[r] = __expf(m[r] - mx);  // exp(-inf) = 0 on the first hit
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = __expf(s[u][r] - mx);
        psum += p;
        s[u][r] = QUANT ? p * vsc[u] : p;  // dequantize V rows
      }
      l[r] = l[r] * alpha[r] + psum;
      m[r] = mx;
    }
#pragma unroll
    for (int r = 0; r < GS; ++r)
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[r][e] *= alpha[r];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = u * NGRP + grp;
      const bool live = row < n_live;
      float vf[EPT];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        load_run<C, RUN>(vt + row * D + (i * L + lane) * RUN, vf + i * RUN);
      if (!full && !live) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) vf[e] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < GS; ++r)
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          acc[r][e] = fmaf(s[u][r], vf[e], acc[r][e]);
    }
    if (t + S < ntiles) {  // the stage is free: refill it
      __syncthreads();
      if (threadIdx.x == 0) issue(t + S);
    }
  }

  stamp(3);
  // the warp's lane groups merge by shuffles into its first group
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < GS; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], m2);
      const float a1 = mn == -INFINITY ? 0.f : __expf(m[r] - mn);
      const float a2 = mn == -INFINITY ? 0.f : __expf(m2 - mn);
      l[r] = fmaf(l2, a2, l[r] * a1);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float o2 = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = fmaf(o2, a2, acc[r][e] * a1);
      }
      m[r] = mn;
    }
  }
  __syncthreads();  // every warp is done with the ring: it takes the states
  // [warp][GS] m and l, [warp][GS][D] acc; warp w holds rows of set w / 8
  constexpr int NW = NT / 32;
  float* wm = reinterpret_cast<float*>(ring);
  float* wl = wm + NW * GS;
  float* wo = wl + NW * GS;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < L) {
#pragma unroll
    for (int r = 0; r < GS; ++r) {
      if (lane == 0) {
        wm[warp * GS + r] = m[r];
        wl[warp * GS + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int c = 0; c < RUN; c += 4)
          *reinterpret_cast<float4*>(wo + (warp * GS + r) * D
                                     + (i * L + lane) * RUN + c) =
              make_float4(acc[r][i * RUN + c], acc[r][i * RUN + c + 1],
                          acc[r][i * RUN + c + 2], acc[r][i * RUN + c + 3]);
    }
  }
  __syncthreads();

  // each row's set's warps in warp order: the output, or the split's
  // partial
  T* out = static_cast<T*>(a.out);
  const bool direct = nlive == 1;
  const size_t n_o = (size_t)bh_n * a.n_splits * a.group * D;
  float* pml = a.part + n_o;   // [.., group] x (m, l)
  for (int p = threadIdx.x; p < a.group * D; p += NT) {
    const int rq = p / D;
    const int col = p % D;
    const int w0 = rq / GS * kWarps;
    const int r = rq % GS;
    float mt = -INFINITY;
#pragma unroll
    for (int w = w0; w < w0 + kWarps; ++w) mt = fmaxf(mt, wm[w * GS + r]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = w0; w < w0 + kWarps; ++w) {
      const float mw = wm[w * GS + r];
      if (mw == -INFINITY) continue;
      const float e = __expf(mw - mt);
      lt = fmaf(wl[w * GS + r], e, lt);
      o = fmaf(wo[(w * GS + r) * D + col], e, o);
    }
    if (direct) {
      out[((size_t)bi * a.n_heads + hk * a.group + rq) * D + col] =
          static_cast<T>(lt > 0.f ? o / lt : 0.f);
    } else {
      const size_t at = ((size_t)bh * a.n_splits + sp) * a.group + rq;
      a.part[at * D + col] = o;
      if (col == 0) {
        pml[2 * at] = mt;
        pml[2 * at + 1] = lt;
      }
    }
  }
  stamp(4);
  if (direct) return stamp(5);

  // announce the partial (the barrier makes the block's stores thread
  // 0's, its release publishes them); the last arriver merges the splits
  // in order, its loads after its acquire
  __syncthreads();
  if (threadIdx.x == 0) *flag = ticket_add(a.tickets + bh) == nlive - 1;
  __syncthreads();
  if (!*flag) return stamp(5);
  // every split's (m, l) staged at once, then each row's weights and
  // total in split order, then each output column over the splits
  const size_t at0 = (size_t)bh * a.n_splits * a.group;
  float* sw = reinterpret_cast<float*>(ring);   // [nlive][G] m, then w
  float* sl = sw + nlive * G;                   // [nlive][G] l
  float* st = sl + nlive * G;                   // [G] the rows' totals
  for (int p = threadIdx.x; p < nlive * a.group; p += NT) {
    const int sp2 = p / a.group;
    const int rq = p % a.group;
    const size_t at = at0 + p;
    sw[sp2 * G + rq] = __ldcg(pml + 2 * at);
    sl[sp2 * G + rq] = __ldcg(pml + 2 * at + 1);
  }
  __syncthreads();
  if (threadIdx.x < a.group) {
    const int rq = threadIdx.x;
    float mt = -INFINITY;
    for (int sp2 = 0; sp2 < nlive; ++sp2) mt = fmaxf(mt, sw[sp2 * G + rq]);
    float lt = 0.f;
    for (int sp2 = 0; sp2 < nlive; ++sp2) {
      const float ms = sw[sp2 * G + rq];
      const float w = ms == -INFINITY ? 0.f : __expf(ms - mt);
      sw[sp2 * G + rq] = w;
      lt = fmaf(sl[sp2 * G + rq], w, lt);
    }
    st[rq] = lt;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < a.group * D; p += NT) {
    const int rq = p / D;
    const int col = p % D;
    const float* src = a.part + (at0 + rq) * D + col;
    float o = 0.f;
#pragma unroll 4
    for (int sp2 = 0; sp2 < nlive; ++sp2)
      o = fmaf(__ldcg(src + (size_t)sp2 * a.group * D), sw[sp2 * G + rq], o);
    const float lt = st[rq];
    out[((size_t)bi * a.n_heads + hk * a.group + rq) * D + col] =
        static_cast<T>(lt > 0.f ? o / lt : 0.f);
  }
  if (threadIdx.x == 0) a.tickets[bh] = 0;
  stamp(5);
}

// One entry point per family member, so a profile tells them apart.
template <typename T, int D, int G>
__global__ void __launch_bounds__(FD_BLOCK(G), FD_MIN_BLOCKS(G))
    flash_decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  decode_body<T, T, D, G, false>(a, smem);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(FD_BLOCK(G), FD_MIN_BLOCKS(G))
    flash_decode_int8_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  decode_body<T, int8_t, D, G, false>(a, smem);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(FD_BLOCK(G), FD_MIN_BLOCKS(G))
    flash_decode_paged_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  decode_body<T, T, D, G, true>(a, smem);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(FD_BLOCK(G), FD_MIN_BLOCKS(G))
    flash_decode_paged_int8_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  decode_body<T, int8_t, D, G, true>(a, smem);
}

template <typename T, int D, int G, bool QUANT, bool PAGED>
cudaError_t launch_one(const Args& a, cudaStream_t s) {
  using C = typename std::conditional<QUANT, int8_t, T>::type;
  using Gm = Geo<C, D, G>;
  constexpr int smem = Gm::kSmem;
  if (a.n_splits > Gm::kMaxSplits) return cudaErrorInvalidValue;
  void (*kern)(Args);
  if constexpr (!QUANT && !PAGED) kern = flash_decode_kernel<T, D, G>;
  else if constexpr (QUANT && !PAGED) kern = flash_decode_int8_kernel<T, D, G>;
  else if constexpr (!QUANT && PAGED) kern = flash_decode_paged_kernel<T, D, G>;
  else kern = flash_decode_paged_int8_kernel<T, D, G>;
  if constexpr (smem > 48 * 1024) {  // opt in once a device
    static unsigned long long opted = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && !(opted >> dev & 1ull)) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      opted |= 1ull << dev;
    }
  }
  kern<<<dim3(a.rows * a.kv_heads * a.n_splits), Gm::kBlock, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool QUANT, bool PAGED>
cudaError_t launch_g(const Args& a, cudaStream_t s) {
  if (a.group <= 1) return launch_one<T, D, 1, QUANT, PAGED>(a, s);
  if (a.group <= 2) return launch_one<T, D, 2, QUANT, PAGED>(a, s);
  if (a.group <= 4) return launch_one<T, D, 4, QUANT, PAGED>(a, s);
  if (a.group <= 8) return launch_one<T, D, 8, QUANT, PAGED>(a, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The checks the copies rely on, then the launch; reports the body.
template <bool QUANT, bool PAGED>
int launch(Args a, int d, int dtype, long long n_part, cudaStream_t s,
           int* body) {
  if (a.rows <= 0 || a.kv_heads <= 0 || a.width <= 0 || a.group <= 0)
    return cudaErrorInvalidValue;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v))
    return cudaErrorMisalignedAddress;
  if (QUANT) {
    // a tile's scales go with its bulk copies in whole 16-byte pieces
    // where the rows (max_len, or the pool block) come in fours from
    // 16-byte aligned scales; else the threads load them one by one
    const int rows_of = PAGED ? (1 << a.shift) : a.width;
    a.stage_scales =
        aligned16(a.ks) && aligned16(a.vs) && rows_of % 4 == 0;
  }
  a.n_splits = (a.width + kSplitCols - 1) / kSplitCols;
  if (a.n_splits > 1 &&
      (a.part == nullptr || a.tickets == nullptr ||
       n_part < (long long)a.rows * a.n_heads * a.n_splits * (d + 2)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
#define FD_D(T)                                                           \
  if (d == 64) err = launch_g<T, 64, QUANT, PAGED>(a, s);                 \
  else if (d == 128) err = launch_g<T, 128, QUANT, PAGED>(a, s);          \
  break
  switch (dtype) {
    case kFloat32: FD_D(float);
    case kBFloat16: FD_D(__nv_bfloat16);
    case kFloat16: FD_D(__half);
  }
#undef FD_D
  return ran(err, kBodySplit, body);
}

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* lens, const void* tables,
               void* out, void* part, void* tickets, int b, int n_heads,
               int kv_heads, int width, int n_tbl, int shift, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.lens = static_cast<const int*>(lens);
  a.tables = static_cast<const int*>(tables);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.rows = b;
  a.n_heads = n_heads;
  a.kv_heads = kv_heads;
  a.width = width;
  a.n_tbl = n_tbl;
  a.shift = shift;
  a.group = kv_heads > 0 ? n_heads / kv_heads : 0;
  a.n_splits = 0;
  a.stage_scales = false;
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
// [b] (rows to attend, the new token included).  part is fp32 scratch of
// n_part >= b * n_heads * n_splits * (d + 2) floats and tickets int32 [b *
// kv_heads] zeros (left zero), where n_splits = ceil(width /
// flash_decode_split_cols()) > 1; both may be null when it is 1.  Each
// returns the launch's cudaError_t (0 = launched) and sets *body to
// kBodySplit when the launch went out.

#ifdef FD_STAMPS
// the stamps' buffer ([grid][kStampSlots] u64 on the device, or null)
extern "C" int flash_decode_stamps(void* p) {
  return cudaMemcpyToSymbol(g_fd_stamps, &p, sizeof(p));
}
#endif

// the columns a block walks (kernels/flash_decode.py mirrors it)
extern "C" int flash_decode_split_cols() { return kSplitCols; }

// K8: k/v [b, kv_heads, max_len, d] in q's dtype.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, void* part,
                                   void* tickets, int b, int n_heads,
                                   int kv_heads, int max_len, int d,
                                   float scale, int dtype, long long n_part,
                                   void* stream, int* body) {
  if (!heads_ok(n_heads, kv_heads)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, nullptr, nullptr, lens, nullptr, out,
                           part, tickets, b, n_heads, kv_heads, max_len, 0, 0,
                           scale);
  return launch<false, false>(a, d, dtype, n_part,
                              static_cast<cudaStream_t>(stream), body);
}

// K9: kq/vq int8 [b, kv_heads, max_len, d], ks/vs fp32 [b, kv_heads,
// max_len].
extern "C" int flash_decode_int8_launch(const void* q, const void* kq,
                                        const void* ks, const void* vq,
                                        const void* vs, const void* lens,
                                        void* out, void* part, void* tickets,
                                        int b, int n_heads, int kv_heads,
                                        int max_len, int d, float scale,
                                        int dtype, long long n_part,
                                        void* stream, int* body) {
  if (!heads_ok(n_heads, kv_heads)) return cudaErrorInvalidValue;
  const Args a = make_args(q, kq, vq, ks, vs, lens, nullptr, out, part,
                           tickets, b, n_heads, kv_heads, max_len, 0, 0,
                           scale);
  return launch<true, false>(a, d, dtype, n_part,
                             static_cast<cudaStream_t>(stream), body);
}

// K10: k/v pools [n_blocks, kv_heads, block, d] in q's dtype, tables int32
// [b, n_tbl]; block a power of two.
extern "C" int flash_decode_paged_launch(const void* q, const void* k,
                                         const void* v, const void* lens,
                                         const void* tables, void* out,
                                         void* part, void* tickets, int b,
                                         int n_heads, int kv_heads, int block,
                                         int n_tbl, int d, float scale,
                                         int dtype, long long n_part,
                                         void* stream, int* body) {
  const int shift = block_shift(block);
  if (!heads_ok(n_heads, kv_heads) || shift < 0 || n_tbl <= 0)
    return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, nullptr, nullptr, lens, tables, out,
                           part, tickets, b, n_heads, kv_heads, n_tbl * block,
                           n_tbl, shift, scale);
  return launch<false, true>(a, d, dtype, n_part,
                             static_cast<cudaStream_t>(stream), body);
}

// K11: kq/vq int8 pools [n_blocks, kv_heads, block, d], ks/vs fp32
// [n_blocks, kv_heads, block], tables int32 [b, n_tbl]; block a power of
// two.
extern "C" int flash_decode_paged_int8_launch(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* lens, const void* tables, void* out,
    void* part, void* tickets, int b, int n_heads, int kv_heads, int block,
    int n_tbl, int d, float scale, int dtype, long long n_part, void* stream,
    int* body) {
  const int shift = block_shift(block);
  if (!heads_ok(n_heads, kv_heads) || shift < 0 || n_tbl <= 0)
    return cudaErrorInvalidValue;
  const Args a = make_args(q, kq, vq, ks, vs, lens, tables, out, part,
                           tickets, b, n_heads, kv_heads, n_tbl * block,
                           n_tbl, shift, scale);
  return launch<true, true>(a, d, dtype, n_part,
                            static_cast<cudaStream_t>(stream), body);
}
