// Flash-decode attention for Hopper (sm_90a): the kernels shared by the
// paged (flash_decode.cu) and the contiguous (flash_decode_contig.cu) entry
// points.  Each source instantiates the
// templates for its own row addressing, so the two compile in parallel.
//
// Replaces src/repro/kernels/flash_decode.py:183 (paged_flash_decode_pallas)
// and src/repro/kernels/flash_decode.py:75 (flash_decode_pallas).
//
// out[b, hq] = softmax_t(softcap(scale * q[b, hq] . K[b, t])) V[b, t] over
// the slot's tokens t < length; query head hq reads kv head hq / g (GQA).
//
// What bounds it on the card: device-memory bytes.  Every K/V element the
// slot holds is read once per decode step for one multiply-add per query
// head of its group (g = 4 for Mixtral and Granite), far below the card's
// ridge point: at 4096 tokens x 8 kv heads x 128 dims a slot streams 16 MB
// of bf16 K/V for ~17 MFLOP.  So the design keeps many bytes in flight on
// every SM, and spends as few instructions per byte as it can.
//
// bf16 K/V (every serving path): ring_decode_kernel, warp-specialised.
//   * One block per (slot, kv head, split) covers the g query heads of that
//     kv head, so each K/V row leaves device memory once per GQA group, and
//     only rows below the length are read.  Splits are sized from the
//     runtime's occupancy report (2 blocks per SM at hd 128, 3 at hd 64),
//     so the grid is one wave of long blocks (8 tiles at 4 x 4096 tokens).
//   * Two producer warps fill a ring of kStages stages of 64-token K and V
//     tiles in shared memory, each stage with a full and an empty mbarrier.
//     A lane copies 16-byte pieces with cp.async (rows at a +16-byte
//     stride, so ldmatrix is free of bank conflicts) and its
//     cp.async.mbarrier.arrive completes the stage's full barrier.  A paged
//     tile's page ids are loaded a tile ahead, a lane per page, and reach
//     the rows by shuffles.  Rows of a tile past the split's end repeat its
//     last row: their weight is 0, and a repeated row is finite where stale
//     shared memory or a pool row past the length may hold NaN.  Measured
//     on the H100: one bulk copy per row (cp.async.bulk ... complete_tx)
//     was TMA-issue-bound, ~0.065 ms for (c)'s loads alone against
//     cp.async's ~0.052, and a 16 KB bulk copy per tile (what a TMA tensor
//     map would give, at the cost of a map per pool and psz % 16 == 0) was
//     no faster than cp.async end to end; one producer warp could not keep
//     up with the paged lookups.
//   * Four consumer warps: warp w owns tokens [16w, 16w + 16) of every tile
//     and keeps its own running (m, l, o) per head, so no block barrier sits
//     in the main loop.  Both products run on tensor cores (mma.sync
//     m16n8k16, bf16 in, float32 accumulate):
//       q.k  S (heads x 8 tokens) = Q (heads padded to 16 x 16 dims) K^T,
//            A = q held in registers for the block, B = K rows by ldmatrix.
//            Its accumulator fragment is the B fragment of P.V below, so P
//            needs no cross-lane transpose (the "swapped" q.k with tokens
//            as M would use half the MMAs, but the tensor pipe is far from
//            busy at the bytes bound and P would need 8 shuffles per 16
//            tokens).
//       P.V  O^T (16 dims x 8 heads) = V^T (16 dims x 16 tokens) P^T,
//            A = V by ldmatrix.trans, B = P^T from the q.k accumulators.
//     Scale, softcap (before the mask), the log2 domain and the online
//     rescale stay in float32 registers.
//   * Precision (the card's checks hold rtol 1e-4 / atol 1e-4): bf16 q x bf16
//     K is exact per product.  P is split into hi = bf16(p) and lo = bf16(p -
//     hi), two MMAs per V sub-tile (error ~2^-17 of p; bf16 P alone, 2^-9,
//     fails at short lengths).  A float32 q is split the same way (two q.k
//     MMAs).  l sums hi + lo.
//   * After the last tile the consumer warps' (m, l, o) are merged in warp
//     order; a split writes o / max(l, 1e-30) when it is the only one, else
//     (o, m, l) partials for pass 2.
//   * A paged block checks its 1/splits share of the slot's table row, and
//     the producers every page id they read: an id outside 0..P-1 anywhere
//     in the row aborts the kernel (__trap), as the plain version raises.
//
// The previous design (v6) ran 32-token cp.async tiles through load ->
// wait -> compute with four block barriers per tile and CUDA-core FMAs at 8
// blocks per SM: nothing in flight while a block computed, ~6 instructions
// per element; it was left at ~half the bytes bound.  Float32 K/V (no serving path keeps a
// float32 cache) keep v6's body, decode_kernel, chosen by the K/V type at
// compile time (tensor-core float32 would need a 3-way split).
//
// Pass 2, split_combine_kernel, when there are splits: a block per output
// row adds the partials in a fixed order, launched as a programmatic
// dependent of pass 1 (its blocks start as pass-1 blocks leave, with no
// second launch gap; a combine fused into pass 1, by the last split's
// block, was slower: one SM read all of a slot's partials).  No float
// atomics anywhere: the result is the same on every run.
//
// Row addressing (the PAGED template argument):
//   paged       token t of slot b is row t % psz of physical page
//               table[b, t / psz] of a (P, psz, Hkv, hd) pool; length 0
//               gives exact zeros.
//   contiguous  token t of slot b is row b * S + t of a (B, S, Hkv, hd)
//               cache; splits run over psz-token units of it.  Length 0
//               (or below) masks every row, and the JAX oracle then weighs
//               all S rows alike: such a row takes every row of the cache
//               with logit 0, the mean of V.  A length past S reads S rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  int q_bf16;
  const void* pk;   // paged: (P, psz, Hkv, hd) pool; contiguous: (B, S, Hkv, hd)
  const void* pv;
  const int* table;     // paged only: (B, maxp)
  const int* lengths;
  float* out;
  float* o_part;    // (B * Hq, splits, HD) when splits > 1
  float* ml_part;   // (B * Hq, splits, 2): m (log2 domain), l
  int B, Hq, Hkv, num_pages, psz, maxp, splits;
  int S;            // contiguous only: cache rows per slot
  float scale, softcap;
};

// The slot's token range [t0, t1) of this split; `uniform` marks a
// contiguous slot of length <= 0 (every row, logit 0).
template <bool PAGED>
__device__ __forceinline__ void split_range(const Args& a, int b, int split, int& t0, int& t1,
                                            bool& uniform) {
  int len;
  uniform = false;
  if constexpr (PAGED) {
    len = max(0, min(a.lengths[b], a.maxp * a.psz));
  } else {
    len = min(a.lengths[b], a.S);
    if (len <= 0) {
      len = a.S;
      uniform = true;
    }
  }
  // ceil(pages / splits) pages per split: when the wrapper's split count
  // over-fills the card's resident slots, the last splits are empty and end
  // at once, so the grid stays one wave
  const int npages = (len + a.psz - 1) / a.psz;
  const int chunk = (npages + a.splits - 1) / a.splits;
  t0 = min(split * chunk * a.psz, len);
  t1 = min((split + 1) * chunk * a.psz, len);
}

// ===========================================================================
// bf16 K/V: the warp-specialised ring kernel
// ===========================================================================
constexpr int kTile = 64;              // tokens per ring stage
constexpr int kConsumers = 4;          // consumer warps, 16 tokens of a tile each
constexpr int kWarpTok = kTile / kConsumers;
constexpr int kProducers = 2;          // producer warps, kTile / kProducers rows each
constexpr int kRingThreads = 32 * (kConsumers + kProducers);

template <int HD>
struct Ring {
  static constexpr int kRowBytes = HD * 2;                 // one bf16 row
  static constexpr int kRow = kRowBytes + 16;              // padded stride
  static constexpr int kTileBytes = kTile * kRow;
  static constexpr int kStages = HD >= 128 ? 3 : 4;        // 2 / 3 blocks per SM
  static constexpr int kStageBytes = 2 * kTileBytes;       // K tile, then V tile
  static constexpr int kBars = kStages * kStageBytes;      // full[], then empty[]
  static constexpr int kBytes = kBars + 2 * 8 * kStages;
};

// Pass 1 (bf16 K/V): block (b * Hkv + h, split) of kRingThreads threads ->
// the g query heads of kv head h over the split's share of the slot's tokens.
template <int G, int HD, bool PAGED>
__global__ void __launch_bounds__(kRingThreads, HD >= 128 ? 2 : 3)
    ring_decode_kernel(const Args a) {
  using R = Ring<HD>;
  constexpr int KC = HD / 16;          // 16-dim chunks (q.k k-steps, P.V m-tiles)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + R::kBars;
  const uint32_t empty = full + 8 * R::kStages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;

  griddep_launch_dependents();
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 32 * kProducers);   // a cp.async arrival per producer lane
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int t0, t1;
  bool uniform;
  split_range<PAGED>(a, b, split, t0, t1, uniform);

  const __nv_bfloat16* pk = reinterpret_cast<const __nv_bfloat16*>(a.pk);
  const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(a.pv);
  const size_t row_stride = (size_t)a.Hkv * HD;     // elements between tokens
  const size_t col = (size_t)h * HD;

  // m, l of head g (lanes 4g .. 4g + 3 hold the same) and O^T fragments:
  // o[i] = dims 16i + g (0, 1) and 16i + g + 8 (2, 3), heads 2 t4 and 2 t4 + 1
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float m = kNeg, l = 0.f;
  float o[KC][4];
#pragma unroll
  for (int i = 0; i < KC; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  if (warp >= kConsumers) {
    // ---- producer ----
    const int* trow = PAGED ? a.table + (size_t)b * a.maxp : nullptr;
    // lane = 16-byte piece `piece` of rows rlane, rlane + kRowsPer, ... of
    // this warp's kTile / kProducers rows of each tile
    constexpr int kPieces = R::kRowBytes / 16;
    constexpr int kRowsPer = 32 / kPieces;
    const int piece = lane % kPieces;
    const int rlane = (warp - kConsumers) * (kTile / kProducers) + lane / kPieces;
    const int rend = rlane - lane / kPieces + kTile / kProducers;
    const int pshift = (a.psz & (a.psz - 1)) == 0 ? __ffs(a.psz) - 1 : -1;
    // paged: lane i holds the ids of a tile's pages pg0 + i and pg0 + 32 + i
    // (a tile spans at most 64 pages), loaded one tile ahead
    auto page_ids = [&](int tt, int& pg0, int& ida, int& idb) {
      ida = idb = 0;
      if (tt >= t1) return;
      pg0 = tt / a.psz;
      const int pgl = (min(tt + kTile, t1) - 1) / a.psz;
      if (pg0 + lane <= pgl) ida = __ldg(trow + pg0 + lane);
      if (pg0 + 32 + lane <= pgl) idb = __ldg(trow + pg0 + 32 + lane);
    };
    int pg0 = 0, pid_a = 0, pid_b = 0;
    // this block's share of the whole table row: loaded now, checked after
    // the last tile (the pages read are checked before their copies)
    const int share = (a.maxp + a.splits - 1) / a.splits;
    const int e0 = split * share + lane;
    const int e1 = min(a.maxp, (split + 1) * share);
    int own = 0;
    if constexpr (PAGED) {
      if (e0 < e1) own = __ldg(trow + e0);
      page_ids(t0, pg0, pid_a, pid_b);
    }
    int stage = 0;
    uint32_t parity = 1;        // a fresh ring is empty: the first waits pass
    for (int tt = t0; tt < t1; tt += kTile) {
      int next0 = 0, next_a = 0, next_b = 0;
      if constexpr (PAGED) {
        if ((unsigned)pid_a >= (unsigned)a.num_pages || (unsigned)pid_b >= (unsigned)a.num_pages)
          __trap();
        page_ids(tt + kTile, next0, next_a, next_b);
      }
      mbar_wait(empty + 8 * stage, parity);
      const uint32_t ks = ring + stage * R::kStageBytes + piece * 16;
#pragma unroll 4
      for (int r = rlane; r < rend; r += kRowsPer) {
        const int t = min(tt + r, t1 - 1);      // rows past t1 repeat the last
        size_t at;
        if constexpr (PAGED) {
          const int pg = pshift >= 0 ? t >> pshift : t / a.psz;
          const int i = pg - pg0;
          const int pa = __shfl_sync(0xffffffffu, pid_a, i & 31);
          const int pb = __shfl_sync(0xffffffffu, pid_b, i & 31);
          at = ((size_t)(i < 32 ? pa : pb) * a.psz + (t - pg * a.psz)) * row_stride + col;
        } else {
          at = ((size_t)b * a.S + t) * row_stride + col;
        }
        cp_async16(ks + r * R::kRow, reinterpret_cast<const unsigned char*>(pk + at) + piece * 16);
        cp_async16(ks + R::kTileBytes + r * R::kRow,
                   reinterpret_cast<const unsigned char*>(pv + at) + piece * 16);
      }
      cp_async_arrive(full + 8 * stage);
      pg0 = next0;
      pid_a = next_a;
      pid_b = next_b;
      if (++stage == R::kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    if constexpr (PAGED) {
      if ((unsigned)own >= (unsigned)a.num_pages) __trap();
      for (int i = e0 + 32; i < e1; i += 32)
        if ((unsigned)trow[i] >= (unsigned)a.num_pages) __trap();
    }
  } else {
    // ---- consumers ----
    // q as the A operand of q.k: rows = heads (g < G live, the rest zero),
    // a0 = dims 16c + 2 t4 (+1), a2 = dims 16c + 8 + 2 t4 (+1); hi and lo
    // parts (lo is zero for a bf16 q)
    uint32_t qh[KC][2], ql[KC][2];
    {
      const size_t q0 = ((size_t)b * a.Hq + h * G + g) * HD;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat16 hi[2], lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 16 * c + 8 * half + 2 * t4 + e;
            float x = 0.f;
            if (g < G) {
              x = a.q_bf16 ? __bfloat162float(
                                 reinterpret_cast<const __nv_bfloat16*>(a.q)[q0 + d])
                           : reinterpret_cast<const float*>(a.q)[q0 + d];
            }
            split2(x, hi[e], lo[e]);
          }
          qh[c][half] = pack2(hi[0], hi[1]);
          ql[c][half] = pack2(lo[0], lo[1]);
        }
      }
    }
    const bool q_lo = !a.q_bf16;
    // ldmatrix lane address: row (lane & 7) + 8 (lane >> 4), dims + 8 ((lane >> 3) & 1)
    const uint32_t lm = ((lane & 7) + 8 * (lane >> 4)) * R::kRow + 16 * ((lane >> 3) & 1);
    const int r0 = warp * kWarpTok;
    int stage = 0;
    uint32_t parity = 0;
    for (int tt = t0; tt < t1; tt += kTile) {
      const int nt = min(kTile, t1 - tt);
      mbar_wait(full + 8 * stage, parity);
      if (r0 < nt) {
        const uint32_t ks = ring + stage * R::kStageBytes + r0 * R::kRow + lm;
        const uint32_t vs = ks + R::kTileBytes;
        // q.k: s[n] = heads g x tokens 8n + 2 t4 (+1) of this warp's 16
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          uint32_t kb[4];
          ldsm_x4(ks + 32 * c, kb);
          mma_bf16(s[0], qh[c][0], 0u, qh[c][1], 0u, kb[0], kb[1]);
          mma_bf16(s[1], qh[c][0], 0u, qh[c][1], 0u, kb[2], kb[3]);
          if (q_lo) {
            mma_bf16(s[0], ql[c][0], 0u, ql[c][1], 0u, kb[0], kb[1]);
            mma_bf16(s[1], ql[c][0], 0u, ql[c][1], 0u, kb[2], kb[3]);
          }
        }
        // online softmax of head g over its 4 tokens, then the quad
        float x[4] = {s[0][0], s[0][1], s[1][0], s[1][1]};
        bool valid[4];
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tok = r0 + 8 * (j >> 1) + 2 * t4 + (j & 1);
          float v = x[j] * a.scale;
          if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
          valid[j] = g < G && tok < nt;
          x[j] = valid[j] ? (uniform ? 0.f : v * kLog2e) : kNeg;
          mx = fmaxf(mx, x[j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m, mx);
        const float corr = exp2f(m - mn);
        __nv_bfloat16 ph[4], pl[4];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split2(valid[j] ? exp2f(x[j] - mn) : 0.f, ph[j], pl[j]);
          sum += __bfloat162float(ph[j]) + __bfloat162float(pl[j]);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l = l * corr + sum;
        m = mn;
        // rescale O's columns (heads 2 t4, 2 t4 + 1: lanes 8 t4, 8 t4 + 4)
        const float ca = __shfl_sync(0xffffffffu, corr, 8 * t4);
        const float cb = __shfl_sync(0xffffffffu, corr, 8 * t4 + 4);
        // P^T as the B operand: tokens 2 t4 (+1) and 8 + 2 t4 (+1), head g
        const uint32_t bh0 = pack2(ph[0], ph[1]), bh1 = pack2(ph[2], ph[3]);
        const uint32_t bl0 = pack2(pl[0], pl[1]), bl1 = pack2(pl[2], pl[3]);
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          o[i][0] *= ca;
          o[i][1] *= cb;
          o[i][2] *= ca;
          o[i][3] *= cb;
          uint32_t va[4];
          ldsm_x4_t(vs + 32 * i, va);
          mma_bf16(o[i], va[0], va[1], va[2], va[3], bh0, bh1);
          mma_bf16(o[i], va[0], va[1], va[2], va[3], bl0, bl1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == R::kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
  }

  // ---- merge the consumer warps in warp order (the ring is free now) ----
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);             // [warp][G][HD]
  float* mls = red + kConsumers * G * HD;                   // [warp][G] (m, l)
  if (warp < kConsumers) {
#pragma unroll
    for (int i = 0; i < KC; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hh = 2 * t4 + e;
        if (hh < G) {
          float* dst = red + (warp * G + hh) * HD + 16 * i + g;
          dst[0] = o[i][e];
          dst[8] = o[i][2 + e];
        }
      }
    }
    if (t4 == 0 && g < G) {
      mls[2 * (warp * G + g)] = m;
      mls[2 * (warp * G + g) + 1] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kRingThreads) {
    const int gi = i / HD;
    const int d = i % HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, mls[2 * (w * G + gi)]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float c = exp2f(mls[2 * (w * G + gi)] - mx);
      acc = fmaf(red[(w * G + gi) * HD + d], c, acc);
      sum = fmaf(mls[2 * (w * G + gi) + 1], c, sum);
    }
    const size_t row = (size_t)b * a.Hq + h * G + gi;
    if (a.splits == 1) {
      a.out[row * HD + d] = acc / fmaxf(sum, 1e-30f);
    } else {
      const size_t at = row * a.splits + split;
      a.o_part[at * HD + d] = acc;
      if (d == 0) {
        a.ml_part[2 * at] = mx;
        a.ml_part[2 * at + 1] = sum;
      }
    }
  }
}

// ===========================================================================
// float32 K/V: v6 (32-token cp.async tiles, CUDA-core float32 FMAs)
// ===========================================================================
constexpr int kTok = 32;        // tokens per tile: one per lane in q.k

constexpr int kQuarters = 4;   // token groups of P.V

template <int G, int HD>
struct Smem {
  static constexpr int kRow = HD * 4 + 16;                 // padded row bytes
  static constexpr int kWarps = HD / 32;
  static constexpr int kv = 0;                             // K rows, then V rows
  static constexpr int q = kv + 2 * kTok * kRow;            // float [G][HD]
  static constexpr int part = q + 4 * G * HD;               // float [warps][G][kTok]
  static constexpr int p = part + 4 * kWarps * G * kTok;    // float [kTok][G]
  static constexpr int stats = p + 4 * kTok * G;            // float corr[G], m[G], l[G]
  static constexpr int table = stats + 4 * 3 * G;           // int [maxp] (paged)
  static int bytes(int table_rows) { return table + 4 * table_rows; }
};

// Pass 1 (float32 K/V): block (b * Hkv + h, split), HD threads -> the g
// query heads of kv head h over the split's share of the slot's tokens.
// q.k: lane = token, warp = a 32-wide slice of hd, q broadcast from shared
// memory; one online softmax per head (a warp per head); P.V: a thread holds
// 4 output columns of all g heads over a quarter of the tile's tokens.
template <int G, int HD, bool PAGED>
__global__ void __launch_bounds__(HD, 1024 / HD) decode_kernel(const Args a) {
  using L = Smem<G, HD>;
  constexpr int W = L::kWarps;
  constexpr int kChunks = HD * 4 / 16;                     // 16-byte pieces per row
  constexpr int kRowsPerPass = HD / kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv = smem + L::kv;
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* part = reinterpret_cast<float*>(smem + L::part);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* cs = reinterpret_cast<float*>(smem + L::stats);
  int* tab = reinterpret_cast<int*>(smem + L::table);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;

  griddep_launch_dependents();
  if constexpr (PAGED) {
    const int* trow = a.table + (size_t)b * a.maxp;
    for (int i = tid; i < a.maxp; i += HD) {
      const int pid = trow[i];
      if ((unsigned)pid >= (unsigned)a.num_pages) __trap();
      tab[i] = pid;
    }
  }
  const size_t q0 = ((size_t)b * a.Hq + h * G) * HD;     // heads h*G .. h*G+G-1
  for (int i = tid; i < G * HD; i += HD) {
    qs[i] = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[q0 + i])
                     : reinterpret_cast<const float*>(a.q)[q0 + i];
  }
  __syncthreads();

  int t0, t1;
  bool uniform;
  split_range<PAGED>(a, b, split, t0, t1, uniform);

  // P.V ownership: columns [4 * cg, 4 * cg + 4), tokens tg, tg + 4, ...
  constexpr int kGroups = HD / 4;
  const int cg = tid % kGroups;
  const int tg = tid / kGroups;
  float o[G][4], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[gi][c] = 0.f;
    m[gi] = kNeg;
    l[gi] = 0.f;
  }
  const float* pk = reinterpret_cast<const float*>(a.pk);
  const float* pv = reinterpret_cast<const float*>(a.pv);
  const size_t row_stride = (size_t)a.Hkv * HD;     // elements between tokens
  const size_t col = (size_t)h * HD;
  const int piece = tid % kChunks;

  unsigned char* ks = kv;
  unsigned char* vs = kv + kTok * L::kRow;
  for (int tt = t0; tt < t1; tt += kTok) {
    const int nt = min(kTok, t1 - tt);
    // ---- stage the tile's K and V rows (rows past t1 zero-filled) ----
    const int pg0 = tt / a.psz;
    const int off0 = tt - pg0 * a.psz;
    for (int r = tid / kChunks; r < kTok; r += kRowsPerPass) {
      unsigned char* dk = ks + r * L::kRow + piece * 16;
      unsigned char* dv = vs + r * L::kRow + piece * 16;
      if (r < nt) {
        size_t at;
        if constexpr (PAGED) {
          int pg = pg0, off = off0 + r;
          while (off >= a.psz) {      // once at most when psz >= kTok
            off -= a.psz;
            ++pg;
          }
          at = ((size_t)tab[pg] * a.psz + off) * row_stride + col;
        } else {
          at = ((size_t)b * a.S + tt + r) * row_stride + col;
        }
        cp_async16(smem_u32(dk), reinterpret_cast<const unsigned char*>(pk + at) + piece * 16);
        cp_async16(smem_u32(dv), reinterpret_cast<const unsigned char*>(pv + at) + piece * 16);
      } else {
        cp_async16(smem_u32(dk), pk, 0);
        cp_async16(smem_u32(dv), pv, 0);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- q.k: lane = token, warp = hd slice [32 * warp, 32 * warp + 32) ----
    {
      const float4* k4 = reinterpret_cast<const float4*>(ks + lane * L::kRow + warp * 128);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + gi * HD + warp * 32);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qq = q4[i];
          const float4 kk = k4[i];
          acc = fmaf(qq.x, kk.x, acc);
          acc = fmaf(qq.y, kk.y, acc);
          acc = fmaf(qq.z, kk.z, acc);
          acc = fmaf(qq.w, kk.w, acc);
        }
        part[(warp * G + gi) * kTok + lane] = acc;
      }
    }
    __syncthreads();

    // ---- online softmax: warp gi % W owns head gi ----
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi % W != warp) continue;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) x += part[(w * G + gi) * kTok + lane];
      x *= a.scale;
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      const bool valid = lane < nt;
      x = valid ? (uniform ? 0.f : x * kLog2e) : kNeg;
      float mx = x;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m[gi], mx);
      const float corr = exp2f(m[gi] - mn);
      const float p = valid ? exp2f(x - mn) : 0.f;
      float sum = p;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[gi] = l[gi] * corr + sum;
      m[gi] = mn;
      ps[lane * G + gi] = p;
      if (lane == 0) cs[gi] = corr;
    }
    __syncthreads();

    // ---- P.V: 4 columns x g heads, tokens tg, tg + 4, ... ----
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float c = cs[gi];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[gi][j] *= c;
    }
    const unsigned char* vcol = vs + cg * 16;
#pragma unroll
    for (int i = 0; i < kTok / kQuarters; ++i) {
      const int r = tg + kQuarters * i;     // rows past nt are zero, p = 0
      const float4 v = *reinterpret_cast<const float4*>(vcol + r * L::kRow);
      const float* pr = ps + r * G;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = pr[gi];
        o[gi][0] = fmaf(p, v.x, o[gi][0]);
        o[gi][1] = fmaf(p, v.y, o[gi][1]);
        o[gi][2] = fmaf(p, v.z, o[gi][2]);
        o[gi][3] = fmaf(p, v.w, o[gi][3]);
      }
    }
    __syncthreads();     // the next tile overwrites K, V, part and p
  }

  // add the token quarters in order (reusing the K/V staging area)
  float* red = reinterpret_cast<float*>(kv);     // [quarter][G][HD]
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(tg * G + gi) * HD + 4 * cg + j] = o[gi][j];
  }
  float* ms = cs + G;
  float* ls = cs + 2 * G;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi % W == warp && lane == 0) {
      ms[gi] = m[gi];
      ls[gi] = l[gi];
    }
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float acc = 0.f;
#pragma unroll
    for (int qt = 0; qt < kQuarters; ++qt) acc += red[(qt * G + gi) * HD + tid];
    const size_t row = (size_t)b * a.Hq + h * G + gi;
    if (a.splits == 1) {
      a.out[row * HD + tid] = acc / fmaxf(ls[gi], 1e-30f);
    } else {
      const size_t at = row * a.splits + split;
      a.o_part[at * HD + tid] = acc;
      if (tid == 0) {
        a.ml_part[2 * at] = ms[gi];
        a.ml_part[2 * at + 1] = ls[gi];
      }
    }
  }
}

// ===========================================================================
// Pass 2: the split combine
// ===========================================================================
constexpr int kMaxSplits = 4096;       // the most splits a launch takes
constexpr int kCombineThreads = 128;
constexpr int kCombineHeld = 16;       // o loads per thread issued up front

// Block = one output row (b * Hq + hq).  Thread = 4 dims (a float4 column)
// x a group of splits (s = grp, grp + groups, ...): it issues its splits'
// o loads first, so they are in flight while the block finds the maximum
// of m (shuffle tree, then warps in order) and the weights 2^(m_s - max);
// the groups' sums are added in group order, o / max(l, 1e-30).  Launched
// as a programmatic dependent of pass 1, so its blocks are dispatched as
// pass-1 blocks leave instead of after a second launch.
template <int HD>
__global__ void __launch_bounds__(kCombineThreads) split_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    float* __restrict__ out, int n) {
  constexpr int C = HD / 4;
  constexpr int GR = kCombineThreads / C;
  constexpr int W = kCombineThreads / 32;
  __shared__ float cw[kMaxSplits];
  __shared__ float red[W];
  __shared__ float4 part[GR][C];
  griddep_wait();
  const int tid = threadIdx.x;
  const int col = tid % C, grp = tid / C;
  const size_t row = blockIdx.x;
  const float4* op = reinterpret_cast<const float4*>(o_part) + row * n * C + col;
  const float2* ml = reinterpret_cast<const float2*>(ml_part) + row * n;
  float4 held[kCombineHeld];
#pragma unroll
  for (int j = 0; j < kCombineHeld; ++j)
    if (grp + j * GR < n) held[j] = op[(size_t)(grp + j * GR) * C];
  float mx = kNeg;
  for (int s = tid; s < n; s += kCombineThreads) mx = fmaxf(mx, ml[s].x);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < W; ++w) mx = fmaxf(mx, red[w]);
  float sum = 0.f;
  for (int s = tid; s < n; s += kCombineThreads) {
    const float2 w = ml[s];
    const float c = exp2f(w.x - mx);
    cw[s] = c;
    sum = fmaf(w.y, c, sum);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
  __syncthreads();                     // red is reused; cw is complete
  if ((tid & 31) == 0) red[tid >> 5] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < W; ++w) sum += red[w];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float4& o, float c) {
    acc.x = fmaf(o.x, c, acc.x);
    acc.y = fmaf(o.y, c, acc.y);
    acc.z = fmaf(o.z, c, acc.z);
    acc.w = fmaf(o.w, c, acc.w);
  };
#pragma unroll
  for (int j = 0; j < kCombineHeld; ++j)
    if (grp + j * GR < n) add(held[j], cw[grp + j * GR]);
  for (int s = grp + kCombineHeld * GR; s < n; s += GR) add(op[(size_t)s * C], cw[s]);
  part[grp][col] = acc;
  __syncthreads();
  if (grp == 0) {
    float4 t = part[0][col];
#pragma unroll
    for (int g = 1; g < GR; ++g) {
      t.x += part[g][col].x;
      t.y += part[g][col].y;
      t.z += part[g][col].z;
      t.w += part[g][col].w;
    }
    const float l = fmaxf(sum, 1e-30f);
    reinterpret_cast<float4*>(out)[row * C + col] =
        make_float4(t.x / l, t.y / l, t.z / l, t.w / l);
  }
}

// ===========================================================================
// The launch
// ===========================================================================

// Pass-1 kernel of an instantiation: the ring kernel for bf16 K/V, v6 for
// float32 K/V (chosen by type at compile time), with its block size and
// dynamic shared memory.
using Pass1Fn = void (*)(const Args);

template <typename KV, int G, int HD, bool PAGED>
struct Pass1 {
  static Pass1Fn kernel() { return decode_kernel<G, HD, PAGED>; }
  static constexpr int kThreads = HD;
  static constexpr int kStages = 1;
  static int smem(int maxp) { return Smem<G, HD>::bytes(PAGED ? maxp : 0); }
};

template <int G, int HD, bool PAGED>
struct Pass1<__nv_bfloat16, G, HD, PAGED> {
  static Pass1Fn kernel() { return ring_decode_kernel<G, HD, PAGED>; }
  static constexpr int kThreads = kRingThreads;
  static constexpr int kStages = Ring<HD>::kStages;
  static int smem(int) { return Ring<HD>::kBytes; }
};

// Allow `smem` bytes of dynamic shared memory and ask for the largest
// shared-memory carveout, so that as many blocks as the registers allow are
// resident on an SM.
template <typename KV, int G, int HD, bool PAGED>
cudaError_t configure(int smem) {
  static int done = -1;       // largest size configured so far (one card)
  if (smem <= done) return cudaSuccess;
  const Pass1Fn k = Pass1<KV, G, HD, PAGED>::kernel();
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done = smem;
  return err;
}

// Pass-1 blocks one SM holds at once (with `table_rows` table entries
// staged, for v6's paged kernel).
template <typename KV, int G, int HD, bool PAGED>
int blocks_t(int table_rows, int* blocks) {
  using P = Pass1<KV, G, HD, PAGED>;
  const int smem = P::smem(table_rows);
  cudaError_t err = configure<KV, G, HD, PAGED>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, P::kernel(), P::kThreads, smem);
  return (int)err;
}

template <typename KV, int G, int HD, bool PAGED>
int launch_t(const Args& a, cudaStream_t s) {
  using P = Pass1<KV, G, HD, PAGED>;
  const int smem = P::smem(a.maxp);
  const cudaError_t cerr = configure<KV, G, HD, PAGED>(smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(a.B * a.Hkv, a.splits);
  P::kernel()<<<grid, P::kThreads, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hq);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, split_combine_kernel<HD>, (const float*)a.o_part,
                                 (const float*)a.ml_part, a.out, a.splits);
}

// Registers and local-memory bytes per thread (spills and stack) of the
// pass-1 kernel of an instantiation.
template <typename KV, int G, int HD, bool PAGED>
int regs_t(int* regs, int* local_bytes) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, Pass1<KV, G, HD, PAGED>::kernel());
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}

// Ring stages of the instantiation (1 for v6's single tile buffer).
template <typename KV, int G, int HD>
struct Stages {
  static int run(int* stages) {
    *stages = Pass1<KV, G, HD, true>::kStages;
    return 0;
  }
};

// Run F<KV, G, HD>::run(args...) for the runtime (g, hd) of an instantiation.
// Instantiated for the g the port's configs reach, each at hd 64 and 128:
// g = 4 (Mixtral-8x7B and Phi-3.5-MoE at hd 128, Granite-3.0-2B at hd 64),
// g = 6 (Nemotron-4-15B and InternVL2-26B, 48 query heads on 8 kv heads at
// hd 128) and g = 1 (the smoke variants).  The ring kernel's q.k and P.V
// products hold a group's heads in one 8-wide MMA operand, so any g <= 8
// fits it; heads g..7 are dead columns (zero q, zero P, never written).
template <typename KV, template <typename, int, int> class F, int G, typename... A>
int by_hd(int hd, A... args) {
  switch (hd) {
    case 64: return F<KV, G, 64>::run(args...);
    case 128: return F<KV, G, 128>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename KV, template <typename, int, int> class F, typename... A>
int by_g(int g, int hd, A... args) {
  switch (g) {
    case 1: return by_hd<KV, F, 1>(hd, args...);
    case 4: return by_hd<KV, F, 4>(hd, args...);
    case 6: return by_hd<KV, F, 6>(hd, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// by_g over both K/V types.
template <template <typename, int, int> class F, typename... A>
int dispatch(int kv_bf16, int g, int hd, A... args) {
  return kv_bf16 ? by_g<__nv_bfloat16, F>(g, hd, args...) : by_g<float, F>(g, hd, args...);
}

}  // namespace
