// Grouped products of HOBBIT decode's hi experts for Hopper (sm_90a), plain C
// interface bound with ctypes (see kernels/build.py and kernels/ops.py).
//
// No TPU kernel stands behind this one.  The JAX package computes the hi half
// of its grouped FFN as a plain XLA product inside the jitted function
// (src/repro/core/engine.py:437-438):
//     z = einsum("pd,pdc->pc", xh, all_hi_wi[hi_slot]), the same with wo.
// The port captures that function as one CUDA graph, where a torch product
// per pair would need a pool view chosen on the host, and gathering
// w[slot] would copy whole experts (a Mixtral hi expert is 235 MB + 117 MB
// in bf16).  So:
//
//   grouped_matmul_launch:  y[p] = x[p] @ w[slot[p]]
//       x (P, K) and w (S, K, N), both bf16 or both float32; slot (P,)
//       int32; y (P, N) float32.
//
// What bounds it on the card: device-memory bytes.  Each pair is one row
// against one K x N expert matrix, so every weight byte serves only the few
// pairs that picked its expert (Mixtral's up/gate matrix, 4096 x 28672 bf16,
// is 235 MB: 70 us at 3.35 TB/s).  Each distinct slot is streamed once per
// launch for up to 8 pairs on it (pads that repeat a slot add no bytes), so
// the aim is to keep every SM's share of the bytes in flight all the time.
//
// The first design (in the repository's history) reached 77-90% of
// that bound and lost to torch.matmul on one pool view at P = 1: a grid of
// column tiles x K spans at two blocks per SM (Mixtral wi: 224 blocks on
// 264 block slots, so 40 SMs ran one block), each warp streaming short runs
// of 16-byte loads from registers, a block barrier and a shared-memory warp
// sum around every group of pairs, a second kernel adding float32 partial
// rows of the spans, and CUDA-core FMAs whose count grew with the pairs on
// a slot (one template per count).  The bf16 kernel, grouped_mm_kernel:
//
//   * A persistent grid, split evenly (ops.grouped_matmul_plan and
//     ops.grouped_matmul_schedule mirror it): the launch's pairs are grouped
//     by slot on the card (a slot's pairs in order of first occurrence, 8 a
//     group); the launch's tiles are (group, 64-column tile), group-major;
//     the grid is `clusters` thread-block clusters of `ranks` blocks (1 or
//     2), one block per SM.  Cluster c takes the contiguous range [c T / G,
//     (c + 1) T / G) of the T tiles, and rank r of it streams rows [r rows,
//     (r + 1) rows) of K for each (the last rank's past K read as zeros):
//     every block streams the same tiles within one.  Mixtral: ranks 2 on
//     66 clusters, 97% of an even split for wi and wo at any pair count.
//   * A ring of kStages TMA stages per block, one producer warp and four
//     consumer warps.  A stage is one box of 128 rows x 64 columns (16 KB)
//     through a 3-D tensor map over the pool (N, K, S) with the 128-byte
//     swizzle and no L2 promotion: rows past K and columns past N read as
//     zero, another slot's rows never.  The producer's lane 0 issues the
//     boxes; its 32 lanes copy the x of the group's pairs over a row block
//     with cp.async into a second ring, once for all the sweep's boxes of
//     that row block (pair rows padded to 272 bytes, so the B loads hit 32
//     banks).  Each stage has full and empty mbarriers.  The rings run on
//     across sweeps and groups: the next sweep's first boxes are in flight
//     while this one's epilogue runs, and no block barrier is taken after
//     the start.
//   * Wide rows at once.  A block streams up to 8 adjacent tiles of its
//     range side by side (a sweep): their boxes go row block by row block,
//     so each SM reads up to 1 KB of a row at a time.  What was measured on
//     the H100 (700 W) while choosing this: one 64-column tile at a time,
//     strided over the clusters, read wi (rows 57 KB apart) at 81-84% of
//     the bound; boxes of 2 or 4 KB ran at 50-63% whatever their count in
//     flight, 8-32 KB boxes at 82-86% at one pair; the 256-byte L2
//     promotion cost wi 3-6 points at 8 pairs; an x copy per box cost the
//     8-pairs-6-pads launch 10-12% over two pairs, one per row block 1-2%.
//     At 8 pairs the kernel streams at 91% of the bound (3.05 TB/s); what
//     it loses at one pair is a few microseconds per launch (slots read and
//     grouped, the first boxes' latency, the last sweep's exchange).
//   * Tensor cores.  Consumer warp w owns 16 columns of each tile: per 16
//     rows one ldmatrix.x4.trans gives the weight tile as the A operand of
//     mma.sync m16n8k16 (columns as its rows), two conflict-free 32-bit
//     loads give the B operand (the 8 pairs of the group as its n8), sums in
//     float32, one accumulator tile per tile of the sweep.  Any 1-8 pairs
//     cost the same instructions; bf16 products are exact in float32, so
//     only the order of the sums differs from the plain version.  A slot
//     with more than 8 pairs is streamed once per 8.
//   * No float32 partials in device memory and no second launch.  With 2
//     ranks the cluster adds its ranks' partial tiles through distributed
//     shared memory: the owner of warp w's columns (rank w / 2) receives the
//     other rank's 16 x 8 fragments of the sweep with st.async into a
//     double-buffered inbox, adds them to its own and writes y; per-warp
//     full and free mbarriers pace each channel, so no block or cluster
//     barrier is taken per sweep.  No atomics: the result is the same on
//     every run, in a graph replay as in an eager call.
//   * Launched as a programmatic dependent: no global read before
//     griddepcontrol.wait.  A slot outside 0..S-1 aborts the launch
//     (__trap), as in the lo kernels (dequant.cu): a sticky error that the
//     next synchronisation raises.
//
// float32 (grouped_matmul_f32_kernel), which only the card tests launch:
// CUDA-core FMAs, a block per 128 columns with its 8 warps splitting K,
// summed in warp order through shared memory; no partials leave the block.
#include <string.h>

#include "dequant_mmv.cuh"
#include "mma.cuh"

namespace {

constexpr int kGroup = 8;               // pairs one pass over a slot serves: the MMA's n8
constexpr int kMaxPairs = 1024;         // pairs of a launch
constexpr int kTileN = 64;              // columns of a tile: 128 bytes, the swizzle's width
constexpr int kBoxRows = 128;           // rows of a TMA box, a ring stage
constexpr int kStageBytes = kBoxRows * kTileN * 2;   // 16 KB
constexpr int kStages = 8;              // ring depth: 128 KB of weights in flight per SM
constexpr int kSweep = 8;               // most tiles a block streams side by side
constexpr int kConsumers = 4;           // consumer warps, 16 columns of each tile each
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kMaxCluster = 2;          // ranks of a cluster
constexpr int kXPitch = kBoxRows * 2 + 16;           // a pair's x over a box's rows, padded
constexpr int kXBytes = kGroup * kXPitch;
constexpr int kFragFloats = 32 * 4;                  // a warp's 16 x 8 accumulator tile
constexpr int kInboxFloats = 2 * kConsumers * kSweep * kFragFloats;
static_assert(kTileN == 16 * kConsumers, "a consumer warp owns one m16 tile of each tile");
static_assert(kConsumers % kMaxCluster == 0, "every rank owns whole m16 tiles");

// grouped_matmul_f32_kernel's block
constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Tile = 128;           // columns of a block: 4 per lane

// Shared ints of the grouping (group_pairs): 8 P + 1.
__host__ __device__ constexpr int group_ints(int P) { return 8 * P + 1; }

// The launch's pairs grouped by slot, in the same order on every block:
// slots in order of their first pair, each slot's pairs in pair order, cut
// into groups of kGroup.  Group g is order[gfirst[g] .. gfirst[g + 1]) on
// slot gslot[g]; returns the group count.  Called by the whole block; `ws`
// holds group_ints(P) ints, order at ws + 5 P, gfirst at ws + 6 P, gslot
// at ws + 7 P + 1.
__device__ int group_pairs(const int* __restrict__ slot, int P, int num_slots, int* ws) {
  int* sslot = ws;
  int* first = ws + P;        // each pair's slot's first pair
  int* rnk = ws + 2 * P;      // pairs before it on its slot
  int* cnt = ws + 3 * P;      // pairs on its slot; then, at a first pair, its first group
  int* pbase = ws + 4 * P;    // at a first pair: its slot's first position in order
  int* order = ws + 5 * P;
  int* gfirst = ws + 6 * P;
  int* gslot = ws + 7 * P + 1;
  __shared__ int groups;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int s = slot[p];
    // an out-of-range slot (a pad's too) is a fault in the caller's slot
    // bookkeeping, and the plain version raises IndexError for it
    if (s < 0 || s >= num_slots) __trap();
    sslot[p] = s;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int s = sslot[p];
    int f = p, r = 0, c = 0;
    for (int q = 0; q < P; ++q) {
      if (sslot[q] != s) continue;
      if (q < p) {
        f = min(f, q);
        ++r;
      }
      ++c;
    }
    first[p] = f;
    rnk[p] = r;
    cnt[p] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ng = 0, np = 0;
    for (int p = 0; p < P; ++p) {
      if (first[p] != p) continue;
      const int c = cnt[p];
      cnt[p] = ng;
      pbase[p] = np;
      ng += (c + kGroup - 1) / kGroup;
      np += c;
    }
    gfirst[ng] = P;
    groups = ng;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int f = first[p];
    const int pos = pbase[f] + rnk[p];
    order[pos] = p;
    if (rnk[p] % kGroup == 0) {
      const int g = cnt[f] + rnk[p] / kGroup;
      gfirst[g] = pos;
      gslot[g] = sslot[p];
    }
  }
  __syncthreads();
  return groups;
}

// A block's next sweep: up to kSweep tiles of one group side by side,
// taken in order from the cluster's range of the launch's tiles (all
// groups' tiles, group-major).
struct Sweeps {
  int t, t1, tiles;
  __device__ Sweeps(int cid, int clusters, int groups, int tiles_)
      : t((int)((long long)cid * groups * tiles_ / clusters)),
        t1((int)((long long)(cid + 1) * groups * tiles_ / clusters)),
        tiles(tiles_) {}
  // (group, first tile, width) of the next sweep; false past the range
  __device__ bool next(int& g, int& tile0, int& w) {
    if (t >= t1) return false;
    g = t / tiles;
    tile0 = t - g * tiles;
    w = min(kSweep, min(t1 - t, tiles - tile0));
    t += w;
    return true;
  }
};

// Dynamic shared memory of grouped_mm_kernel: the weight ring (1024-byte
// aligned for the 128-byte swizzle), the x ring, the inbox, the mbarriers
// (full and empty per weight stage and per x stage, full and free per inbox
// buffer and warp), the grouping, and slack to align the base.
constexpr int kBarOffset = kStages * (kStageBytes + kXBytes) + kInboxFloats * 4;
constexpr int kGroupOffset = kBarOffset + (4 * kStages + 4 * kConsumers) * 8;
__host__ __device__ constexpr int mm_smem(int P) { return 1024 + kGroupOffset + group_ints(P) * 4; }

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 16 bytes into another block's shared memory, completing on its mbarrier.
__device__ __forceinline__ void store_async4(uint32_t dst, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(__float_as_uint(v[2])),
      "r"(__float_as_uint(v[3])), "r"(bar)
      : "memory");
}

// Arrive on the mbarrier at `bar` of another block of the cluster.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// acc += the box's 128 rows of the warp's 16 columns (A, ldmatrix.trans
// from the swizzled tile at wa) times the group's x over those rows (B, at
// xs): 8 k16 steps of mma.sync.
__device__ __forceinline__ void box_mma(float (&acc)[4], uint32_t wa, const unsigned char* xs) {
#pragma unroll
  for (int u = 0; u < kBoxRows / 16; ++u) {
    uint32_t a[4];
    ldsm_x4_t(wa + u * 16 * 128, a);
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs + 32 * u);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + 32 * u + 16);
    mma_bf16(acc, a[0], a[1], a[2], a[3], b0, b1);
  }
}

// Block (cluster c, rank r) of a grid of `clusters` x `ranks` blocks, one
// per SM; rank r streams rows [r rows, (r + 1) rows) of K.  w_map: the
// pool (S, K, N) bf16 as a 3-D tensor map, boxes of 64 columns x 128 rows
// x 1 slot, 128-byte swizzle.
__global__ void __launch_bounds__(kThreads, 1) grouped_mm_kernel(
    const __grid_constant__ CUtensorMap w_map, const __nv_bfloat16* __restrict__ x,
    const int* __restrict__ slot, float* __restrict__ y, int P, int K, int N, int num_slots,
    int ranks, int rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 8 rows
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t wring = smem_u32(smem);
  unsigned char* xring = smem + kStages * kStageBytes;
  float* inbox = reinterpret_cast<float*>(xring + kStages * kXBytes);
  const uint32_t full0 = smem_u32(smem + kBarOffset);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t xfull0 = empty0 + 8 * kStages;
  const uint32_t xempty0 = xfull0 + 8 * kStages;
  const uint32_t ifull0 = xempty0 + 8 * kStages;      // [buffer][warp]
  const uint32_t ifree0 = ifull0 + 8 * 2 * kConsumers;  // [buffer][warp]
  int* ws = reinterpret_cast<int*>(smem + kGroupOffset);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = (int)cluster_rank();
  const int cid = blockIdx.x / ranks;
  const int clusters = gridDim.x / ranks;
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w_map))
                 : "memory");
    // a weight stage completes on lane 0's arrival with its TMA bytes, an x
    // stage on the producer's 32 arrivals as their copies land
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers);
      mbar_init(xfull0 + 8 * i, 32);
      mbar_init(xempty0 + 8 * i, kConsumers);
    }
    for (int i = 0; i < 2 * kConsumers; ++i) {
      mbar_init(ifull0 + 8 * i, 1);
      mbar_init(ifree0 + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // no global read (slot, x, w) before the kernel before this one is done
  griddep_wait();
  griddep_launch_dependents();
  const int groups = group_pairs(slot, P, num_slots, ws);
  const int* order = ws + 5 * P;
  const int* gfirst = ws + 6 * P;
  const int* gslot = ws + 7 * P + 1;
  // every block of the cluster arrives once its mbarriers are set; a warp
  // waits for the others only before its first remote access (or its exit)
  cluster_arrive_relaxed();

  const int tiles = (N + kTileN - 1) / kTileN;
  const int row0 = rank * rows;
  const int blocks = rows / kBoxRows;      // row blocks of the rank's K range
  // a sweep of w tiles over the rank's rows is w * blocks boxes, taken row
  // block by row block, one a weight stage; the x of a row block is one x
  // stage, read by its w boxes
  Sweeps sweeps(cid, clusters, groups, tiles);
  int g, tile0, w;

  if (warp == kConsumers) {
    // ---- producer ----
    uint32_t it = 0, xt = 0;                 // weight stages, x stages so far
    while (sweeps.next(g, tile0, w)) {
      const int sl = gslot[g];
      const int f0 = gfirst[g];
      const int np = gfirst[g + 1] - f0;
      for (int rb = 0; rb < blocks; ++rb, ++xt) {
        const int k0 = row0 + rb * kBoxRows;
        // x of the group's pairs over the row block, once for its w boxes:
        // 16-byte pieces (pair, 8 rows); rows past K read as zero (K % 8 == 0)
        const int xpos = xt % kStages;
        mbar_wait(xempty0 + 8 * xpos, ((xt / kStages) & 1) ^ 1);
        const uint32_t xd = smem_u32(xring + xpos * kXBytes);
        for (int c = lane; c < np * (kBoxRows / 8); c += 32) {
          const int m = c / (kBoxRows / 8);
          const int piece = c - m * (kBoxRows / 8);
          const int k = k0 + 8 * piece;
          cp_async16(xd + m * kXPitch + 16 * piece,
                     k < K ? x + (size_t)order[f0 + m] * K + k : x, k < K ? 16 : 0);
        }
        cp_async_arrive(xfull0 + 8 * xpos);
        for (int i = 0; i < w; ++i, ++it) {
          const int pos = it % kStages;
          mbar_wait(empty0 + 8 * pos, ((it / kStages) & 1) ^ 1);
          if (lane == 0) {
            // the consumers' reads of the stage come before the copy that refills it
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(full0 + 8 * pos, kStageBytes);
            tma_3d(wring + pos * kStageBytes, &w_map, (tile0 + i) * kTileN, k0, sl,
                   full0 + 8 * pos);
          }
        }
      }
    }
    cluster_wait();
  } else {
    // ---- consumer warp `warp`: columns 16 warp .. + 15 of each tile ----
    const int g8 = lane >> 2;
    const int t = lane & 3;
    // ldmatrix.x4.trans: lane i gives row i % 8 of matrix i / 8; matrix m
    // is rows 8 (m / 2) .. + 7 of a 16-row step at columns 8 (m % 2) .. + 7
    // of the warp's 16 (a0 .. a3 of the A operand).  The 128-byte swizzle
    // puts 16-byte chunk c of row k at chunk c ^ (k % 8).
    const int lrow = 8 * (lane >> 4) + (lane & 7);
    const int lchunk = 2 * warp + ((lane >> 3) & 1);
    const uint32_t a_off = lrow * 128 + ((lchunk ^ (lrow & 7)) << 4);
    const int b_off = g8 * kXPitch + 4 * t;        // B: pair g8, rows 2t, 2t + 1 (+ 8)
    const int owner = warp * ranks / kConsumers;   // the rank that writes these columns
    uint32_t it = 0, xt = 0;                       // weight stages, x stages so far
    int xl = 0;                                    // sweeps of this block so far
    for (; sweeps.next(g, tile0, w); ++xl) {
      const int f0 = gfirst[g];
      const int np = gfirst[g + 1] - f0;
      float acc[kSweep][4];
#pragma unroll
      for (int i = 0; i < kSweep; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int rb = 0; rb < blocks; ++rb, ++xt) {
        const int xpos = xt % kStages;
        mbar_wait(xfull0 + 8 * xpos, (xt / kStages) & 1);
        const unsigned char* xs = xring + xpos * kXBytes + b_off;
        for (int i = 0; i < w; ++i, ++it) {
          const int pos = it % kStages;
          mbar_wait(full0 + 8 * pos, (it / kStages) & 1);
          const uint32_t wa = wring + pos * kStageBytes + a_off;
          switch (i) {                             // the box's tile: its accumulators
#define GMM_BOX(n) \
  case n: box_mma(acc[n], wa, xs); break;
            GMM_BOX(0) GMM_BOX(1) GMM_BOX(2) GMM_BOX(3)
            GMM_BOX(4) GMM_BOX(5) GMM_BOX(6) GMM_BOX(7)
#undef GMM_BOX
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * pos);
        }
        if (lane == 0) mbar_arrive(xempty0 + 8 * xpos);
      }
      // acc[i]: column 16 warp + g8 (+ 8 for acc[i][2], acc[i][3]) of tile
      // tile0 + i, pairs 2t (acc[i][0], [2]) and 2t + 1 ([1], [3]) of the group
      const int buf = xl & 1;
      const int ch = buf * kConsumers + warp;      // this warp's channel
      float* box = inbox + ch * kSweep * kFragFloats + 4 * lane;
      if (ranks > 1 && xl == 0) cluster_wait();    // the cluster's mbarriers are ready
      if (ranks > 1 && rank != owner) {
        // push the partials to the owner once it has read this buffer's last sweep
        if (xl >= 2) mbar_wait_cluster(ifree0 + 8 * ch, ((xl >> 1) - 1) & 1);
        const uint32_t dst = map_rank(smem_u32(box), owner);
        const uint32_t bar = map_rank(ifull0 + 8 * ch, owner);
#pragma unroll
        for (int i = 0; i < kSweep; ++i)
          if (i < w) store_async4(dst + i * kFragFloats * 4, acc[i], bar);
        continue;
      }
      if (ranks > 1) {
        // this rank's partials plus the other's (two addends: the sum is the
        // same in either order)
        if (lane == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                           ifull0 + 8 * ch),
                       "r"(w * kFragFloats * 4)
                       : "memory");
        mbar_wait_cluster(ifull0 + 8 * ch, (xl >> 1) & 1);
#pragma unroll
        for (int i = 0; i < kSweep; ++i) {
          if (i >= w) break;
          const float4 o = *reinterpret_cast<const float4*>(box + i * kFragFloats);
          acc[i][0] += o.x;
          acc[i][1] += o.y;
          acc[i][2] += o.z;
          acc[i][3] += o.w;
        }
        __syncwarp();                             // every lane has read the inbox
        if (lane == 0) mbar_arrive_remote(map_rank(ifree0 + 8 * ch, 1 - rank));
      }
#pragma unroll
      for (int i = 0; i < kSweep; ++i) {
        if (i >= w) break;
        const int col = (tile0 + i) * kTileN + 16 * warp + g8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 2 * t + (e & 1);
          const int n = col + 8 * (e >> 1);
          if (m < np && n < N) y[(size_t)order[f0 + m] * N + n] = acc[i][e];
        }
      }
    }
    if (ranks == 1 || xl == 0) cluster_wait();
  }
  // no block leaves while another of its cluster may still reach its
  // shared memory
  cluster_sync();
}

// float32: block b -> columns [128 b, + 128) of y for every group; its 8
// warps split K into runs and add their sums in warp order.
__global__ void __launch_bounds__(kF32Threads) grouped_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ slot,
    float* __restrict__ y, int P, int K, int N, int num_slots) {
  extern __shared__ __align__(16) float fsm[];
  float* red = fsm;                              // [warp][pair][column]
  int* ws = reinterpret_cast<int*>(fsm + kF32Warps * kGroup * kF32Tile);
  const int groups = group_pairs(slot, P, num_slots, ws);
  const int* order = ws + 5 * P;
  const int* gfirst = ws + 6 * P;
  const int* gslot = ws + 7 * P + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int run = (K + kF32Warps - 1) / kF32Warps;
  const int k0 = min(K, warp * run);
  const int k1 = min(K, k0 + run);
  const int tile0 = blockIdx.x * kF32Tile;
  const int col = tile0 + 4 * lane;
  const bool ok = col < N;
  for (int g = 0; g < groups; ++g) {
    const int f0 = gfirst[g];
    const int np = gfirst[g + 1] - f0;
    const float* xp[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) xp[j] = x + (size_t)order[f0 + min(j, np - 1)] * K;
    const float* wp = w + (size_t)gslot[g] * K * N + col;
    float acc[kGroup][4];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float4 wv =
          ok ? __ldg(reinterpret_cast<const float4*>(wp + (size_t)k * N)) : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j >= np) break;
        const float xv = __ldg(xp[j] + k);
        acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
        acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
        acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
        acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j < np)
        *reinterpret_cast<float4*>(red + (warp * kGroup + j) * kF32Tile + 4 * lane) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    __syncthreads();                 // every warp's sums are in red
    for (int e = threadIdx.x; e < np * kF32Tile; e += kF32Threads) {
      const int j = e / kF32Tile;
      const int c = e - j * kF32Tile;
      if (tile0 + c >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kF32Warps; ++v) s += red[(v * kGroup + j) * kF32Tile + c];
      y[(size_t)order[f0 + j] * N + tile0 + c] = s;
    }
    __syncthreads();                 // red takes the next group's sums
  }
}

int f32_smem(int P) { return kF32Warps * kGroup * kF32Tile * 4 + group_ints(P) * 4; }

// Lets each kernel take the shared memory of kMaxPairs pairs (once per
// process).
cudaError_t prepare() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mm_smem(kMaxPairs));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(grouped_matmul_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem(kMaxPairs));
    return e;
  }();
  return err;
}

cudaLaunchConfig_t mm_config(cudaLaunchAttribute* attr, int ranks, int clusters, int P,
                             cudaStream_t s) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a programmatic dependent of the kernel before it: its blocks start as
  // that kernel's blocks leave (griddep_wait orders every global read)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ranks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = mm_smem(P);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

bool valid_ranks(int ranks) { return ranks >= 1 && ranks <= kMaxCluster; }

}  // namespace

// The 3-D TMA tensor map of grouped_mm_kernel over the pool w (S, K, N)
// bf16 at `w`, written into `map` (128 bytes).  It depends only on the
// address and shape, so the caller may keep it for as long as the pool lives.
extern "C" int grouped_matmul_tensor_map(const void* w, int S, int K, int N, void* map) {
  if (w == nullptr || map == nullptr || S <= 0 || K <= 0 || N <= 0 || N % 8 != 0 ||
      (uintptr_t)w % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {kTileN, kBoxRows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUtensorMap m;
  const CUresult r = encode(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  memcpy(map, &m, sizeof(m));
  return 0;
}

// y (P, N) f32 = x[p] @ w[slot[p]], slot (P,) int32.  bf16 (w_bf16 = 1):
// x (P, K) with K % 8 == 0, 16-byte aligned; w_map from
// grouped_matmul_tensor_map over w (S, K, N); a grid of `clusters`
// clusters of `ranks` blocks (1 or 2), each rank `rows` rows of K (a
// multiple of 128, ranks x rows >= K).  float32: x (P, K), w (S, K, N)
// 16-byte aligned, N % 4 == 0; w_map, ranks, clusters and rows unused.
extern "C" int grouped_matmul_launch(const void* x, const void* w, const void* w_map,
                                     const void* slot, void* y, int P, int K, int N,
                                     int num_slots, int w_bf16, int ranks, int clusters,
                                     int rows, void* stream) {
  if (x == nullptr || slot == nullptr || y == nullptr || P <= 0 || P > kMaxPairs || K <= 0 ||
      N <= 0 || num_slots <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_bf16) {
    if (w_map == nullptr || K % 8 != 0 || N % 8 != 0 || (uintptr_t)x % 16 != 0 ||
        !valid_ranks(ranks) || clusters <= 0 || rows <= 0 || rows % kBoxRows != 0 ||
        (long long)rows * ranks < K || mm_smem(P) > max_smem())
      return (int)cudaErrorInvalidValue;
    CUtensorMap m;
    memcpy(&m, w_map, sizeof(m));
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = mm_config(attr, ranks, clusters, P, s);
    err = cudaLaunchKernelEx(&cfg, grouped_mm_kernel, m, (const __nv_bfloat16*)x,
                             (const int*)slot, (float*)y, P, K, N, num_slots, ranks, rows);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (w == nullptr || N % 4 != 0 || (uintptr_t)w % 16 != 0) return (int)cudaErrorInvalidValue;
  grouped_matmul_f32_kernel<<<(N + kF32Tile - 1) / kF32Tile, kF32Threads, f32_smem(P), s>>>(
      (const float*)x, (const float*)w, (const int*)slot, (float*)y, P, K, N, num_slots);
  return (int)cudaGetLastError();
}

// What the card reports for the bf16 (w_bf16 = 1) or float32 kernel at
// `pairs` pairs: registers and local memory (spills) per thread, blocks per
// SM, dynamic shared memory per block, and, for bf16, the clusters of
// `ranks` blocks it runs at once (cudaOccupancyMaxActiveClusters; 0 for
// float32).
extern "C" int grouped_matmul_info(int w_bf16, int pairs, int ranks, int* regs, int* local,
                                   int* blocks_per_sm, int* smem, int* clusters) {
  if (regs == nullptr || local == nullptr || blocks_per_sm == nullptr || smem == nullptr ||
      clusters == nullptr || pairs <= 0 || pairs > kMaxPairs || !valid_ranks(ranks))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const void* fn = w_bf16 ? (const void*)grouped_mm_kernel : (const void*)grouped_matmul_f32_kernel;
  *smem = w_bf16 ? mm_smem(pairs) : f32_smem(pairs);
  *clusters = 0;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local = (int)fa.localSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      w_bf16 ? kThreads : kF32Threads, *smem);
  if (err != cudaSuccess || !w_bf16) return (int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = mm_config(attr, ranks, 1, pairs, nullptr);
  cfg.numAttrs = 1;                             // the cluster dimension alone
  return (int)cudaOccupancyMaxActiveClusters(clusters, grouped_mm_kernel, &cfg);
}

// The kernel's layout constants, in the order ops.py mirrors them: pairs
// per pass over a slot, columns of a tile, rows of a box (a ring stage),
// ring stages, most tiles of a sweep, most ranks of a cluster, most pairs.
extern "C" int grouped_matmul_layout(int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  const int v[7] = {kGroup, kTileN, kBoxRows, kStages, kSweep, kMaxCluster, kMaxPairs};
  memcpy(out, v, sizeof(v));
  return 0;
}
