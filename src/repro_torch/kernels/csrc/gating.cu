// Router kernels of HOBBIT decode for Hopper (sm_90a), plain C interface
// bound with ctypes (see kernels/build.py and kernels/ops.py).
//
// Replaces src/repro/kernels/stacked_gating.py:
//   gating_topk_pallas    -> gating_topk_launch    (router matmul, softmax,
//                                                   iterative top-k)
//   stacked_gating_pallas -> stacked_gating_launch (router matmul only)
//
// What bounds it on the card: latency, not bytes.  A decode step reads B*D
// activations and one (D, E) float32 router per p (4096 x 8 x 4 B = 128 KB
// for Mixtral): 49-83 ns at 3.35 TB/s, a few hundred thousand FMAs.  What
// the card spends is the launch, each round trip to memory before the
// multiplies can start, and each barrier and dependent chain of the
// reduction.  The design (gating_cluster_kernel) keeps each to about one:
//
//   * one thread-block cluster per router p (grid ranks x P, cluster ranks
//     x 1); rank c reads its contiguous slice of D rows of the router once.
//     Every thread issues all of its 16-byte gate loads (kLoads of them)
//     before its first multiply, so a rank's whole slice is in flight in
//     one round trip: 16 KB per block, 128 KB per cluster at Mixtral's
//     shape, where ops.gating_plan picks 8 ranks.
//   * each gate value is multiplied by all B token rows at once (kMaxRows
//     per pass, further passes for more); the rows' slice of x is loaded
//     beside the gates (all in flight together) and staged in shared
//     memory as float32, once per block.
//   * a fixed-order reduction: the lanes of one column group add by an xor
//     butterfly (fixed pairs), then warps (or, for wide routers, row groups)
//     in order; each rank sends its sums into rank 0's inbox with st.async,
//     each store completing its bytes on an mbarrier there, and exits.
//     Rank 0 waits for the bytes (no cluster barrier on the way: one, at
//     the start, only makes sure every block runs) and adds the ranks in
//     rank order.  No atomics and no partials in device memory, so two
//     calls give bit-identical results.
//   * softmax and top-k by one warp per token row (select_row; for E <= 32
//     select_lanes, on the registers that hold the row's logits): lanes
//     stride over the experts; the max and each top-k round's argmax are
//     warp reductions (redux.sync) on order-preserving integer keys, the
//     sum a butterfly; ties go to the lowest index as in the Pallas
//     kernel's iterative argmax.  Covers E up to kMaxExperts = 256.
//
// Thread layout: 256 threads are (rows x lanes) where lanes is the number
// of column groups (E/4 with 16-byte loads, E with 4-byte ones) padded to a
// power of two, so that a column group's threads sit in one warp at a fixed
// xor distance (lanes <= 32) or a warp holds one row of groups (lanes > 32).
// No programmatic dependent launch: on the serving path each launch follows
// a host synchronisation, so the stream is idle and PDL buys nothing.
// Clusters stay within the portable 8 blocks: 16 (non-portable) timed no
// faster at Mixtral's shape.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxExperts = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// cluster kernel
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;          // gate loads in flight per thread and tile
constexpr int kMaxRows = 8;        // token rows per pass (one softmax warp each)
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kBufFloats = 8192;   // x tile, then slot partials, then logits
constexpr int kStaticSmem = kBufFloats * 4 + 16;   // buf and the mbarrier, padded
constexpr int kXPer = 4;           // x loads per thread and row of a tile (<= 1024 rows)

// column groups padded to a power of two: a divisor or a multiple of 32
__host__ __device__ __forceinline__ int pad_lanes(int groups) {
  int p = 1;
  while (p < groups) p <<= 1;
  return p;
}

template <int V>
__device__ __forceinline__ void load_gates(float (&g)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  } else {
    g[0] = __ldg(p);
  }
}

// Cluster barriers (PTX): arrive without ordering, wait, and a full barrier
// whose arrive releases and whose wait acquires (shared memory included).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// Rank 0's inbox is filled by st.async: each store completes its 4 bytes
// on rank 0's mbarrier, which rank 0 armed with the bytes it expects.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void store_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// Waits for the mbarrier's phase `parity`; a wait that has not ended after
// ~2M tries (far past any launch) traps instead of hanging the card.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long spins = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++spins > 2000000) __trap();
  }
}

// float -> int with the same order (no NaN), and back
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Softmax and top-k of one row of E logits `l` (shared memory, replaced by
// exp(l - max)) by one warp: lane l takes experts l, l + 32, ...  The max
// and each round's argmax are warp reductions on order-preserving integer
// keys; the sum a butterfly.  A round picks the largest exp(l - max) (the
// largest probability), ties at the lowest index, and marks it -1; vals
// get exp / sum for the K picks only.  Loops stay rolled: the code runs
// once per launch, so its size costs more than its instructions.
__device__ __forceinline__ void select_row(float* l, int E, int top_k, int lane,
                                           float* vals, int* idx) {
  int mk = INT_MIN;
#pragma unroll 1
  for (int e = lane; e < E; e += 32) mk = max(mk, ordered(l[e]));
  const float m = unordered(__reduce_max_sync(kFull, mk));
  float s = 0.f;
#pragma unroll 1
  for (int e = lane; e < E; e += 32) {
    const float z = expf(l[e] - m);
    l[e] = z;
    s += z;
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
#pragma unroll 1
  for (int j = 0; j < top_k; ++j) {
    // key: bits + 1 (floats >= 0 order as unsigned), 0 for a pick; the
    // lane's best first (strict >: ties keep the lowest index)
    unsigned bk = 0;
    int bi = kMaxExperts;
#pragma unroll 1
    for (int e = lane; e < E; e += 32) {
      const float z = l[e];
      const unsigned k = z >= 0.f ? __float_as_uint(z) + 1u : 0u;
      if (k > bk) {
        bk = k;
        bi = e;
      }
    }
    const unsigned best = __reduce_max_sync(kFull, bk);
    const int pick = (int)__reduce_min_sync(kFull, bk == best ? (unsigned)bi
                                                              : (unsigned)kMaxExperts);
    if (lane == 0) {
      vals[j] = __uint_as_float(best - 1u) / s;
      idx[j] = pick;
      l[pick] = -1.f;
    }
    __syncwarp();
  }
}

// select_row for E <= 32, one expert per lane: `l` is this lane's logit
// (`valid` false past E), the same arithmetic on registers.
__device__ __forceinline__ void select_lanes(float l, bool valid, int top_k, int lane,
                                             float* vals, int* idx) {
  const float m = unordered(__reduce_max_sync(kFull, valid ? ordered(l) : INT_MIN));
  const float z = valid ? expf(l - m) : 0.f;
  float s = z;
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  unsigned key = valid ? __float_as_uint(z) + 1u : 0u;
#pragma unroll 1
  for (int j = 0; j < top_k; ++j) {
    const unsigned best = __reduce_max_sync(kFull, key);
    const int pick = (int)__reduce_min_sync(kFull, key == best ? (unsigned)lane : 32u);
    if (lane == 0) {
      vals[j] = __uint_as_float(best - 1u) / s;
      idx[j] = pick;
    }
    if (lane == pick) key = 0u;
  }
}

// V: gate floats per load (4 when E % 4 == 0 and the gates are 16-byte
// aligned, else 1); BC: token rows per pass (1, 2, 4 or 8).  Dynamic shared
// memory: rank 0's inbox of every rank's partial, ranks x BC x E floats.
template <typename XT, bool kSelect, int V, int BC>
__global__ void __launch_bounds__(kThreads) gating_cluster_kernel(
    const XT* __restrict__ x, const float* __restrict__ gates, float* __restrict__ logits,
    float* __restrict__ vals, int* __restrict__ idx, int B, int D, int E, int top_k,
    int slice) {
  __shared__ __align__(16) float buf[kBufFloats];
  __shared__ __align__(8) unsigned long long full;   // rank 0: the inbox is full
  extern __shared__ float inbox[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();              // waited on before the first remote store
  const uint32_t inbox0 = map_rank(smem_addr(inbox), 0);
  const uint32_t full0 = map_rank(smem_addr(&full), 0);
  const int p = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int groups = E / V;
  const int lanes = pad_lanes(groups);
  const int rows = kThreads / lanes;     // D rows one pass of the block covers
  const int tile = rows * kLoads;        // D rows of one tile, at most kThreads * kXPer
  const int q = t % lanes, r = t / lanes;
  const bool owner = q < groups;
  // one partial per warp (lanes <= 32) or per row of groups (lanes > 32,
  // then at most kWarps / 2 rows)
  const int slots = lanes <= 32 ? kWarps : rows;
  const int slot = lanes <= 32 ? warp : r;
  const int d0 = min(D, rank * slice);
  const int d1 = min(D, d0 + slice);
  const float* g = gates + (size_t)p * D * E + min(q, groups - 1) * V;

  for (int b0 = 0; b0 < B; b0 += BC) {
    const int nb = min(BC, B - b0);
    float acc[BC * V];                   // acc[b * V + v]: row b, expert q * V + v
#pragma unroll
    for (int i = 0; i < BC * V; ++i) acc[i] = 0.f;

    for (int a = d0; a < d1; a += tile) {
      const int n = min(tile, d1 - a);
      // every gate and x load of the tile in flight before the barrier:
      // unconditional loads from clamped addresses (a load under a branch
      // waits for the one before it), masked afterwards
      float gv[kLoads][V];
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        load_gates<V>(gv[j], g + (size_t)(a + min(j * rows + r, n - 1)) * E);
      XT xv[BC][kXPer];
#pragma unroll
      for (int b = 0; b < BC; ++b) {
        const XT* xr = x + (size_t)(b0 + min(b, nb - 1)) * D + a;
#pragma unroll
        for (int i = 0; i < kXPer; ++i) xv[b][i] = xr[min(t + i * kThreads, n - 1)];
      }
      __syncthreads();                   // earlier reads of buf are done
#pragma unroll
      for (int b = 0; b < BC; ++b)
#pragma unroll
        for (int i = 0; i < kXPer; ++i) {
          const int dl = t + i * kThreads;
          if (dl < tile) buf[b * tile + dl] = b < nb && dl < n ? to_f32(xv[b][i]) : 0.f;
        }
      __syncthreads();
      // masked gates are zero (x past the slice is zero in buf): no branch
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int dl = j * rows + r;
        const bool live = owner && dl < n;
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          const float xb = buf[b * tile + dl];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[b * V + v] = fmaf(xb, live ? gv[j][v] : 0.f, acc[b * V + v]);
        }
      }
    }

    // lanes of one column group, xor distance `lanes` apart in the warp
    for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
      for (int i = 0; i < BC * V; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
    __syncthreads();                     // every read of the x tile is done
    if (owner && (lanes > 32 || lane < lanes)) {
#pragma unroll
      for (int b = 0; b < BC; ++b)
#pragma unroll
        for (int v = 0; v < V; ++v) buf[(slot * BC + b) * E + q * V + v] = acc[b * V + v];
    }
    __syncthreads();
    if (b0 == 0) cluster_wait();         // every block of the cluster has started
    // the slots in order (every load issued, the absent ones added as 0);
    // the block's sum goes straight to rank 0's inbox
    for (int i = t; i < nb * E; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const float v = buf[min(k, slots - 1) * BC * E + i];
        s += k < slots ? v : 0.f;
      }
      store_async(inbox0 + 4u * (uint32_t)(rank * BC * E + i), s, full0);
    }
    if (rank != 0) {
      if (b0 + BC < B) cluster_sync();   // rank 0 has read the inbox
      continue;
    }
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(&full)), "r"(ranks * nb * E * 4) : "memory");
    wait_parity(smem_addr(&full), (uint32_t)((b0 / BC) & 1));
    // rank 0: the ranks in rank order
    const size_t o = (size_t)p * B + b0;   // first output row of the pass
    if (E <= 32) {
      // a warp per token row, a lane per expert: logits stay in registers
      if (warp < nb) {
        const int e = min(lane, E - 1);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k) {
          const float v = inbox[min(k, ranks - 1) * BC * E + warp * E + e];
          s += k < ranks ? v : 0.f;
        }
        if (lane < E) logits[(o + warp) * E + lane] = s;
        if constexpr (kSelect)
          select_lanes(s, lane < E, top_k, lane, vals + (o + warp) * top_k,
                       idx + (o + warp) * top_k);
      }
      if (b0 + BC < B) cluster_sync();   // the inbox may be refilled
    } else {
      for (int i = t; i < nb * E; i += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k) {
          const float v = inbox[min(k, ranks - 1) * BC * E + i];
          s += k < ranks ? v : 0.f;
        }
        logits[o * E + i] = s;
        if constexpr (kSelect) buf[i] = s;
      }
      if (b0 + BC < B) cluster_sync();   // the inbox may be refilled
      if constexpr (kSelect) {
        __syncthreads();
        if (warp < nb) select_row(buf + warp * E, E, top_k, lane, vals + (o + warp) * top_k,
                                  idx + (o + warp) * top_k);
      }
    }
  }
}

template <typename XT, bool kSelect, int V>
const void* cluster_rows(int rows) {
  switch (rows) {
    case 1:
      return (const void*)gating_cluster_kernel<XT, kSelect, V, 1>;
    case 2:
      return (const void*)gating_cluster_kernel<XT, kSelect, V, 2>;
    case 4:
      return (const void*)gating_cluster_kernel<XT, kSelect, V, 4>;
    default:
      return (const void*)gating_cluster_kernel<XT, kSelect, V, 8>;
  }
}

template <typename XT, bool kSelect>
const void* cluster_vec(int vec, int rows) {
  return vec ? cluster_rows<XT, kSelect, 4>(rows) : cluster_rows<XT, kSelect, 1>(rows);
}

// the instantiation for bf16 or float32 x, with or without the selection,
// 16-byte or 4-byte gate loads, and `rows` token rows per pass
const void* cluster_kernel(int x_bf16, int select, int vec, int rows) {
  if (x_bf16)
    return select ? cluster_vec<__nv_bfloat16, true>(vec, rows)
                  : cluster_vec<__nv_bfloat16, false>(vec, rows);
  return select ? cluster_vec<float, true>(vec, rows) : cluster_vec<float, false>(vec, rows);
}

// token rows per pass for a batch of B: the smallest of 1, 2, 4, 8 that
// holds min(B, kMaxRows)
int rows_per_pass(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : kMaxRows; }

cudaError_t launch_cluster(const void* x, int x_bf16, const void* gates, void* logits,
                           void* vals, void* idx, int select, int P, int B, int D, int E,
                           int top_k, int vec, int ranks, cudaStream_t s) {
  if (vec && (E % 4 != 0 || ((uintptr_t)gates & 15) != 0)) return cudaErrorInvalidValue;
  if (ranks < 1 || ranks > kMaxCluster || P > 65535) return cudaErrorInvalidValue;
  const int rows = rows_per_pass(B);
  const void* fn = cluster_kernel(x_bf16, select, vec, rows);
  // rank 0's inbox; past 48 KB with the static buffer and mbarrier only by
  // opting in
  const int inbox = ranks * rows * E * (int)sizeof(float);
  if (inbox + kStaticSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, inbox);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, P, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = inbox;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* g = (const float*)gates;
  float* lg = (float*)logits;
  float* v = (float*)vals;
  int* ix = (int*)idx;
  int slice = (D + ranks - 1) / ranks;
  // every pointer argument has the size of a pointer whatever x's type
  void* args[] = {&x, &g, &lg, &v, &ix, &B, &D, &E, &top_k, &slice};
  return cudaLaunchKernelExC(&cfg, fn, args);
}

// `vec`: 16-byte gate loads; `ranks`: the cluster size (ops.gating_plan)
int launch(const void* x, int x_bf16, const void* gates, void* logits, void* vals, void* idx,
           int select, int P, int B, int D, int E, int top_k, int vec, int ranks,
           void* stream) {
  if (P <= 0 || B <= 0 || D <= 0 || E <= 0 || E > kMaxExperts ||
      (select && (top_k <= 0 || top_k > E)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_cluster(x, x_bf16, gates, logits, vals, idx, select, P, B, D,
                                         E, top_k, vec, ranks, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gating_topk_launch(const void* x, int x_bf16, const void* gates,
                                  void* logits, void* vals, void* idx, int P, int B,
                                  int D, int E, int top_k, int vec, int ranks, void* stream) {
  return launch(x, x_bf16, gates, logits, vals, idx, 1, P, B, D, E, top_k, vec, ranks, stream);
}

extern "C" int stacked_gating_launch(const void* x, int x_bf16, const void* gates,
                                     void* logits, int P, int B, int D, int E, int vec,
                                     int ranks, void* stream) {
  return launch(x, x_bf16, gates, logits, nullptr, nullptr, 0, P, B, D, E, 0, vec, ranks,
                stream);
}

// Registers per thread of the instantiation at `vec` for a batch of
// `batch` token rows.
extern "C" int gating_regs(int x_bf16, int select, int vec, int batch, int* regs) {
  if (regs == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, cluster_kernel(x_bf16, select, vec, rows_per_pass(batch)));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return 0;
}

// The layout constants ops.py mirrors for its plan: kThreads, kLoads,
// kMaxRows, kBufFloats, kMaxCluster.
extern "C" int gating_layout(int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  const int v[5] = {kThreads, kLoads, kMaxRows, kBufFloats, kMaxCluster};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}
