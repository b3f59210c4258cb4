// Grouped dequant products of HOBBIT decode for Hopper (sm_90a), plain C
// interface bound with ctypes (see kernels/build.py and kernels/ops.py).
//
// Replaces src/repro/kernels/dequant_matmul.py:
//   grouped_dequant_matmul_pallas  -> grouped_mmv_launch (combine = 0), and
//                                     grouped_dequant_matmul_launch
//       y[p] = x[p] @ dequant(data[slot[p]], scale[slot[p]])
//   grouped_dequant_combine_pallas -> grouped_mmv_launch (combine = 1), and
//                                     grouped_dequant_combine_launch
//       out[rows[p]] += weights[p] * (x[p] @ dequant(...)); pads carry
//       rows[p] == num_rows and are skipped; rows no pair visits are 0.
//
// What bounds it on the card: device-memory bytes.  Each (token, expert)
// pair is a single-row product against one low-precision expert matrix, so
// every packed weight byte serves at most the few pairs that picked its
// expert: Mixtral's up/gate matrix at 4 bits, group 64, is 58.7 MB of codes
// and 7.3 MB of scales (~20 us at 3.35 TB/s), its down matrix half that.
//
// Two kernels, chosen by the wrapper from the shapes
// (ops.grouped_dequant_kernel):
//
// "mmv", grouped_mmv_kernel: bf16 x 16-byte aligned, groups a multiple of 16
// up to 256, N % 16 == 0 and 16-byte aligned codes (every lo launch of the
// Mixtral and Phi-MoE serves).  The dense decode kernel's design
// (dequant_mmv_kernel, dequant_matmul.cu; building blocks in
// dequant_mmv.cuh), carried over to pairs that read experts by pool slot:
//   * Tensor cores with the operands swapped: 16 weight columns are the
//     MMA's rows, the x rows of 8 pairs its n8 columns; codes become exact
//     bf16 integers (~2 instructions per 4-bit code), a float32 partial per
//     quant group gets its scale with one FMA per accumulator.
//   * Each distinct expert is read once per launch, however many pairs
//     picked it.  After griddepcontrol.wait every warp reads the slots of
//     the pass's 8 pairs and finds the distinct ones (__match_any_sync, in
//     order of first pair); it streams, for each distinct slot in turn, its
//     run of that slot's codes, and the lanes of the pairs on another slot
//     feed zeros as their x.  One set of accumulators serves every slot:
//     a pair's column only ever adds its own slot's products.  In the
//     combine, pads (rows[p] outside 0..num_rows-1) stream nothing.
//   * Bytes in flight without a block barrier: a private ring per warp,
//     kMmvStages (2) deep, filled by TMA (the codes through a tensor map over the
//     whole pool, (S * K / pack) x N bytes, 128-byte swizzle; x through one
//     over the (P, K) bf16 rows, boxes of 8 rows, rows past P read as zero);
//     each lane copies its 16 bytes of the stage's scale rows with
//     cp.async, arriving on the same mbarrier.
//     The ring runs on across distinct slots without draining.  The maps
//     depend only on a tensor's address and shape, so the wrapper caches
//     them (the pools live the whole serve).
//   * No float32 partials in device memory and no second launch.  One
//     cluster per 128-column tile; its ranks split K in whole groups.  The
//     warps' sums are added in warp order; each rank pushes its block sums
//     with st.async into the inbox of the rank that owns the column (rank r
//     owns 1/ranks of the tile's columns), which adds them in rank order,
//     and the combine adds each output row's pairs in pair order in the
//     same epilogue.  No atomics: the result is the same on every run.
//     P > 8 runs passes of 8 pairs; the combine's later passes add to the
//     rows the same thread wrote in the earlier ones.
//   * Launched as a programmatic dependent, reading nothing of global
//     memory (codes, scales, x, slot, rows, weights) before
//     griddepcontrol.wait, and letting the next launch start its blocks
//     right after it.
//   * Rings of 2 stages let two blocks share an SM (the step loop is
//     latency-bound: 16 warps hide more than 8; deeper rings timed no
//     faster and leave room for one block).  ops.grouped_plan grows the
//     cluster while every tile's cluster fits at once (Mixtral: wi 224
//     tiles, 1 rank; wo 32 tiles, 7 ranks).
//
// "two_pass", dequant_partial_kernel + reduce_kernel: everything else
// (float32 x, unaligned x or codes, other groups).  A thread owns 16 output
// columns (one 16-byte code load per packed row), decodes in registers and
// multiplies with float32 FMAs; pass 1 splits K over blocks, each writing a
// float32 partial row, and pass 2 adds the partials in a fixed order and,
// for the combine, each row's pairs in pair order.
#include <string.h>

#include "dequant.cuh"
#include "dequant_mmv.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;           // threads per pass-1 block
constexpr int kCols = 16;               // output columns per thread
constexpr int kTileN = kThreads * kCols;
constexpr int kReduceThreads = 256;     // pass-2 threads per block

// Pass 1: part[p, c, n] = sum over K-chunk c of x[p, k] * dequant(...)[k, n].
template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads) dequant_partial_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ data,
    const float* __restrict__ scale, const int* __restrict__ slot,
    const int* __restrict__ rows, int num_rows, int K, int N, int num_slots,
    int group_size, int chunk, float* __restrict__ part) {
  constexpr int PACK = 8 / BITS;
  extern __shared__ float xs[];
  const int tile = blockIdx.x;
  const int c = blockIdx.y;
  const int p = blockIdx.z;
  const int chunks = gridDim.y;
  const int n0 = tile * kTileN + threadIdx.x * kCols;
  float* out = part + ((size_t)p * chunks + c) * N;

  // An out-of-range slot (pads included) is a fault in the caller's slot
  // bookkeeping, and the plain version raises IndexError for it: abort the
  // launch (a sticky CUDA error that the next synchronisation raises) rather
  // than drop the pair.
  const int sl = slot[p];
  if (sl < 0 || sl >= num_slots) __trap();
  // pad pair of the combine: its partial row is never read
  if (rows != nullptr && (rows[p] < 0 || rows[p] >= num_rows)) return;

  const int k0 = c * chunk;
  const XT* xp = x + (size_t)p * K + k0;
  for (int i = threadIdx.x; i < chunk; i += kThreads) xs[i] = to_f32(xp[i]);
  __syncthreads();
  if (n0 >= N) return;

  const int8_t* dp = data + (size_t)sl * (size_t)(K / PACK) * N;
  const float* sp = scale + (size_t)sl * (size_t)(K / group_size) * N;
  const int rows_per_group = group_size / PACK;
  const int groups = chunk / group_size;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int kg = k0 / group_size + g;  // global group index
    const int kp0 = (k0 + g * group_size) / PACK;
    const float* xg = xs + g * group_size;
    float gacc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) gacc[j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < rows_per_group; ++r) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(dp + (size_t)(kp0 + r) * N + n0));
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < PACK; ++i) {
        const float xv = xg[r * PACK + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          gacc[j] = fmaf(decode<BITS>(ws[j >> 2], (j & 3) * 8 + BITS * i), xv, gacc[j]);
      }
    }
    const float4* s4 = reinterpret_cast<const float4*>(sp + (size_t)kg * N + n0);
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      const float4 s = __ldg(s4 + q);
      acc[4 * q + 0] = fmaf(gacc[4 * q + 0], s.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(gacc[4 * q + 1], s.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(gacc[4 * q + 2], s.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(gacc[4 * q + 3], s.w, acc[4 * q + 3]);
    }
  }
  float4* o4 = reinterpret_cast<float4*>(out + n0);
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    o4[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// Pass 2.  rows == nullptr: out[p, n] = sum_c part[p, c, n].
// Otherwise out[r, n] = sum over pairs p with rows[p] == r, in pair order, of
// weights[p] * sum_c part[p, c, n]; a row no pair visits is written as 0.
// A group of 2^lg lanes (as many as there are chunks, up to a warp) owns one
// 4-column quad: lane l adds chunks l, l + 2^lg, ... and a fixed xor-shuffle
// tree adds the lanes, so the order never changes between runs.
__global__ void __launch_bounds__(kReduceThreads) reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ rows,
    const float* __restrict__ weights, int P, int chunks, int N, int lg,
    float* __restrict__ out) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * kReduceThreads + threadIdx.x;
  const int width = 1 << lg;
  const int lane = t & (width - 1);
  const int n = (t >> lg) * 4;
  const bool valid = n < N;  // every lane reaches the shuffles below
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < P; ++p) {
    if (rows == nullptr ? p != r : rows[p] != r) continue;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      const float* src = part + (size_t)p * chunks * N + n;
      for (int c = lane; c < chunks; c += width) {
        const float4 v = *reinterpret_cast<const float4*>(src + (size_t)c * N);
        y.x += v.x;
        y.y += v.y;
        y.z += v.z;
        y.w += v.w;
      }
    }
    for (int off = width >> 1; off > 0; off >>= 1) {
      y.x += __shfl_xor_sync(0xffffffffu, y.x, off);
      y.y += __shfl_xor_sync(0xffffffffu, y.y, off);
      y.z += __shfl_xor_sync(0xffffffffu, y.z, off);
      y.w += __shfl_xor_sync(0xffffffffu, y.w, off);
    }
    const float w = rows == nullptr ? 1.f : weights[p];
    acc.x += w * y.x;
    acc.y += w * y.y;
    acc.z += w * y.z;
    acc.w += w * y.w;
  }
  if (valid && lane == 0) *reinterpret_cast<float4*>(out + (size_t)r * N + n) = acc;
}

template <int BITS>
void launch_partial(const void* x, int x_bf16, const void* data, const void* scale,
                    const void* slot, const void* rows, int num_rows, int P, int K,
                    int N, int num_slots, int group_size, int chunk, void* part,
                    cudaStream_t s) {
  const dim3 grid((N + kTileN - 1) / kTileN, K / chunk, P);
  const size_t smem = (size_t)chunk * sizeof(float);
  if (x_bf16) {
    dequant_partial_kernel<BITS, __nv_bfloat16><<<grid, kThreads, smem, s>>>(
        (const __nv_bfloat16*)x, (const int8_t*)data, (const float*)scale,
        (const int*)slot, (const int*)rows, num_rows, K, N, num_slots, group_size,
        chunk, (float*)part);
  } else {
    dequant_partial_kernel<BITS, float><<<grid, kThreads, smem, s>>>(
        (const float*)x, (const int8_t*)data, (const float*)scale, (const int*)slot,
        (const int*)rows, num_rows, K, N, num_slots, group_size, chunk, (float*)part);
  }
}

int pack_of(int bits) { return bits == 8 ? 1 : bits == 4 ? 2 : bits == 2 ? 4 : 0; }

int launch(const void* x, int x_bf16, const void* data, const void* scale,
           const void* slot, const void* rows, const void* weights, void* part,
           void* out, int P, int K, int N, int num_slots, int num_rows, int bits,
           int group_size, int chunk, void* stream) {
  const int pack = pack_of(bits);
  if (pack == 0 || P <= 0 || K <= 0 || N <= 0 || N % kCols != 0 || group_size <= 0 ||
      group_size % pack != 0 || chunk <= 0 || chunk % group_size != 0 ||
      K % chunk != 0 || chunk * sizeof(float) > 48 * 1024 || num_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 8:
      launch_partial<8>(x, x_bf16, data, scale, slot, rows, num_rows, P, K, N, num_slots,
                        group_size, chunk, part, s);
      break;
    case 4:
      launch_partial<4>(x, x_bf16, data, scale, slot, rows, num_rows, P, K, N, num_slots,
                        group_size, chunk, part, s);
      break;
    default:
      launch_partial<2>(x, x_bf16, data, scale, slot, rows, num_rows, P, K, N, num_slots,
                        group_size, chunk, part, s);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = K / chunk;
  int lg = 0;  // lanes per 4-column quad: chunks rounded up to a power of 2, <= 32
  while ((1 << lg) < chunks && lg < 5) ++lg;
  const long threads = (long)(N / 4) << lg;
  const dim3 grid((unsigned)((threads + kReduceThreads - 1) / kReduceThreads), num_rows);
  reduce_kernel<<<grid, kReduceThreads, 0, s>>>((const float*)part, (const int*)rows,
                                                (const float*)weights, P, chunks, N, lg,
                                                (float*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core grouped decode kernel
// ---------------------------------------------------------------------------
constexpr int kPairs = 8;                     // pairs of one pass: the n8 operand
constexpr int kPairElems = kPairs * kMmvCols;  // outputs of a block per pass

constexpr int kScaleRowBytes = kMmvCols * 4;   // one group's scales of the tile
// a rank's inbox of the cluster's block sums: [source rank][pair][one of
// its ceil(128 / ranks) columns], at most 8 x (128 + 7) floats
constexpr int kInboxFloats = kPairs * (kMmvCols + kMmvMaxCluster);

// Scale rows a stage holds: the most quant groups that one stage's k16
// steps touch.  Stages start at r0 + i U steps, r0 on a group boundary, so
// where a group is a whole number of stages, or a stage a whole number of
// groups, the windows are aligned.
__host__ __device__ constexpr int grouped_scale_rows(int bits, int group_size) {
  const int u = mmv_steps_per_stage(bits);
  const int spg = group_size / 16;
  return u % spg == 0 ? u / spg : spg % u == 0 ? 1 : u / spg + 2;
}
// A warp's ring slot: the code tile, then x for the stage's k values (8
// rows, one per pair of the pass, 16 k per step), then the scale rows of
// the stage's groups.
__host__ __device__ constexpr int grouped_stage_bytes(int bits, int group_size) {
  return kMmvCodeBytes + mmv_x_bytes(bits) + grouped_scale_rows(bits, group_size) * kScaleRowBytes;
}
// Dynamic shared memory of a block: the warps' rings (code tiles first,
// 1024-byte aligned for the 128-byte swizzle, then the x tiles and the
// scale rows), their mbarriers, a pass's rows and gate weights (the
// combine's), the cluster sum's inbox and its mbarrier, and slack to align
// the base.
__host__ __device__ constexpr int grouped_smem(int bits, int group_size) {
  return 1024 + kMmvWarps * kMmvStages * (grouped_stage_bytes(bits, group_size) + 8) +
         kPairs * 8 + kInboxFloats * 4 + 8;
}
static_assert(kMmvWarps * kMmvStages * (kMmvCodeBytes + mmv_x_bytes(8)) >=
                  (kMmvWarps + 1) * kPairElems * 4,
              "the warps' sums and the pairs' fit in a ring of 2 stages");

// 4 bytes into another block's shared memory, completing on its mbarrier.
__device__ __forceinline__ void store_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// Block (rank, column tile) of kMmvThreads threads -> columns [128 y,
// +128) of y (P, N), or of out (num_rows, N) when COMBINE.  The gridDim.x
// blocks of a column tile form one cluster and split the quant groups.
// code_map: the pool's codes as an (S * K / pack) x N byte tensor, boxes of
// 32 rows x 128 columns, 128-byte swizzle; x_map: x as a P x K bf16 tensor,
// boxes of 8 rows x one stage's k values.
template <int BITS, bool COMBINE>
__global__ void __launch_bounds__(kMmvThreads, 2) grouped_mmv_kernel(
    const __grid_constant__ CUtensorMap code_map, const __grid_constant__ CUtensorMap x_map,
    const float* __restrict__ scale, const int* __restrict__ slot,
    const int* __restrict__ rows, const float* __restrict__ weights, int P, int K, int N,
    int num_slots, int num_rows, int group_size, float* __restrict__ out) {
  constexpr int PC = BITS / 2;               // pieces of a lane per k16 step
  constexpr int U = mmv_steps_per_stage(BITS);
  constexpr int ROWS = 2 * BITS;             // packed rows of a k16 step
  constexpr int XB = mmv_x_bytes(BITS);
  constexpr int XROW = XB / 8;               // bytes of one x row of a stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 8 rows
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ranks = gridDim.x;
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * kMmvCols;
  const int col = n0 + 16 * g;               // the lane's 16 columns
  const int spg = group_size / 16;           // k16 steps of a group
  const int groups = K / group_size;
  const int kp = K / (8 / BITS);             // packed rows of one pool slot
  // the rank's whole groups in k16 steps [r0, r1), cut into stages of U
  // steps; the warps take runs of whole stages
  const int r0 = rank * groups / ranks * spg;
  const int r1 = (rank + 1) * groups / ranks * spg;
  const int rank_stages = (r1 - r0 + U - 1) / U;
  const int st0 = warp * rank_stages / kMmvWarps;
  const int n_stages = (warp + 1) * rank_stages / kMmvWarps - st0;
  const int s0 = r0 + st0 * U;               // the warp's first step
  const int steps = max(0, min(r1, s0 + n_stages * U) - s0);

  const int srows = grouped_scale_rows(BITS, group_size);
  const int SB = srows * kScaleRowBytes;     // scale bytes of a stage
  const int ring = kMmvStages * grouped_stage_bytes(BITS, group_size);
  unsigned char* codes = smem + warp * kMmvStages * kMmvCodeBytes;
  unsigned char* xs = smem + kMmvWarps * kMmvStages * kMmvCodeBytes + warp * kMmvStages * XB;
  unsigned char* ss =
      smem + kMmvWarps * kMmvStages * (kMmvCodeBytes + XB) + warp * kMmvStages * SB;
  const uint32_t codes_s = smem_u32(codes);
  const uint32_t xs_s = smem_u32(xs);
  const uint32_t ss_s = smem_u32(ss);
  const uint32_t bars = smem_u32(smem + kMmvWarps * ring) + warp * kMmvStages * 8;
  if (lane == 0) {
    if (warp == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&code_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
    }
    // a stage completes on lane 0's arrival with its TMA bytes and on the
    // 32 lanes' arrivals as their scale copies land
    for (int i = 0; i < kMmvStages; ++i) mbar_init(bars + 8 * i, 1 + 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // piece i of step u of a stage: packed row u ROWS + PC t + i of the code
  // tile, its 16-byte chunk g swizzled by the row; x row g (pair g of the
  // pass), k 16 u + 4t .. + 3 of the x tile
  auto code_at = [&](int u, int i) {
    const int r = u * ROWS + PC * t + i;
    return r * kMmvCols + ((g ^ (r & 7)) << 4);
  };
  auto x_at = [&](int u) { return g * XROW + u * 32 + 8 * t; };

  float acc[8][4], part[8][4];
  float* red = reinterpret_cast<float*>(smem);      // [warp][pair][column]
  float* ysum = red + kMmvWarps * kPairElems;       // [pair][column], the combine's
  // the rank's columns of the tile in the epilogue
  const int c0 = rank * kMmvCols / ranks;
  const int cw = (rank + 1) * kMmvCols / ranks - c0;
  const int cw_max = (kMmvCols + ranks - 1) / ranks;

  // the pass's rows and gate weights (the combine's), staged once per pass
  int* s_rows = reinterpret_cast<int*>(smem + kMmvWarps * (ring + kMmvStages * 8));
  float* s_w = reinterpret_cast<float*>(s_rows + kPairs);
  // the rank's inbox, filled by every rank of the cluster with st.async,
  // each store completing its 4 bytes on the inbox's mbarrier
  float* inbox = s_w + kPairs;
  const uint32_t inbox_s = smem_u32(inbox);
  const uint32_t full = smem_u32(inbox + kInboxFloats);
  if (ranks > 1) {
    if (threadIdx.x == 0) {
      mbar_init(full, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();                // waited on before the first remote store
  }

  // Launched as the programmatic dependent of the kernel before it: no
  // global read (codes, scales, x, slot, rows, weights) before that
  // kernel's writes are seen.
  griddep_wait();
  // the next launch may start its blocks (they wait in their own
  // griddepcontrol.wait until this grid is done)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  uint32_t it = 0;                           // stages this warp has consumed
  uint32_t ld = 0;                           // stages this warp has asked for
  for (int pb = 0; pb < P; pb += kPairs) {
    const int np = min(kPairs, P - pb);
    // lane l < np: the slot of pair pb + l; -1 for the other lanes and, in
    // the combine, for pads.  Every slot, a pad's too, must be in range.
    int ps = -1;
    if (lane < np) {
      const int s = slot[pb + lane];
      if (s < 0 || s >= num_slots) __trap();
      ps = s;
      if (COMBINE) {
        const int r = rows[pb + lane];
        if (r < 0 || r >= num_rows) ps = -1;
        if (warp == 0) {
          s_rows[lane] = r;
          s_w[lane] = weights[pb + lane];
        }
      }
    }
    // the pass's distinct live slots (its jobs), in order of their first
    // pair; lane d < jobs holds job d's slot in jslot
    const unsigned same = __match_any_sync(0xffffffffu, ps);
    const unsigned firsts = __ballot_sync(0xffffffffu, ps >= 0 && __ffs(same) - 1 == lane);
    unsigned rest = firsts;
    for (int i = 0; i < min(lane, kPairs); ++i) rest &= rest - 1;
    const int jslot = __shfl_sync(0xffffffffu, ps, rest ? __ffs(rest) - 1 : 0);
    const int total = __popc(firsts) * n_stages;     // stages of the pass
    const int mine = __shfl_sync(0xffffffffu, ps, g);  // slot of the lane's pair

    // the pass's next stage (job ld_d, its stage ld_st) into ring position
    // ld % kMmvStages: lane 0 asks for the code and x tiles by TMA, and every
    // lane copies its 16 bytes of each scale row of the stage's groups
    // (lanes 4g .. 4g + 3 the 16 columns of lane group g), all completing
    // on the position's mbarrier
    int ld_d = 0, ld_st = 0;
    auto load_next = [&]() {
      const int sl = __shfl_sync(0xffffffffu, jslot, ld_d);
      const int pos = ld % kMmvStages;
      const int a = s0 + ld_st * U;          // the stage's first step
      const int ga = a / spg;
      const int nq = (min(a + U, s0 + steps) - 1) / spg - ga + 1;
      const uint32_t bar = bars + 8 * pos;
      __syncwarp();                          // every lane is done with the position
      const bool ok = col + 4 * t < N;
      const float* sp = ok ? scale + ((size_t)sl * groups + ga) * N + col + 4 * t : scale;
      const uint32_t sd = ss_s + pos * SB + (16 * g + 4 * t) * 4;
      cp_async16(sd, sp, ok ? 16 : 0);
      for (int q = 1; q < nq; ++q)
        cp_async16(sd + q * kScaleRowBytes, ok ? sp + (size_t)q * N : scale, ok ? 16 : 0);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
                   : "memory");
      if (lane == 0) {
        // the lanes' reads of the position come before the copies that refill it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, kMmvCodeBytes + XB);
        tma_2d(codes_s + pos * kMmvCodeBytes, &code_map, n0, sl * kp + a * ROWS, bar);
        tma_2d(xs_s + pos * XB, &x_map, a * 16, pb, bar);
      }
      if (++ld_st == n_stages) {
        ld_st = 0;
        ++ld_d;
      }
      ++ld;
    };

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;
    for (int i = 0; i < min(kMmvStages - 1, total); ++i) load_next();
    int d = 0, st = 0, left = 0;
    bool take = false;
    for (int i = 0; i < total; ++i, ++it) {
      if (st == 0) {                         // the next job: a distinct slot's run
        take = mine == __shfl_sync(0xffffffffu, jslot, d);
        left = spg - s0 % spg;               // steps left in the current group
      }
      const int pos = it % kMmvStages;
      mbar_wait(bars + 8 * pos, (it / kMmvStages) & 1);
      // refill the position read in the previous iteration
      if (i + kMmvStages - 1 < total) load_next();
      const unsigned char* ct = codes + pos * kMmvCodeBytes;
      const unsigned char* xt = xs + pos * XB;
      // the scale rows of the stage, from its first step's group on
      const float* srow = reinterpret_cast<const float*>(ss + pos * SB) + 16 * g -
                          (s0 + st * U) / spg * kMmvCols;
      auto step = [&](int u) {
        const int s = st * U + u;
        uint32_t w[PC][4];
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(ct + code_at(u, q));
          w[q][0] = v.x;
          w[q][1] = v.y;
          w[q][2] = v.z;
          w[q][3] = v.w;
        }
        uint2 xb = *reinterpret_cast<const uint2*>(xt + x_at(u));
        if (!take) xb = make_uint2(0u, 0u);  // the lane's pair reads another slot
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t a[4];
          mmv_a<BITS>(w, j, a);
          mma_bf16(part[j], a[0], a[1], a[2], a[3], xb.x, xb.y);
        }
        if (--left == 0 || s + 1 == steps) {   // the group, or the warp's run, ends
          // c0, c1 of tile j are column 2j (pairs 2t, 2t + 1), c2, c3 column 2j + 1
          const float4* s4 = reinterpret_cast<const float4*>(srow + (s0 + s) / spg * kMmvCols);
          const float4 sc[4] = {s4[0], s4[1], s4[2], s4[3]};
          const float sv[16] = {sc[0].x, sc[0].y, sc[0].z, sc[0].w, sc[1].x, sc[1].y,
                                sc[1].z, sc[1].w, sc[2].x, sc[2].y, sc[2].z, sc[2].w,
                                sc[3].x, sc[3].y, sc[3].z, sc[3].w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[j][e] = fmaf(part[j][e], sv[2 * j + (e >> 1)], acc[j][e]);
              part[j][e] = 0.f;
            }
          left = spg;
        }
      };
      if (steps - st * U >= U) {             // a whole stage
#pragma unroll
        for (int u = 0; u < U; ++u) step(u);
      } else {                               // the run's last, partial stage
        for (int u = 0; u < steps - st * U; ++u) step(u);
      }
      if (++st == n_stages) {
        st = 0;
        ++d;
      }
    }

    // the warps' sums, added in warp order
    __syncthreads();                         // every warp is done with its ring
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* r = red + (warp * kPairs + 2 * t) * kMmvCols + 16 * g + 2 * j;
      *reinterpret_cast<float2*>(r) = make_float2(acc[j][0], acc[j][2]);
      *reinterpret_cast<float2*>(r + kMmvCols) = make_float2(acc[j][1], acc[j][3]);
    }
    __syncthreads();
    if (ranks == 1) {
      // y of the pass's pairs: in `out` (the matmul) or in ysum (the combine)
      for (int e = threadIdx.x; e < np * kMmvCols; e += kMmvThreads) {
        float v = 0.f;
#pragma unroll
        for (int wi = 0; wi < kMmvWarps; ++wi) v += red[wi * kPairElems + e];
        if (COMBINE) {
          ysum[e] = v;
        } else {
          const int n = n0 + e % kMmvCols;
          if (n < N) out[(size_t)(pb + e / kMmvCols) * N + n] = v;
        }
      }
    } else {
      // each block sum goes to the inbox of the rank that owns its column
      if (pb == 0) cluster_wait();           // every block of the cluster has started
      for (int e = threadIdx.x; e < np * kMmvCols; e += kMmvThreads) {
        float v = 0.f;
#pragma unroll
        for (int wi = 0; wi < kMmvWarps; ++wi) v += red[wi * kPairElems + e];
        const int m = e / kMmvCols;
        const int c = e - m * kMmvCols;
        const int q = ((c + 1) * ranks - 1) / kMmvCols;   // owner: q 128 / ranks <= c
        const int slot_f = (rank * kPairs + m) * cw_max + c - q * kMmvCols / ranks;
        store_async(map_rank(inbox_s + 4u * (uint32_t)slot_f, q), v, map_rank(full, q));
      }
      if (threadIdx.x == 0)
        asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         full),
                     "r"(ranks * np * cw * 4)
                     : "memory");
      mbar_wait_cluster(full, (uint32_t)((pb / kPairs) & 1));
      // the ranks' sums of the rank's columns, in rank order
      for (int e = threadIdx.x; e < np * cw; e += kMmvThreads) {
        const int m = e / cw;
        const int cl = e - m * cw;
        float v = 0.f;
        for (int q = 0; q < ranks; ++q) v += inbox[(q * kPairs + m) * cw_max + cl];
        if (COMBINE) {
          ysum[m * kMmvCols + c0 + cl] = v;
        } else if (n0 + c0 + cl < N) {
          out[(size_t)(pb + m) * N + n0 + c0 + cl] = v;
        }
      }
    }
    if (COMBINE) {
      // each output row of the rank's columns: its pairs in pair order,
      // after what the earlier passes left there; rows no pair visits are 0
      __syncthreads();
      for (int e = threadIdx.x; e < num_rows * cw; e += kMmvThreads) {
        const int r = e / cw;
        const int n = n0 + c0 + e - r * cw;
        if (n >= N) continue;
        float* o = out + (size_t)r * N + n;
        float v = pb == 0 ? 0.f : *o;
        for (int m = 0; m < np; ++m)
          if (s_rows[m] == r) v += s_w[m] * ysum[m * kMmvCols + n - n0];
        *o = v;
      }
    }
    if (pb + kPairs < P) {
      // the generic writes above come before the next pass's TMA copies
      // into the same shared memory, and every rank has read its inbox
      // before the next pass refills it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (ranks > 1)
        cluster_sync();
      else
        __syncthreads();
    }
  }
}

// Lets every instantiation take up to the card's limit of dynamic shared
// memory (once per process).
template <int BITS, bool COMBINE>
cudaError_t grouped_prepare() {
  static cudaError_t err = cudaFuncSetAttribute(grouped_mmv_kernel<BITS, COMBINE>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                max_smem());
  return err;
}

template <int BITS, bool COMBINE>
cudaError_t launch_grouped(const CUtensorMap& code_map, const CUtensorMap& x_map,
                           const void* scale, const void* slot, const void* rows,
                           const void* weights, void* out, int P, int K, int N, int num_slots,
                           int num_rows, int group_size, int ranks, cudaStream_t s) {
  cudaError_t err = grouped_prepare<BITS, COMBINE>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a programmatic dependent of the kernel before it: its blocks start as
  // that kernel's blocks leave (griddep_wait orders every global read)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + kMmvCols - 1) / kMmvCols, 1);
  cfg.blockDim = dim3(kMmvThreads, 1, 1);
  cfg.dynamicSmemBytes = grouped_smem(BITS, group_size);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, grouped_mmv_kernel<BITS, COMBINE>, code_map, x_map,
                            (const float*)scale, (const int*)slot, (const int*)rows,
                            (const float*)weights, P, K, N, num_slots, num_rows, group_size,
                            (float*)out);
}

template <int BITS>
cudaError_t launch_grouped_bits(int combine, const CUtensorMap& code_map,
                                const CUtensorMap& x_map, const void* scale, const void* slot,
                                const void* rows, const void* weights, void* out, int P, int K,
                                int N, int num_slots, int num_rows, int group_size, int ranks,
                                cudaStream_t s) {
  if (combine)
    return launch_grouped<BITS, true>(code_map, x_map, scale, slot, rows, weights, out, P, K,
                                      N, num_slots, num_rows, group_size, ranks, s);
  return launch_grouped<BITS, false>(code_map, x_map, scale, slot, rows, weights, out, P, K, N,
                                     num_slots, num_rows, group_size, ranks, s);
}

// Clusters of `ranks` blocks of `smem` bytes of dynamic shared memory the
// card runs at once, registers per thread and local memory per thread
// (spills).
template <int BITS, bool COMBINE>
cudaError_t grouped_info(int ranks, int smem, int* clusters, int* regs, int* local) {
  cudaError_t err = grouped_prepare<BITS, COMBINE>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1, 1);
  cfg.blockDim = dim3(kMmvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, grouped_mmv_kernel<BITS, COMBINE>, &cfg);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, grouped_mmv_kernel<BITS, COMBINE>);
  if (err == cudaSuccess) {
    *regs = fa.numRegs;
    *local = (int)fa.localSizeBytes;
  }
  return err;
}

}  // namespace

extern "C" int grouped_dequant_matmul_launch(const void* x, int x_bf16, const void* data,
                                             const void* scale, const void* slot,
                                             void* part, void* out, int P, int K, int N,
                                             int num_slots, int bits, int group_size,
                                             int chunk, void* stream) {
  return launch(x, x_bf16, data, scale, slot, nullptr, nullptr, part, out, P, K, N,
                num_slots, P, bits, group_size, chunk, stream);
}

extern "C" int grouped_dequant_combine_launch(const void* x, int x_bf16, const void* data,
                                              const void* scale, const void* slot,
                                              const void* rows, const void* weights,
                                              void* part, void* out, int P, int K, int N,
                                              int num_slots, int num_rows, int bits,
                                              int group_size, int chunk, void* stream) {
  return launch(x, x_bf16, data, scale, slot, rows, weights, part, out, P, K, N,
                num_slots, num_rows, bits, group_size, chunk, stream);
}

// A TMA tensor map for the tensor-core kernel, written into `map` (128
// bytes): kind 0 the pool's codes, rows = S * K / pack, cols = N; kind 1 x,
// rows = P, cols = K (bf16).  It depends only on the address and shape,
// so the caller may keep it for as long as the tensor lives.
extern "C" int grouped_mmv_tensor_map(const void* base, int kind, int rows, int cols, int bits,
                                      void* map) {
  if (pack_of(bits) == 0 || map == nullptr || rows <= 0 || cols <= 0 || kind < 0 || kind > 1 ||
      (uintptr_t)base % 16 != 0 || cols % (kind == 0 ? 16 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const cudaError_t err =
      kind == 0 ? tensor_map(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols,
                             kMmvStageRows, kMmvCols, CU_TENSOR_MAP_SWIZZLE_128B)
                : tensor_map(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, kPairs,
                             16 * mmv_steps_per_stage(bits), CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess) memcpy(map, &m, sizeof(m));
  return (int)err;
}

// The tensor-core kernel: y (P, N) f32, or out (num_rows, N) f32 when
// `combine`; code_map and x_map from grouped_mmv_tensor_map over the pool's
// codes and over x (P, K) bf16; scale (S, K / group, N) f32; slot, rows
// (P,) int32; weights (P,) f32.  K is split over a cluster of `ranks`
// blocks (1 to 8) in whole groups.
extern "C" int grouped_mmv_launch(const void* code_map, const void* x_map, const void* scale,
                                  const void* slot, const void* rows, const void* weights,
                                  void* out, int P, int K, int N, int num_slots, int num_rows,
                                  int bits, int group_size, int combine, int ranks,
                                  void* stream) {
  if (pack_of(bits) == 0 || code_map == nullptr || x_map == nullptr || P <= 0 || K <= 0 ||
      N <= 0 || N % 16 != 0 || group_size <= 0 || group_size % 16 != 0 || group_size > 256 ||
      K % group_size != 0 || ranks < 1 || ranks > kMmvMaxCluster || ranks > K / group_size ||
      grouped_smem(bits, group_size) > max_smem() || num_slots <= 0 ||
      (uintptr_t)scale % 16 != 0 ||
      (combine && (num_rows <= 0 || rows == nullptr || weights == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap cm, xm;
  memcpy(&cm, code_map, sizeof(cm));
  memcpy(&xm, x_map, sizeof(xm));
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 8:
      return (int)launch_grouped_bits<8>(combine, cm, xm, scale, slot, rows, weights, out, P,
                                         K, N, num_slots, num_rows, group_size, ranks, s);
    case 4:
      return (int)launch_grouped_bits<4>(combine, cm, xm, scale, slot, rows, weights, out, P,
                                         K, N, num_slots, num_rows, group_size, ranks, s);
    default:
      return (int)launch_grouped_bits<2>(combine, cm, xm, scale, slot, rows, weights, out, P,
                                         K, N, num_slots, num_rows, group_size, ranks, s);
  }
}

// For the tensor-core kernel's instantiation at `group_size`: clusters of
// `ranks` blocks the card runs at once (cudaOccupancyMaxActiveClusters;
// at ranks 1, blocks), registers and local memory (spills) per thread, and
// the dynamic shared memory of a block.
extern "C" int grouped_mmv_info(int bits, int combine, int group_size, int ranks,
                                int* clusters, int* regs, int* local, int* smem) {
  if (pack_of(bits) == 0 || clusters == nullptr || regs == nullptr || local == nullptr ||
      smem == nullptr || ranks < 1 || ranks > kMmvMaxCluster || group_size <= 0 ||
      group_size % 16 != 0 || group_size > 256 || grouped_smem(bits, group_size) > max_smem())
    return (int)cudaErrorInvalidValue;
  *smem = grouped_smem(bits, group_size);
  cudaError_t err;
  switch (bits * 2 + (combine ? 1 : 0)) {
    case 16: err = grouped_info<8, false>(ranks, *smem, clusters, regs, local); break;
    case 17: err = grouped_info<8, true>(ranks, *smem, clusters, regs, local); break;
    case 8: err = grouped_info<4, false>(ranks, *smem, clusters, regs, local); break;
    case 9: err = grouped_info<4, true>(ranks, *smem, clusters, regs, local); break;
    case 4: err = grouped_info<2, false>(ranks, *smem, clusters, regs, local); break;
    default: err = grouped_info<2, true>(ranks, *smem, clusters, regs, local); break;
  }
  return (int)err;
}

// The tensor-core kernel's layout constants, in the order ops.py mirrors
// them: column tile, pairs per pass, largest cluster, warps per block,
// packed rows per stage.
extern "C" int grouped_mmv_layout(int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  const int v[5] = {kMmvCols, kPairs, kMmvMaxCluster, kMmvWarps, kMmvStageRows};
  memcpy(out, v, sizeof(v));
  return 0;
}
