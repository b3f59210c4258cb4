// Dense dequant-matmul for Hopper (sm_90a), plain C interface bound with
// ctypes (see kernels/build.py and kernels/ops.py).
//
// Replaces src/repro/kernels/dequant_matmul.py:
//   dequant_matmul_pallas -> dequant_matmul_launch
//       y (M, N) float32 = x (M, K) @ dequant(data (K/pack, N), scale (K/G, N))
//   with x bfloat16 or float32, codes of 8, 4 or 2 bits (dequant.cuh), any M
//   and any N that is a multiple of 4: the ragged edge is masked, where the
//   Pallas wrapper pads x, data and scale to its blocks.
//
// Three kernels, chosen by the wrapper from the shapes (ops.dequant_mm_kernel):
//
// "mmv", dequant_mmv_kernel: decode, M <= 4 rows of 16-byte-aligned bf16 x
// with groups a multiple of 16 up to 256 (every decode product of the
// quantized Granite serve).  Each packed weight byte serves at most 4 rows,
// so device-memory bytes bound it: Granite's FFN up/gate matrix, 2048 x
// 16384 at 4 bits, is 16.8 MB of codes and 1 MB of scales, ~5.4 us at 3.35
// TB/s; the down matrix, 8192 x 2048, half of that.  The gemv kernel below
// spends ~8 instructions per 4-bit code (decode, scale, 4 FFMAs of which 3
// run on zero rows at M = 1), reads 4 bytes per lane and load, and at wo
// writes float32 partials for a second launch.  This kernel:
//   * Multiply-adds on tensor cores with the operands swapped: y^T = W^T x^T
//     on mma.sync m16n8k16.  Sixteen weight columns are the MMA's rows, the
//     <= 4 rows of x its n8 columns (4-7 are zero).  A lane (g, t) owns the
//     16 columns [16g, +16) of the block's 128 and the k values 4t .. 4t + 3
//     of each k16 step; m16 tile j maps its rows g and g + 8 to the lane's
//     columns 2j and 2j + 1, and the MMA's k pairs (2t, 2t + 1) and (2t + 8,
//     2t + 9) to k 4t, 4t + 1 and 4t + 2, 4t + 3, so that B is one 8-byte
//     load of x and each A register is two codes of one column from one
//     packed byte (4 and 2 bits) or two packed rows (8 bits).
//   * Codes become exact bf16 integers as in the "mma" kernel below: a byte
//     permute, one LOP3 and one bf16x2 subtraction per pair at 4 and 2 bits
//     (~2 instructions per 4-bit code in all, against ~8), through float32
//     at 8 bits.  Per quant group a warp accumulates into a zeroed float32
//     partial and adds partial * scale[group, n] to its output with one FMA
//     per accumulator: a scale folded into a bf16 weight would miss the
//     card's tolerance.
//   * Bytes in flight without a block barrier: each of the 8 warps streams
//     its own run of k16 steps through a private 2-stage ring.  Lane 0 asks
//     for a stage (32 packed rows x 128 columns of codes, 4 KB, and the
//     stage's x) with two TMA tile copies completing on the stage's
//     mbarrier; the code tile lands with the 128-byte swizzle, so the lanes'
//     16-byte reads are free of bank conflicts.  On the H100 the same ring
//     fed by each lane's own 16-byte cp.async copies kept every SM well
//     below its share of the bandwidth, with or without the compute; TMA
//     tiles took a quarter off the kernel, and two stages of 4 KB beat
//     three or four of 2 KB (more bytes in flight made the kernel slower).
//     Those three comparisons come from ablations that no script of the repo
//     reruns; they are unverified here.  The tensor maps need N % 16 == 0
//     and 16-byte aligned codes: other decode shapes go to the gemv kernel.
//   * Launched as a programmatic dependent: a block starts and sets up its
//     mbarriers while the kernel before it drains, and reads nothing of
//     global memory (codes, scales, x) before griddepcontrol.wait, so that
//     a kernel writing the weights just before it is seen whole.
//   * No partials in device memory and no second launch.  Where N alone
//     fills the card (wi: 128 column tiles) a block owns a column tile and
//     all of K; where it does not (wo: 16 tiles) K is split in whole groups
//     across the blocks of a thread-block cluster, whose block sums are
//     added through distributed shared memory in rank order.  Inside a
//     block the warps' sums are added in warp order.  No atomics: the
//     result is the same on every run.  The cluster grows only while every
//     tile's cluster runs at once with one block per SM
//     (ops.dequant_mm_splits): the H100 holds 15 clusters of 7 or 8 that
//     way, so wo's 16 tiles split 6 ways.  chip_smoke.py phase 3c times wo
//     at every cluster size beside the chosen one.
//   * What bounds it (PERF.md): not the bytes alone.  It is barely faster
//     with its weights warm in L2 than cold, and wo takes as long as wi on
//     half the bytes.  The candidates, not measured apart: a block's wait
//     for its first stage, and the decode's ALU work (two half-rate ALU
//     instructions per byte) that the TMA waits of 8 warps per SM do not
//     fully hide.
//
// "gemv", dequant_mm_kernel: whatever the tensor-core kernels do not take
// (float32 x, bf16 x off 16-byte alignment, groups that are not a multiple
// of 16 or are above 256); correct at any M.  Float32 FMAs:
//   * A block of 128 threads owns 4 rows and 128 columns; a lane owns 4
//     consecutive columns and reads them with one 4-byte load per packed
//     row, so a warp reads 128 contiguous bytes.  The 4 warps take
//     interleaved packed rows of the block's K range and each loads a batch
//     of rows before it uses them (bytes in flight).
//   * Each packed word is decoded once, in registers (magic-number decode of
//     dequant.cuh), scaled by its group's scale (a float4 per lane, reloaded
//     only when the group changes), and used for all rows: x is staged in
//     shared memory as float32, [k][row], so the values of one k are a
//     broadcast float4 load.  float32 FMAs accumulate.
//   * The K range runs in stages of whole quant groups (at most 512 k); the
//     4 warps' partial sums are added in warp order through shared memory.
//
// "mma", dequant_mma_kernel: chunked prefill (M > 4 rows, bf16 x, group a
// multiple of 16 up to 256).  Each decoded weight serves 64 rows, so the
// multiply-adds bound it (64 x 2048 x 16384 is 4.3 GFLOP: 4.3 us at the
// 989 TFLOP/s of the bf16 tensor cores, 64 us at the 67 TFLOP/s of float32
// FMAs).  mma.sync runs below the wgmma rate those peaks assume, and the
// B-fragment decode, 3 instructions per bf16 pair, shares its issue slots.
//   * Exact on tensor cores: a code of 8, 4 or 2 bits is an integer in
//     [-128, 127], which bf16 holds exactly, and bf16 x times a bf16 integer
//     is exact in the float32 accumulator of mma.sync m16n8k16.  The group
//     scale stays out of the MMA: per quant group a warp accumulates x . code
//     into a zeroed float32 partial, then adds partial * scale[group, n] to
//     its output accumulator with one float32 FMA per element.  Folding the
//     scale into a bf16 weight would round each weight by 2^-9 (~1e-3 on
//     outputs of magnitude 1, 10x the card's tolerance of 1e-4).
//   * A block of 256 threads owns 64 rows x 128 columns; warp (wm, wn) of
//     the 2 x 4 warps owns rows [32 wm, +32) and columns [32 wn, +32): two
//     m16 tiles by four n8 tiles of accumulators.  124-127 registers, so two
//     blocks share an SM where their shared memory fits (4 and 2 bits at
//     group 128; an 8-bit stage, or the 8-16 scale rows of groups 16-32,
//     leave room for one).
//   * The K loop runs through a 2-stage cp.async ring, a stage holding 256
//     k values (two groups of 128) with one block barrier per stage: the x
//     tile (64 rows, bf16, rows at a +16-byte stride so that ldmatrix is
//     free of bank conflicts; rows past M zero-filled), the packed code tile
//     (rows of 128 bytes at a +32-byte stride, in 16-byte pieces, or 4-byte
//     words when N % 16 != 0) and the groups' scale rows.  Columns past N
//     are zero-filled and never stored.  Each thread's share of the copies
//     is worked out once before the loop, so a stage costs it a few
//     instructions per copy (indices computed per copy cost as many
//     instructions as the MMAs).
//   * A fragments by ldmatrix.x4 from the x tile.  B fragments are decoded
//     in registers straight from the code tile, with no second pass through
//     shared memory.  The n8 tiles interleave the columns: column c of n8
//     tile j is the warp's column 4c + j, so a lane reads the 4 columns of
//     its 4 tiles with one 4-byte load, and its accumulators cover 8
//     consecutive columns (two float4 scales, two float4 stores per row).
//     At 4 and 2 bits a lane's two k values of one column sit in one byte:
//     a byte permute puts them in the two halves of a word, one LOP3 masks
//     them, flips their sign bits and sets the bf16 exponent of 128, and a
//     bf16x2 subtraction of 128 + 2^(bits-1) leaves the exact codes.  8-bit
//     codes do not fit the 7-bit mantissa: they go through float32
//     (dequant.cuh's decode) and one cvt to bf16x2.
//   * Too few blocks (Granite's wo, N = 2048, is 16 column tiles at M = 64):
//     the wrapper splits K over gridDim.z in whole groups until the grid
//     fills the blocks per SM that the occupancy calculator reports for the
//     instantiation and group (two blocks of one SM overlap each other's
//     stage barriers).
//
// Splits (gemv and mma kernels): each split writes a float32 partial and a
// second kernel adds the splits in split order.  No atomics: the result is
// the same on every run.
#include <cooperative_groups.h>
#include <cuda.h>

#include "dequant.cuh"
#include "dequant_mmv.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;                // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                  // output columns of a block, 4 per lane
constexpr int kStageK = kWarps * kTileN;     // 512: the most k values of x staged
constexpr int kSumThreads = 256;
constexpr int kGemvRows = 4;                 // rows of a gemv block (one float4 of x)

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads) dequant_mm_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ data,
    const float* __restrict__ scale, int M, int K, int N, int group_size,
    int groups_per_split, float* __restrict__ dst) {
  constexpr int PACK = 8 / BITS;
  constexpr int kBatch = 8;                  // packed rows loaded before use
  // x stage [k][row]; after the K loop the warps' sums [warp][row][column]
  // (kWarps * kTileN == kStageK, so both fit)
  __shared__ __align__(16) float xs[kStageK * kGemvRows];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kGemvRows;
  const int n0 = blockIdx.y * kTileN + lane * 4;
  const bool col_ok = n0 < N;                // N % 4 == 0: all 4 columns or none
  const int groups = K / group_size;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const int stage_groups = kStageK / group_size;
  const int rows_per_group = group_size / PACK;

  float acc[kGemvRows][4];
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  }

  for (int gs = g_begin; gs < g_end; gs += stage_groups) {
    const int kn = min(stage_groups, g_end - gs) * group_size;   // k values staged
    const int k0 = gs * group_size;
    __syncthreads();                         // the last stage's readers are done
    for (int i = threadIdx.x; i < kn * kGemvRows; i += kThreads) {
      const int m = i / kn;
      const int kk = i - m * kn;
      xs[kk * kGemvRows + m] = m0 + m < M ? to_f32(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int rows = kn / PACK;              // packed rows of this stage
    const int8_t* dp = data + (size_t)(k0 / PACK) * N + n0;
    int gnext = 0;                           // first packed row of the next group
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = warp; r0 < rows; r0 += kWarps * kBatch) {
      uint32_t w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * kWarps;
        w[u] = r < rows ? __ldg(reinterpret_cast<const uint32_t*>(dp + (size_t)r * N)) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * kWarps;
        if (r >= rows) break;                // the same for the whole warp
        if (r >= gnext) {                    // a new quant group
          const int gi = r / rows_per_group;
          gnext = (gi + 1) * rows_per_group;
          s = __ldg(reinterpret_cast<const float4*>(scale + (size_t)(gs + gi) * N + n0));
        }
#pragma unroll
        for (int i = 0; i < PACK; ++i) {
          const float wv[4] = {decode<BITS>(w[u], BITS * i) * s.x,
                               decode<BITS>(w[u], 8 + BITS * i) * s.y,
                               decode<BITS>(w[u], 16 + BITS * i) * s.z,
                               decode<BITS>(w[u], 24 + BITS * i) * s.w};
          // the block's 4 rows at this k: one broadcast float4
          const float4 xv = *reinterpret_cast<const float4*>(xs + (r * PACK + i) * kGemvRows);
          const float xm[kGemvRows] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int m = 0; m < kGemvRows; ++m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xm[m], wv[j], acc[m][j]);
          }
        }
      }
    }
  }

  // add the warps' sums in warp order; thread t writes column t of the tile
  __syncthreads();
  float* red = xs;
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m)
    *reinterpret_cast<float4*>(red + (warp * kGemvRows + m) * kTileN + lane * 4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = blockIdx.y * kTileN + threadIdx.x;
  if (n >= N) return;
  float* out = dst + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m) {
    if (m0 + m >= M) break;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[(wi * kGemvRows + m) * kTileN + threadIdx.x];
    out[(size_t)(m0 + m) * N + n] = v;
  }
}

// out[i] = sum over s, in order, of part[s][i]; float4 per thread.
__global__ void __launch_bounds__(kSumThreads) split_sum_kernel(
    const float4* __restrict__ part, int splits, size_t quads, float4* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= quads) return;
  float4 acc = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 v = part[(size_t)s * quads + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[i] = acc;
}


// ---------------------------------------------------------------------------
// tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 256;             // 8 warps: 2 (rows) x 4 (columns)
constexpr int kMmaRows = 64;                 // rows of a block
constexpr int kMmaCols = 128;                // columns of a block
constexpr int kMmaStages = 2;                // ring stages
constexpr int kMmaStageK = 256;              // k values a stage holds (whole groups)
constexpr int kMmaMaxGroup = 256;            // largest group (one per stage)
constexpr int kCodeRow = kMmaCols + 32;      // code tile row stride in bytes

// Quant groups of one stage, its x row stride and its bytes: x tile, code
// tile, scale rows.
__host__ __device__ constexpr int mma_gps(int group) {
  return group < kMmaStageK ? kMmaStageK / group : 1;
}
__host__ __device__ constexpr int mma_x_row(int group) { return 2 * mma_gps(group) * group + 16; }
__host__ __device__ constexpr int mma_code_bytes(int group, int pack) {
  return mma_gps(group) * group / pack * kCodeRow;
}
__host__ __device__ constexpr int mma_stage_bytes(int group, int pack) {
  return kMmaRows * mma_x_row(group) + mma_code_bytes(group, pack) +
         mma_gps(group) * kMmaCols * 4;
}

// 4 bytes global -> shared, asynchronous; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// B fragments of one k16 step for the lane's 4 n8 tiles: b[j][0] holds the
// codes of k 2t, 2t + 1 and b[j][1] those of k 2t + 8, 2t + 9 (t = lane & 3)
// of column `col + j` of the code tile `ct` (the lane's word of 4 columns),
// as exact bf16 integers, the lower k in the low half.
template <int BITS>
__device__ __forceinline__ void load_b(const unsigned char* ct, int kk, int col, int t,
                                       uint32_t (&b)[4][2]) {
  constexpr int PACK = 8 / BITS;
  if constexpr (BITS == 8) {
    // one packed row per k: rows 16 kk + 2t, +1 and 16 kk + 2t + 8, +9
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* r = ct + (16 * kk + 2 * t + 8 * h) * kCodeRow + col;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r + kCodeRow);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(decode<8>(w0, 8 * j), decode<8>(w1, 8 * j));
        b[j][h] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  } else {
    // k 2t, 2t + 1 are fields s, s + 1 of one byte of packed row (16 kk +
    // 2t) / PACK, s = 2t % PACK; k 2t + 8, 2t + 9 the same fields 8 / PACK
    // rows further on
    constexpr uint32_t kMask = ((1u << BITS) - 1) * 0x00010001u;
    constexpr uint32_t kBase = (0x4300u | (1u << (BITS - 1))) * 0x00010001u;
    constexpr uint32_t kOff = (0x4300u | 0x80u >> (8 - BITS)) * 0x00010001u;  // 128 + 2^(bits-1)
    const int sh = (2 * t) % PACK * BITS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* r = ct + ((16 * kk + 2 * t) / PACK + 8 / PACK * h) * kCodeRow + col;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(r) >> sh;
      const uint32_t wh = w >> BITS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of w (first field) to the low half, of wh (second) to the
        // high half; then 128 + offset-binary code in each half
        const uint32_t v = and_xor(prmt(w, wh, j | (4 + j) << 8), kMask, kBase);
        b[j][h] = sub_bf16x2(v, kOff);
      }
    }
  }
}

// Block (row tile, column tile, split) of kMmaThreads threads -> dst rows
// [64 x, +64), columns [128 y, +128) over the split's quant groups.
template <int BITS>
__global__ void __launch_bounds__(kMmaThreads, 2) dequant_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ data,
    const float* __restrict__ scale, int M, int K, int N, int group_size,
    int groups_per_split, float* __restrict__ dst) {
  constexpr int PACK = 8 / BITS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = group_size;
  const int gps = mma_gps(G);
  const int x_row = mma_x_row(G);
  const int x_bytes = kMmaRows * x_row;
  const int code_bytes = mma_code_bytes(G, PACK);
  const int stage_bytes = mma_stage_bytes(G, PACK);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;                  // rows [32 wm, +32) of the tile
  const int wn = warp & 3;                   // columns [32 wn, +32)
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kMmaRows;
  const int n0 = blockIdx.y * kMmaCols;
  const int groups = K / G;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const int n_stages = g_end > g_begin ? (g_end - g_begin + gps - 1) / gps : 0;

  // stage `slot` <- quant groups [gi, gi + ng).  Each thread's share of the
  // copies is fixed for the whole K loop: its first x piece, code piece and
  // the strides to its next ones are computed once here, so a stage costs a
  // thread a handful of instructions per 16-byte copy.  x rows go in 16-byte
  // pieces (rows past M zero-filled); code rows in 16-byte pieces when N %
  // 16 == 0 (aligned rows), else in 4-byte words (columns past N
  // zero-filled); the scale rows in 16-byte pieces.  Groups whose stage row
  // is not a power-of-two count of pieces take the general path.
  const int pieces = gps * G / 8;            // 16-byte pieces of an x row
  const int psh = __ffs(pieces) - 1;
  const bool pow2 = pieces == 1 << psh;
  const int x_rpp = kMmaThreads >> psh;      // x rows per pass of the block
  const int x_r0 = tid >> psh;
  const int x_c = tid & (pieces - 1);
  const __nv_bfloat16* xg = x + (size_t)min(m0 + x_r0, M - 1) * K + 8 * x_c;
  const bool vec = (N & 15) == 0 && ((uintptr_t)data & 15) == 0;
  const int c_sh = vec ? 3 : 5;              // log2 of the pieces of a code row
  const int c_rpp = kMmaThreads >> c_sh;     // code rows per pass
  const int c_r0 = tid >> c_sh;
  const int c_off = (tid & ((1 << c_sh) - 1)) << (vec ? 4 : 2);   // bytes into the row
  const bool c_ok = n0 + c_off < N;
  const int8_t* cg = c_ok ? data + (size_t)c_r0 * N + n0 + c_off : data;
  auto load = [&](int gi, int ng, int slot) {
    const uint32_t xs = smem_u32(smem + slot * stage_bytes);
    const uint32_t cs = xs + x_bytes;
    const int k0 = gi * G;
    const int kn = ng * G;                   // k values of this stage
    if (pow2) {
      if (8 * x_c < kn) {
        for (int r = x_r0; r < kMmaRows; r += x_rpp) {
          const bool ok = m0 + r < M;
          cp_async16(xs + r * x_row + 16 * x_c, ok ? xg + (size_t)(r - x_r0) * K + k0 : x,
                     ok ? 16 : 0);
        }
      }
    } else {
      const int np = kn / 8;
      for (int i = tid; i < kMmaRows * np; i += kMmaThreads) {
        const int r = i / np;
        const int c = i - r * np;
        const bool ok = m0 + r < M;
        cp_async16(xs + r * x_row + 16 * c, x + (size_t)(ok ? m0 + r : 0) * K + k0 + 8 * c,
                   ok ? 16 : 0);
      }
    }
    const int8_t* cgk = cg + (c_ok ? (size_t)(k0 / PACK) * N : 0);
    for (int r = c_r0; r < kn / PACK; r += c_rpp) {
      const uint32_t dst = cs + r * kCodeRow + c_off;
      const int8_t* src = c_ok ? cgk + (size_t)(r - c_r0) * N : data;
      if (vec)
        cp_async16(dst, src, c_ok ? 16 : 0);
      else
        cp_async4(dst, src, c_ok ? 4 : 0);
    }
    for (int i = tid; i < ng * (kMmaCols / 4); i += kMmaThreads) {   // up to 16 rows
      const int q = i >> 5;                  // scale row q, 16-byte piece p
      const int p = i & 31;
      const bool ok = n0 + 4 * p < N;
      cp_async16(cs + code_bytes + q * kMmaCols * 4 + 16 * p,
                 ok ? scale + (size_t)(gi + q) * N + n0 + 4 * p : scale, ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_stages) load(g_begin + s * gps, min(gps, g_end - g_begin - s * gps), s);
    cp_async_commit();
  }

  // lane's ldmatrix row and k offset within a 16 x 16 A tile
  const int a_row = wm * 32 + (lane & 15);
  const int a_col = (lane >> 4) * 16;        // bytes
  const int steps = G / 16;                  // k16 steps of a group
  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();                         // stage `it` landed; stage it - 1 is free
    const int nxt = it + kMmaStages - 1;
    if (nxt < n_stages)
      load(g_begin + nxt * gps, min(gps, g_end - g_begin - nxt * gps), nxt % kMmaStages);
    cp_async_commit();

    const unsigned char* st = smem + (it % kMmaStages) * stage_bytes;
    const unsigned char* ct = st + x_bytes;
    const int ng = min(gps, g_end - g_begin - it * gps);
    for (int q = 0; q < ng; ++q) {
      const uint32_t xs = smem_u32(st) + a_row * x_row + a_col + 2 * q * G;
      const unsigned char* cq = ct + q * G / PACK * kCodeRow;
      float part[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < steps; ++kk) {
        uint32_t a[2][4];
        ldsm_x4(xs + 32 * kk, a[0]);
        ldsm_x4(xs + 16 * x_row + 32 * kk, a[1]);
        uint32_t b[4][2];
        load_b<BITS>(cq, kk, wn * 32 + 4 * g, t, b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(part[mi][j], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[j][0], b[j][1]);
      }
      // c0/c2 of n8 tile j are column 8t + j, c1/c3 column 8t + 4 + j
      const float* srow = reinterpret_cast<const float*>(ct + code_bytes) + q * kMmaCols +
                          wn * 32 + 8 * t;
      const float4 s0 = *reinterpret_cast<const float4*>(srow);
      const float4 s1 = *reinterpret_cast<const float4*>(srow + 4);
      const float sc[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][j][e] = fmaf(part[mi][j][e], sc[e & 1][j], acc[mi][j][e]);
    }
  }

  float* out = dst + (size_t)blockIdx.z * M * N;
  const int col = n0 + wn * 32 + 8 * t;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {            // rows g, g + 8 of the m16 tile
      const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
      if (row >= M) continue;
      float* o = out + (size_t)row * N + col;
      if (col < N)
        *reinterpret_cast<float4*>(o) = make_float4(acc[mi][0][2 * h], acc[mi][1][2 * h],
                                                    acc[mi][2][2 * h], acc[mi][3][2 * h]);
      if (col + 4 < N)
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1], acc[mi][2][2 * h + 1],
                        acc[mi][3][2 * h + 1]);
    }
  }
}

template <int BITS>
int mma_smem(int group_size) {
  return kMmaStages * mma_stage_bytes(group_size, 8 / BITS);
}

// Lets every instantiation take the dynamic shared memory of its largest
// stage, that of group 16 with 16 scale rows (once per process).
template <int BITS>
cudaError_t mma_prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      dequant_mma_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_smem<BITS>(16));
  return err;
}

template <int BITS>
cudaError_t launch_mma(const void* x, const void* data, const void* scale, float* dst, int M,
                       int K, int N, int group_size, int groups_per_split, int splits,
                       cudaStream_t s) {
  const cudaError_t err = mma_prepare<BITS>();
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kMmaRows - 1) / kMmaRows, (N + kMmaCols - 1) / kMmaCols, splits);
  dequant_mma_kernel<BITS><<<grid, kMmaThreads, mma_smem<BITS>(group_size), s>>>(
      (const __nv_bfloat16*)x, (const int8_t*)data, (const float*)scale, M, K, N, group_size,
      groups_per_split, dst);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// tensor-core matrix-vector kernel (decode)
// ---------------------------------------------------------------------------
constexpr int kMmvRows = 4;                  // rows of x: the n8 operand's columns 0-3
constexpr int kMmvElems = kMmvRows * kMmvCols;   // outputs of a block
static_assert(mmv_ring_bytes(8) >= (kMmvWarps + 1) * kMmvElems * 4,
              "the warps' and the block's sums fit in the ring");

// Block (rank, column tile) of kMmvThreads threads -> out rows [0, M) (M <=
// 4), columns [128 y, +128).  The gridDim.x blocks of a column tile form
// one cluster and split the quant groups.  A warp's stages come by TMA
// (code_map: the codes as an (K / pack) x N byte tensor, N % 16 == 0 and
// 16-byte aligned, boxes of 32 rows x 128 columns, 128-byte swizzle; x_map:
// x as an M x K bf16 tensor, boxes of 8 rows).
template <int BITS>
__global__ void __launch_bounds__(kMmvThreads, 2) dequant_mmv_kernel(
    const __grid_constant__ CUtensorMap code_map, const __grid_constant__ CUtensorMap x_map,
    const float* __restrict__ scale, int M, int K, int N, int group_size,
    float* __restrict__ out) {
  constexpr int P = BITS / 2;                // pieces of a lane per k16 step
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
  // the rank's whole groups, then the warp's share of their k16 steps
  const int r0 = rank * groups / ranks * spg;
  const int r1 = (rank + 1) * groups / ranks * spg;
  const int s0 = r0 + warp * (r1 - r0) / kMmvWarps;
  const int steps = r0 + (warp + 1) * (r1 - r0) / kMmvWarps - s0;
  const int n_stages = (steps + U - 1) / U;

  unsigned char* codes = smem + warp * kMmvStages * kMmvCodeBytes;
  unsigned char* xs = smem + kMmvWarps * kMmvStages * kMmvCodeBytes + warp * kMmvStages * XB;
  const uint32_t codes_s = smem_u32(codes);
  const uint32_t xs_s = smem_u32(xs);
  const uint32_t bars = smem_u32(smem + mmv_ring_bytes(BITS)) + warp * kMmvStages * 8;
  if (lane == 0) {
    if (warp == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&code_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
    }
    for (int i = 0; i < kMmvStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Where the lane reads piece i of step u of a stage: packed row u ROWS +
  // P t + i of the code tile, its 16-byte chunk g swizzled by the row (chunk
  // g ^ (row % 8), TMA's 128-byte swizzle, so that the 8 lanes of a
  // quarter-warp read distinct banks); x row g, k 16 u + 4t .. + 3 of the x
  // tile.
  auto code_at = [&](int u, int i) {
    const int r = u * ROWS + P * t + i;
    return r * kMmvCols + ((g ^ (r & 7)) << 4);
  };
  auto x_at = [&](int u) { return g * XROW + u * 32 + 8 * t; };

  // lane 0 asks for the stage's code tile and x tile on the slot's mbarrier
  auto load = [&](int st) {
    const int slot = st % kMmvStages;
    __syncwarp();                            // every lane is done with the slot
    if (lane == 0) {
      const uint32_t bar = bars + 8 * slot;
      // the lanes' reads of the slot come before the copies that refill it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, kMmvCodeBytes + XB);
      tma_2d(codes_s + slot * kMmvCodeBytes, &code_map, n0, (s0 + st * U) * ROWS, bar);
      tma_2d(xs_s + slot * XB, &x_map, (s0 + st * U) * 16, 0, bar);
    }
  };

  float acc[8][4], part[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;
  float4 sc[4];                              // scales of the lane's 16 columns
  auto load_scale = [&](int s) {             // those of absolute step s's group
    const float* sp = scale + (size_t)(s / spg) * N + col;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sc[q] = col + 4 * q < N ? __ldg(reinterpret_cast<const float4*>(sp) + q)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  // Launched as the programmatic dependent of the kernel before it: no
  // global read (codes, scales, x) before that kernel's writes are seen.
  griddep_wait();
  for (int st = 0; st < min(kMmvStages - 1, n_stages); ++st) load(st);
  if (steps > 0) load_scale(s0);
  int left = spg - s0 % spg;                 // steps left in the current group
  for (int it = 0; it < n_stages; ++it) {
    mbar_wait(bars + 8 * (it % kMmvStages), (it / kMmvStages) & 1);
    // refill the slot read in the previous iteration
    if (it + kMmvStages - 1 < n_stages) load(it + kMmvStages - 1);
    const unsigned char* ct = codes + (it % kMmvStages) * kMmvCodeBytes;
    const unsigned char* xt = xs + (it % kMmvStages) * XB;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = it * U + u;
      if (s >= steps) break;
      uint32_t w[P][4];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const uint4 v = *reinterpret_cast<const uint4*>(ct + code_at(u, i));
        w[i][0] = v.x;
        w[i][1] = v.y;
        w[i][2] = v.z;
        w[i][3] = v.w;
      }
      const uint2 xb = *reinterpret_cast<const uint2*>(xt + x_at(u));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t a[4];
        mmv_a<BITS>(w, j, a);
        mma_bf16(part[j], a[0], a[1], a[2], a[3], xb.x, xb.y);
      }
      if (--left == 0 || s + 1 == steps) {   // the group, or the warp's run, ends
        // c0, c1 of tile j are column 2j (rows 2t, 2t + 1), c2, c3 column 2j + 1
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
        if (s + 1 < steps) load_scale(s0 + s + 1);
      }
    }
  }

  // the warps' sums, [warp][row][column] over the rings (rows 2t, 2t + 1 of
  // lanes t < 2; lanes t >= 2 hold the zero rows 4-7), added in warp order
  __syncthreads();                           // every warp is done with its ring
  float* red = reinterpret_cast<float*>(smem);
  float* bsum = red + kMmvWarps * kMmvElems;
  if (t < 2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* r = red + (warp * kMmvRows + 2 * t) * kMmvCols + 16 * g + 2 * j;
      *reinterpret_cast<float2*>(r) = make_float2(acc[j][0], acc[j][2]);
      *reinterpret_cast<float2*>(r + kMmvCols) = make_float2(acc[j][1], acc[j][3]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kMmvElems; e += kMmvThreads) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kMmvWarps; ++wi) v += red[wi * kMmvElems + e];
    const int m = e / kMmvCols;
    const int n = n0 + e % kMmvCols;
    if (ranks > 1)
      bsum[e] = v;
    else if (m < M && n < N)
      out[(size_t)m * N + n] = v;
  }
  if (ranks == 1) return;
  // the cluster's block sums, added in rank order through distributed
  // shared memory; rank r stores its 1/ranks of the tile
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int f0 = rank * kMmvElems / ranks;
  const int f1 = (rank + 1) * kMmvElems / ranks;
  for (int f = f0 + threadIdx.x; f < f1; f += kMmvThreads) {
    float r = 0.f;
    for (int q = 0; q < ranks; ++q) r += cluster.map_shared_rank(bsum, q)[f];
    const int m = f / kMmvCols;
    const int n = n0 + f % kMmvCols;
    if (m < M && n < N) out[(size_t)m * N + n] = r;
  }
  cluster.sync();                            // no block leaves while its sums are read
}

// Lets the instantiation take up to the card's limit of dynamic shared
// memory: its rings, and the whole of an SM's in mmv_clusters (once per
// process).
template <int BITS>
cudaError_t mmv_prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      dequant_mmv_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max(mmv_smem(BITS), max_smem()));
  return err;
}

template <int BITS>
cudaError_t launch_mmv(const void* x, const void* data, const void* scale, float* out, int M,
                       int K, int N, int group_size, int ranks, cudaStream_t s) {
  cudaError_t err = mmv_prepare<BITS>();
  if (err != cudaSuccess) return err;
  CUtensorMap code_map = {}, x_map = {};
  err = tensor_map(&code_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, data, K * BITS / 8, N,
                   kMmvStageRows, kMmvCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 8,
                     16 * mmv_steps_per_stage(BITS), CU_TENSOR_MAP_SWIZZLE_NONE);
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
  cfg.dynamicSmemBytes = mmv_smem(BITS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, dequant_mmv_kernel<BITS>, code_map, x_map,
                            (const float*)scale, M, K, N, group_size, out);
}

template <int BITS, typename XT>
void launch_gemv(const void* x, const void* data, const void* scale, float* dst, int M, int K,
                 int N, int group_size, int groups_per_split, int splits, cudaStream_t s) {
  const dim3 grid((M + kGemvRows - 1) / kGemvRows, (N + kTileN - 1) / kTileN, splits);
  dequant_mm_kernel<BITS, XT><<<grid, kThreads, 0, s>>>(
      (const XT*)x, (const int8_t*)data, (const float*)scale, M, K, N, group_size,
      groups_per_split, dst);
}

template <int BITS>
cudaError_t launch_bits(int kernel, int x_bf16, const void* x, const void* data,
                        const void* scale, float* dst, int M, int K, int N, int group_size,
                        int groups_per_split, int splits, cudaStream_t s) {
  if (kernel == 1)
    return launch_mma<BITS>(x, data, scale, dst, M, K, N, group_size, groups_per_split, splits,
                            s);
  if (kernel == 2) return launch_mmv<BITS>(x, data, scale, dst, M, K, N, group_size, splits, s);
  if (x_bf16)
    launch_gemv<BITS, __nv_bfloat16>(x, data, scale, dst, M, K, N, group_size,
                                     groups_per_split, splits, s);
  else
    launch_gemv<BITS, float>(x, data, scale, dst, M, K, N, group_size, groups_per_split,
                             splits, s);
  return cudaSuccess;
}

template <int BITS>
cudaError_t occupancy(int kernel, int x_bf16, int group_size, int* blocks, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (kernel == 1) {
    err = mma_prepare<BITS>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, dequant_mma_kernel<BITS>, kMmaThreads, mma_smem<BITS>(group_size));
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dequant_mma_kernel<BITS>);
  } else if (kernel == 2) {
    err = mmv_prepare<BITS>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dequant_mmv_kernel<BITS>,
                                                          kMmvThreads, mmv_smem(BITS));
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dequant_mmv_kernel<BITS>);
  } else if (x_bf16) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, dequant_mm_kernel<BITS, __nv_bfloat16>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, dequant_mm_kernel<BITS, __nv_bfloat16>);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, dequant_mm_kernel<BITS, float>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, dequant_mm_kernel<BITS, float>);
  }
  if (err == cudaSuccess) *regs = attr.numRegs;
  return err;
}

int pack_of(int bits) { return bits == 8 ? 1 : bits == 4 ? 2 : bits == 2 ? 4 : 0; }

// The tensor-core kernels' constraints on the shapes (bf16 x checked apart).
bool mma_ok(int group_size) {
  return group_size % 16 == 0 && group_size <= kMmaMaxGroup;
}

// Clusters of `ranks` decode blocks the card runs at once with one block
// per SM (asked with an SM's whole shared memory): more clusters than that
// would put two blocks on some SMs, and a cluster waits for its slowest.
template <int BITS>
cudaError_t mmv_clusters(int ranks, int* clusters) {
  cudaError_t err = mmv_prepare<BITS>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1, 1);
  cfg.blockDim = dim3(kMmvThreads, 1, 1);
  cfg.dynamicSmemBytes = max_smem();
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, dequant_mmv_kernel<BITS>, &cfg);
}

}  // namespace

// x (M, K) bf16 or f32; data (K / pack, N) int8; scale (K / group, N) f32;
// out (M, N) f32; part (splits, M, N) f32 scratch when splits > 1 (gemv and
// mma kernels).  `kernel` 0 is the gemv kernel (4-row tiles, any M), 1 the
// tensor-core prefill kernel (64-row tiles) and 2 the tensor-core decode
// kernel (M <= 4), both with bf16 x 16-byte aligned and group % 16 == 0,
// group <= 256.  The K range is cut into `splits` runs of whole quant
// groups; for kernel 2 they are the 1 to 8 blocks of a cluster.
extern "C" int dequant_matmul_launch(const void* x, int x_bf16, const void* data,
                                     const void* scale, void* part, void* out, int M, int K,
                                     int N, int bits, int group_size, int kernel, int splits,
                                     void* stream) {
  const int pack = pack_of(bits);
  if (pack == 0 || M <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || group_size <= 0 ||
      group_size % pack != 0 || group_size > kStageK || K % group_size != 0 ||
      kernel < 0 || kernel > 2 ||
      (kernel != 0 && (!x_bf16 || !mma_ok(group_size) || (uintptr_t)x % 16 != 0)) ||
      (kernel == 2 && (M > kMmvRows || splits > kMmvMaxCluster || N % 16 != 0 ||
                       (uintptr_t)data % 16 != 0)) ||
      splits <= 0 || splits > K / group_size ||
      (kernel != 2 && splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = K / group_size;
  const int per = (groups + splits - 1) / splits;
  float* dst = splits > 1 && kernel != 2 ? (float*)part : (float*)out;
  cudaError_t err;
  switch (bits) {
    case 8:
      err = launch_bits<8>(kernel, x_bf16, x, data, scale, dst, M, K, N, group_size, per,
                           splits, s);
      break;
    case 4:
      err = launch_bits<4>(kernel, x_bf16, x, data, scale, dst, M, K, N, group_size, per,
                           splits, s);
      break;
    default:
      err = launch_bits<2>(kernel, x_bf16, x, data, scale, dst, M, K, N, group_size, per,
                           splits, s);
      break;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1 || kernel == 2) return (int)err;
  const size_t quads = (size_t)M * N / 4;
  split_sum_kernel<<<(unsigned)((quads + kSumThreads - 1) / kSumThreads), kSumThreads, 0, s>>>(
      (const float4*)part, splits, quads, (float4*)out);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` (0 gemv, 1 tensor-core prefill, 2 tensor-core decode)
// for (bits, x type, group) that one SM holds at once, as the occupancy
// calculator reports, and the registers per thread the instantiation was
// compiled to.
extern "C" int dequant_matmul_occupancy(int kernel, int bits, int x_bf16, int group_size,
                                        int* blocks, int* regs) {
  if (pack_of(bits) == 0 || blocks == nullptr || regs == nullptr || kernel < 0 ||
      kernel > 2 || (kernel != 0 && !mma_ok(group_size)))
    return (int)cudaErrorInvalidValue;
  switch (bits) {
    case 8:
      return (int)occupancy<8>(kernel, x_bf16, group_size, blocks, regs);
    case 4:
      return (int)occupancy<4>(kernel, x_bf16, group_size, blocks, regs);
    default:
      return (int)occupancy<2>(kernel, x_bf16, group_size, blocks, regs);
  }
}

// Clusters of `ranks` (1 to 8) decode-kernel blocks the card holds at once
// with one block per SM, as cudaOccupancyMaxActiveClusters reports.
extern "C" int dequant_mmv_clusters(int bits, int ranks, int* clusters) {
  if (pack_of(bits) == 0 || clusters == nullptr || ranks < 1 || ranks > kMmvMaxCluster)
    return (int)cudaErrorInvalidValue;
  switch (bits) {
    case 8:
      return (int)mmv_clusters<8>(ranks, clusters);
    case 4:
      return (int)mmv_clusters<4>(ranks, clusters);
    default:
      return (int)mmv_clusters<2>(ranks, clusters);
  }
}
