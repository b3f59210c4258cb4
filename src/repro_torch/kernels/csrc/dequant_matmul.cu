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
// What bounds it on the card depends on M.  Decode (M = live rows, 1-4) is a
// GEMV per column tile: every packed weight byte serves M multiply-adds per
// code, so device-memory bytes bound it (Granite's FFN up/gate matrix,
// 2048 x 16384 at 4 bits, is 16.8 MB of codes and 1 MB of scales: ~5.3 us
// at 3.35 TB/s).  Chunked prefill (M = 64 x slots) reuses each decoded
// weight across all rows of a block, and float32 FMAs bound it (64 x 2048 x
// 16384 is 4.3 GFLOP: ~64 us at 67 TFLOP/s).  Tensor-core MMAs are later
// work.
//
// What the design does about it:
//   * A block of 128 threads owns BM rows (4 for M <= 4, else 16) and 128
//     columns; a lane owns 4 consecutive columns and reads them with one
//     4-byte load per packed row, so a warp reads 128 contiguous bytes.  The
//     4 warps take interleaved packed rows of the block's K range and each
//     loads a batch of rows before it uses them (bytes in flight).
//   * Each packed word is decoded once, in registers (magic-number decode of
//     dequant.cuh), scaled by its group's scale (a float4 per lane, reloaded
//     only when the group changes), and used for all BM rows: x is staged in
//     shared memory as float32, [k][row], so the BM values of one k are a
//     broadcast float4 load.  float32 FMAs accumulate.
//   * The K range runs in stages of whole quant groups (at most 512 k); the
//     4 warps' partial sums are added in warp order through shared memory.
//   * Too few blocks at M <= 4 (one row tile): the wrapper splits K over
//     gridDim.z in whole groups until the grid holds several blocks per SM;
//     each split writes a float32 partial and a second kernel adds the splits
//     in split order.  No atomics: the result is the same on every run.
#include "dequant.cuh"

namespace {

constexpr int kThreads = 128;                // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                  // output columns of a block, 4 per lane
constexpr int kStageK = kWarps * kTileN;     // 512: the most k values of x staged
constexpr int kSumThreads = 256;

template <int BITS, typename XT, int BM>
__global__ void __launch_bounds__(kThreads) dequant_mm_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ data,
    const float* __restrict__ scale, int M, int K, int N, int group_size,
    int groups_per_split, float* __restrict__ dst) {
  constexpr int PACK = 8 / BITS;
  constexpr int kBatch = BM <= 4 ? 8 : 4;    // packed rows loaded before use
  // x stage [k][row]; after the K loop the warps' sums [warp][row][column]
  // (kWarps * kTileN == kStageK, so both fit)
  __shared__ __align__(16) float xs[kStageK * BM];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kTileN + lane * 4;
  const bool col_ok = n0 < N;                // N % 4 == 0: all 4 columns or none
  const int groups = K / group_size;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const int stage_groups = kStageK / group_size;
  const int rows_per_group = group_size / PACK;

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  }

  for (int gs = g_begin; gs < g_end; gs += stage_groups) {
    const int kn = min(stage_groups, g_end - gs) * group_size;   // k values staged
    const int k0 = gs * group_size;
    __syncthreads();                         // the last stage's readers are done
    for (int i = threadIdx.x; i < kn * BM; i += kThreads) {
      const int m = i / kn;
      const int kk = i - m * kn;
      xs[kk * BM + m] = m0 + m < M ? to_f32(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
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
          const float4* xr = reinterpret_cast<const float4*>(xs + (r * PACK + i) * BM);
#pragma unroll
          for (int q = 0; q < BM / 4; ++q) {
            const float4 xv = xr[q];
            const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[4 * q + mm][j] = fmaf(xm[mm], wv[j], acc[4 * q + mm][j]);
            }
          }
        }
      }
    }
  }

  // add the warps' sums in warp order; thread t writes column t of the tile
  __syncthreads();
  float* red = xs;
#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(red + (warp * BM + m) * kTileN + lane * 4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = blockIdx.y * kTileN + threadIdx.x;
  if (n >= N) return;
  float* out = dst + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    if (m0 + m >= M) break;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[(wi * BM + m) * kTileN + threadIdx.x];
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

template <int BITS, typename XT, int BM>
void launch_t(const void* x, const void* data, const void* scale, float* dst, int M, int K,
              int N, int group_size, int groups_per_split, int splits, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + kTileN - 1) / kTileN, splits);
  dequant_mm_kernel<BITS, XT, BM><<<grid, kThreads, 0, s>>>(
      (const XT*)x, (const int8_t*)data, (const float*)scale, M, K, N, group_size,
      groups_per_split, dst);
}

template <int BITS, typename XT>
void by_rows(int bm, const void* x, const void* data, const void* scale, float* dst, int M,
             int K, int N, int group_size, int groups_per_split, int splits, cudaStream_t s) {
  if (bm == 4)
    launch_t<BITS, XT, 4>(x, data, scale, dst, M, K, N, group_size, groups_per_split, splits, s);
  else
    launch_t<BITS, XT, 16>(x, data, scale, dst, M, K, N, group_size, groups_per_split, splits,
                           s);
}

template <int BITS>
void by_x(int x_bf16, int bm, const void* x, const void* data, const void* scale, float* dst,
          int M, int K, int N, int group_size, int groups_per_split, int splits,
          cudaStream_t s) {
  if (x_bf16)
    by_rows<BITS, __nv_bfloat16>(bm, x, data, scale, dst, M, K, N, group_size,
                                 groups_per_split, splits, s);
  else
    by_rows<BITS, float>(bm, x, data, scale, dst, M, K, N, group_size, groups_per_split,
                         splits, s);
}

}  // namespace

// x (M, K) bf16 or f32; data (K / pack, N) int8; scale (K / group, N) f32;
// out (M, N) f32; part (splits, M, N) f32 scratch when splits > 1.  `bm`
// (4 or 16) is the row tile; the K range is cut into `splits` runs of whole
// quant groups.
extern "C" int dequant_matmul_launch(const void* x, int x_bf16, const void* data,
                                     const void* scale, void* part, void* out, int M, int K,
                                     int N, int bits, int group_size, int bm, int splits,
                                     void* stream) {
  const int pack = bits == 8 ? 1 : bits == 4 ? 2 : bits == 2 ? 4 : 0;
  if (pack == 0 || M <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || group_size <= 0 ||
      group_size % pack != 0 || group_size > kStageK || K % group_size != 0 ||
      (bm != 4 && bm != 16) || splits <= 0 || splits > K / group_size ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = K / group_size;
  const int per = (groups + splits - 1) / splits;
  float* dst = splits > 1 ? (float*)part : (float*)out;
  switch (bits) {
    case 8:
      by_x<8>(x_bf16, bm, x, data, scale, dst, M, K, N, group_size, per, splits, s);
      break;
    case 4:
      by_x<4>(x_bf16, bm, x, data, scale, dst, M, K, N, group_size, per, splits, s);
      break;
    default:
      by_x<2>(x_bf16, bm, x, data, scale, dst, M, K, N, group_size, per, splits, s);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t quads = (size_t)M * N / 4;
  split_sum_kernel<<<(unsigned)((quads + kSumThreads - 1) / kSumThreads), kSumThreads, 0, s>>>(
      (const float4*)part, splits, quads, (float4*)out);
  return (int)cudaGetLastError();
}
