// Grouped dequant GEMV kernels of HOBBIT decode for Hopper (sm_90a), plain
// C interface bound with ctypes (see kernels/build.py and kernels/ops.py).
//
// Replaces src/repro/kernels/dequant_matmul.py:
//   grouped_dequant_matmul_pallas  -> grouped_dequant_matmul_launch
//       y[p] = x[p] @ dequant(data[slot[p]], scale[slot[p]])
//   grouped_dequant_combine_pallas -> grouped_dequant_combine_launch
//       out[rows[p]] += weights[p] * (x[p] @ dequant(...)); pads carry
//       rows[p] == num_rows and are skipped; rows no pair visits are 0.
//
// What bounds it on the card: device-memory bytes.  Each (token, expert)
// pair is a single-row product against one low-precision expert matrix, so
// every packed weight byte is used for exactly one multiply-add per code:
// about 66 MB of codes and scales per pair for Mixtral's up/gate matrix at
// 4 bits (~20 us at 3.35 TB/s) against ~0.24 GFLOP.
//
// What the design does about it:
//   * Only packed bytes leave device memory.  Codes are unpacked (two's
//     complement low bits, decoded without int -> float conversions, in
//     dequant.cuh) and scaled in registers; the pool tensors are read in
//     place through the per-pair `slot` index, so no expert copy is gathered.
//   * A thread owns 16 consecutive output columns and reads them with one
//     16-byte load per packed row; a warp reads 512 contiguous bytes.
//   * The block's K-chunk of x is staged in shared memory as float32 (a
//     whole row of K = 14336 would not fit the static 48 KB).
//   * Pass 1 splits K over blocks (grid = N-tiles x K-chunks x pairs); the
//     wrapper shortens the chunk until the grid holds several blocks per SM,
//     so even one pair fills the 132 SMs.  Each block writes a float32
//     partial row.  Pass 2 adds the partials (a group of lanes per 4
//     columns, lanes over chunks, a fixed shuffle tree) and, for the
//     combine, each output row's pairs in pair order.  No atomics, so the result is the same on
//     every run.
#include "dequant.cuh"

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

int launch(const void* x, int x_bf16, const void* data, const void* scale,
           const void* slot, const void* rows, const void* weights, void* part,
           void* out, int P, int K, int N, int num_slots, int num_rows, int bits,
           int group_size, int chunk, void* stream) {
  const int pack = bits == 8 ? 1 : bits == 4 ? 2 : bits == 2 ? 4 : 0;
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
