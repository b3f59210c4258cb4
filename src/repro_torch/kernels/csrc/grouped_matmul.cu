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
// is 235 MB: 70 us at 3.35 TB/s).  The design streams each matrix once:
//   * A block owns a tile of columns (8 bf16 or 4 float32 per lane: one
//     16-byte load per row, 256 or 128 columns a warp) and a span of K
//     rows, which its 8 warps cut into runs of their own.  A lane keeps two
//     batches of rows in flight (a register double buffer).
//   * The block groups its pairs by slot (in order of first occurrence, up
//     to 8 pairs a group) and streams each group's slot once, multiplying
//     each row by the x of every pair of the group: pairs on one expert,
//     pads that repeat a slot included, cost one expert's bytes.  A slot
//     with more than 8 pairs is streamed once per 8.
//   * x of the group's pairs over the block's span waits in shared memory as
//     float32.  The warps' sums are added in warp order through shared
//     memory; where K is split over blocks (ops.grouped_matmul_plan), a
//     second kernel adds the blocks' partial rows in block order.  No
//     atomics: the result is the same on every run.
//   * A slot outside 0..S-1 aborts the launch (__trap), as in the lo
//     kernels (dequant.cu): a sticky error that the next synchronisation
//     raises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;              // pairs one pass over a slot serves
constexpr int kMaxSpan = 2048;         // K rows of a block
constexpr int kSpanAlign = 32;         // a warp's run is whole 4-row batches
constexpr int kMaxPairs = 1024;        // pairs of a launch
constexpr int kMaxTile = 256;          // columns of a block (bf16)
// the block's buffer: x of a group (kGroup x span floats), then the warps'
// sums (kWarps x kGroup x tile floats); 64 KB
constexpr int kBufFloats = kGroup * kMaxSpan;
static_assert(kWarps * kGroup * kMaxTile <= kBufFloats, "the warps' sums fit the buffer");
static_assert(kMaxSpan % kSpanAlign == 0 && kSpanAlign % (4 * kWarps) == 0,
              "warp runs are whole 4-row batches");

template <typename T>
struct Tag {};

template <typename T>
struct Lanes {
  static constexpr int kCols = 16 / sizeof(T);   // columns of one 16-byte load
  static constexpr int kTile = 32 * kCols;       // columns of a block
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of a weight row as float32 values (8 bf16 or 4 float32).
__device__ __forceinline__ void unpack(const uint4& v, float* f, Tag<__nv_bfloat16>) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, Tag<float>) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// Rows r .. r + U - 1 of the lane's 16 bytes of columns; rows at or past
// `end`, and lanes past N (`ok` false), read nothing and hold zeros.
template <int U>
__device__ __forceinline__ void load_rows(uint4 (&v)[U], const char* base, size_t row_bytes,
                                          int r, int end, bool ok) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (ok && r + i < end)
      v[i] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(r + i) * row_bytes));
  }
}

// acc[j] += x[j][row] * w[row] for the `left` first rows of the batch; x of
// pair j at xs[j * span + loc + i].
template <typename T, int NP, int U>
__device__ __forceinline__ void fma_rows(float (&acc)[NP][Lanes<T>::kCols], const uint4 (&v)[U],
                                         const float* xs, int span, int loc, int left) {
  constexpr int C = Lanes<T>::kCols;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    if (i < left) {
      float f[8];
      unpack(v[i], f, Tag<T>());
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float xv = xs[j * span + loc + i];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] = fmaf(xv, f[c], acc[j][c]);
      }
    }
  }
}

// One group of NP pairs on one slot: the warp streams rows [wbeg, wend) of
// the slot's matrix (`wlane`: the lane's columns of its row 0) against the
// x in `buf`, then, once every warp is done with x, leaves its sums in
// `buf` at [warp][pair][column].  Called by the whole block.
template <typename T, int NP>
__device__ __forceinline__ void stream_group(const char* wlane, size_t row_bytes, bool ok,
                                             float* buf, int span, int blk0, int wbeg,
                                             int wend) {
  constexpr int C = Lanes<T>::kCols;
  constexpr int kTile = Lanes<T>::kTile;
  constexpr int U = NP <= 4 ? 4 : 2;   // rows per batch: fewer where NP x C sums fill registers
  float acc[NP][C];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  uint4 a[U], b[U];
  load_rows<U>(a, wlane, row_bytes, wbeg, wend, ok);
  for (int r = wbeg; r < wend; r += 2 * U) {
    load_rows<U>(b, wlane, row_bytes, r + U, wend, ok);
    fma_rows<T, NP, U>(acc, a, buf, span, r - blk0, wend - r);
    load_rows<U>(a, wlane, row_bytes, r + 2 * U, wend, ok);
    fma_rows<T, NP, U>(acc, b, buf, span, r + U - blk0, wend - r - U);
  }
  __syncthreads();                     // x is read; buf takes the sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* dst = buf + (size_t)warp * kGroup * kTile + lane * C;
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(dst + j * kTile + c) =
          make_float4(acc[j][c], acc[j][c + 1], acc[j][c + 2], acc[j][c + 3]);
}

// Grid (column tiles, K spans).  out: y (P, N) when K is one span, else the
// partial rows (spans, P, N) that sum_spans_kernel adds.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) grouped_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ slot,
    float* __restrict__ out, int P, int K, int N, int num_slots, int span) {
  constexpr int C = Lanes<T>::kCols;
  constexpr int kTile = Lanes<T>::kTile;
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;
  int* sslot = reinterpret_cast<int*>(smem + kBufFloats);  // P: each pair's slot
  int* order = sslot + P;        // P: pair indices, grouped
  int* gfirst = order + P;       // groups + 1: group g is order[gfirst[g] .. gfirst[g + 1])
  int* gslot = gfirst + P + 1;   // groups: the slot of each group
  __shared__ int groups;

  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int s = slot[p];
    // an out-of-range slot (a pad's too) is a fault in the caller's slot
    // bookkeeping, and the plain version raises IndexError for it
    if (s < 0 || s >= num_slots) __trap();
    sslot[p] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0, g = 0;
    for (int p = 0; p < P; ++p) {
      const int s = sslot[p];
      bool seen = false;
      for (int q = 0; q < p && !seen; ++q) seen = sslot[q] == s;
      if (seen) continue;          // its group was formed at its first pair
      int in_group = 0;
      for (int q = p; q < P; ++q) {
        if (sslot[q] != s) continue;
        if (in_group == 0) {
          gfirst[g] = n;
          gslot[g] = s;
          ++g;
        }
        order[n++] = q;
        if (++in_group == kGroup) in_group = 0;
      }
    }
    gfirst[g] = n;
    groups = g;
  }
  __syncthreads();

  const int tile0 = blockIdx.x * kTile;
  const int blk0 = blockIdx.y * span;
  const int blk1 = min(K, blk0 + span);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int run = span / kWarps;
  const int wbeg = blk0 + warp * run;
  const int wend = min(blk1, wbeg + run);
  const int col = tile0 + lane * C;
  const bool ok = col < N;
  const size_t row_bytes = (size_t)N * sizeof(T);
  float* dst = out + (size_t)blockIdx.y * P * N;

  for (int g = 0; g < groups; ++g) {
    const int f0 = gfirst[g];
    const int np = gfirst[g + 1] - f0;
    for (int j = 0; j < np; ++j) {   // x over the span, zeros past K
      const T* xp = x + (size_t)order[f0 + j] * K;
      for (int i = threadIdx.x; i < span; i += kThreads)
        buf[j * span + i] = blk0 + i < K ? to_f32(xp[blk0 + i]) : 0.f;
    }
    __syncthreads();
    const char* wlane = reinterpret_cast<const char*>(w + (size_t)gslot[g] * K * N) +
                        (size_t)col * sizeof(T);
    switch (np) {
      case 1: stream_group<T, 1>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      case 2: stream_group<T, 2>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      case 3: stream_group<T, 3>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      case 4: stream_group<T, 4>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      case 5: stream_group<T, 5>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      case 6: stream_group<T, 6>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      case 7: stream_group<T, 7>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
      default: stream_group<T, 8>(wlane, row_bytes, ok, buf, span, blk0, wbeg, wend); break;
    }
    __syncthreads();                 // every warp's sums are in buf
    for (int i = threadIdx.x; i < np * kTile; i += kThreads) {
      const int j = i / kTile;
      const int c = i - j * kTile;
      if (tile0 + c >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += buf[(v * kGroup + j) * kTile + c];
      dst[(size_t)order[f0 + j] * N + tile0 + c] = s;
    }
    __syncthreads();                 // buf takes the next group's x
  }
}

// y = the sum over spans of part (spans, P * N), in span order.
__global__ void __launch_bounds__(256) sum_spans_kernel(const float4* __restrict__ part,
                                                        float4* __restrict__ y, int spans,
                                                        long n4) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int c = 1; c < spans; ++c) {
    const float4 v = part[(size_t)c * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  y[i] = s;
}

size_t smem_bytes(int P) { return (size_t)kBufFloats * 4 + (size_t)(4 * P + 1) * 4; }

// Lets the kernel take the shared memory of kMaxPairs pairs (once per
// process).
template <typename T>
cudaError_t prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      grouped_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxPairs));
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* slot, float* dst, int P, int K,
                   int N, int num_slots, int span, int spans, cudaStream_t s) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Lanes<T>::kTile - 1) / Lanes<T>::kTile, spans);
  grouped_matmul_kernel<T><<<grid, kThreads, smem_bytes(P), s>>>(
      (const T*)x, (const T*)w, (const int*)slot, dst, P, K, N, num_slots, span);
  return cudaGetLastError();
}

template <typename T>
cudaError_t info(int pairs, int* regs, int* local, int* blocks_per_sm) {
  cudaError_t err = prepare<T>();
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, grouped_matmul_kernel<T>);
  if (err == cudaSuccess) {
    *regs = fa.numRegs;
    *local = (int)fa.localSizeBytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, grouped_matmul_kernel<T>,
                                                        kThreads, smem_bytes(pairs));
  }
  return err;
}

}  // namespace

// y (P, N) f32 = x[p] @ w[slot[p]]: x (P, K) and w (S, K, N) bf16 (w_bf16 = 1)
// or float32, slot (P,) int32.  K is cut into spans of `span` rows (a
// multiple of 32, at most 2048); with more than one span, part holds
// (spans, P, N) floats and a second kernel adds them into y.
extern "C" int grouped_matmul_launch(const void* x, const void* w, const void* slot, void* part,
                                     void* y, int P, int K, int N, int num_slots, int w_bf16,
                                     int span, void* stream) {
  const int cols = w_bf16 ? 8 : 4;
  if (x == nullptr || w == nullptr || slot == nullptr || y == nullptr || P <= 0 ||
      P > kMaxPairs || K <= 0 || N <= 0 || N % cols != 0 || num_slots <= 0 || span <= 0 ||
      span > kMaxSpan || span % kSpanAlign != 0 || (uintptr_t)w % 16 != 0 ||
      (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int spans = (K + span - 1) / span;
  if (spans > 1 && (part == nullptr || (uintptr_t)part % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = spans > 1 ? (float*)part : (float*)y;
  const cudaError_t err =
      w_bf16 ? launch<__nv_bfloat16>(x, w, slot, dst, P, K, N, num_slots, span, spans, s)
             : launch<float>(x, w, slot, dst, P, K, N, num_slots, span, spans, s);
  if (err != cudaSuccess || spans == 1) return (int)err;
  const long n4 = (long)P * N / 4;
  sum_spans_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)part, (float4*)y, spans, n4);
  return (int)cudaGetLastError();
}

// Registers and local memory (spills) per thread of the kernel for bf16
// (w_bf16 = 1) or float32, and its blocks per SM at `pairs` pairs.
extern "C" int grouped_matmul_info(int w_bf16, int pairs, int* regs, int* local,
                                   int* blocks_per_sm) {
  if (regs == nullptr || local == nullptr || blocks_per_sm == nullptr || pairs <= 0 ||
      pairs > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  return (int)(w_bf16 ? info<__nv_bfloat16>(pairs, regs, local, blocks_per_sm)
                      : info<float>(pairs, regs, local, blocks_per_sm));
}

// The kernel's layout constants, in the order ops.py mirrors them: pairs
// per pass over a slot, largest span, span alignment, most pairs.
extern "C" int grouped_matmul_layout(int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  const int v[4] = {kGroup, kMaxSpan, kSpanAlign, kMaxPairs};
  memcpy(out, v, sizeof(v));
  return 0;
}
