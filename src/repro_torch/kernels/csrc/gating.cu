// Router kernels of HOBBIT decode for Hopper (sm_90a), plain C interface
// bound with ctypes (see kernels/build.py and kernels/ops.py).
//
// Replaces src/repro/kernels/stacked_gating.py:
//   gating_topk_pallas    -> gating_topk_launch    (router matmul, softmax,
//                                                   iterative top-k)
//   stacked_gating_pallas -> stacked_gating_launch (router matmul only)
//
// What bounds it on the card: nothing but launch latency.  One decode step
// reads B*D activations and one (D, E) f32 router (4096 x 8 x 4 B = 128 KB
// for Mixtral), well under a microsecond of HBM time; the work is a few
// hundred thousand FMAs.  The design therefore keeps everything in ONE block
// per (router p, token row b): the D-reduction for all E logits, the softmax
// and the top-k selection run back to back in shared memory, so the whole
// router costs a single launch with no intermediate tensor in device memory.
//
// Layout: the block's up to 1024 threads are E lanes x R rows (R = blockDim
// / E).  A thread owns one expert column e and walks d = r, r+R, ... with
// eight loads in flight; consecutive threads read consecutive gate floats,
// so each warp load is coalesced.  The R partial sums of a column are added
// in row order by one thread, so the result does not depend on scheduling.
// Ties in the top-k go to the lowest expert index, as in the Pallas kernel's
// iterative argmax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxExperts = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT, bool kSelect>
__global__ void __launch_bounds__(kMaxThreads) gating_kernel(
    const XT* __restrict__ x, const float* __restrict__ gates,
    float* __restrict__ logits, float* __restrict__ vals, int* __restrict__ idx,
    int B, int D, int E, int top_k) {
  const int pb = blockIdx.x;  // p * B + b
  const int p = pb / B;
  const int b = pb % B;
  const int t = threadIdx.x;
  const int rows = blockDim.x / E;
  const int e = t % E;
  const int r = t / E;

  __shared__ float part[kMaxThreads];
  __shared__ float lg[kMaxExperts];

  const XT* xr = x + (size_t)b * D;
  const float* g = gates + (size_t)p * D * E;
  float acc = 0.f;
#pragma unroll 8
  for (int d = r; d < D; d += rows) acc = fmaf(to_f32(xr[d]), g[(size_t)d * E + e], acc);
  part[t] = acc;
  __syncthreads();
  if (t < E) {
    float s = 0.f;
    for (int j = 0; j < rows; ++j) s += part[j * E + t];
    lg[t] = s;
    logits[(size_t)pb * E + t] = s;
  }
  if constexpr (kSelect) {
    __syncthreads();
    if (t == 0) {
      float m = lg[0];
      for (int i = 1; i < E; ++i) m = fmaxf(m, lg[i]);
      float sum = 0.f;
      for (int i = 0; i < E; ++i) {
        const float z = expf(lg[i] - m);
        lg[i] = z;
        sum += z;
      }
      for (int i = 0; i < E; ++i) lg[i] = lg[i] / sum;
      for (int j = 0; j < top_k; ++j) {
        int best = 0;
        float bv = lg[0];
        for (int i = 1; i < E; ++i) {
          if (lg[i] > bv) {  // strict: ties keep the lowest index
            bv = lg[i];
            best = i;
          }
        }
        vals[(size_t)pb * top_k + j] = bv;
        idx[(size_t)pb * top_k + j] = best;
        lg[best] = -1.f;
      }
    }
  }
}

template <bool kSelect>
int launch(const void* x, int x_bf16, const void* gates, void* logits, void* vals,
           void* idx, int P, int B, int D, int E, int top_k, void* stream) {
  if (P <= 0 || B <= 0 || D <= 0 || E <= 0 || E > kMaxExperts ||
      (kSelect && (top_k <= 0 || top_k > E)))
    return (int)cudaErrorInvalidValue;
  const int threads = (kMaxThreads / E) * E;
  const dim3 grid(P * B);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    gating_kernel<__nv_bfloat16, kSelect><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)gates, (float*)logits, (float*)vals,
        (int*)idx, B, D, E, top_k);
  } else {
    gating_kernel<float, kSelect><<<grid, threads, 0, s>>>(
        (const float*)x, (const float*)gates, (float*)logits, (float*)vals, (int*)idx,
        B, D, E, top_k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gating_topk_launch(const void* x, int x_bf16, const void* gates,
                                  void* logits, void* vals, void* idx, int P, int B,
                                  int D, int E, int top_k, void* stream) {
  return launch<true>(x, x_bf16, gates, logits, vals, idx, P, B, D, E, top_k, stream);
}

extern "C" int stacked_gating_launch(const void* x, int x_bf16, const void* gates,
                                     void* logits, int P, int B, int D, int E,
                                     void* stream) {
  return launch<false>(x, x_bf16, gates, logits, nullptr, nullptr, P, B, D, E, 0,
                       stream);
}
