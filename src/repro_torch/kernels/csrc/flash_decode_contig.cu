// Contiguous-cache flash-decode attention for Hopper (sm_90a), plain C
// interface bound with ctypes (see kernels/build.py and kernels/ops.py).
// The kernels are in flash_decode.cuh, shared with the paged entry points;
// this source instantiates them for rows addressed by (slot, token) in a
// (B, S, Hkv, hd) cache, so the two sources compile in parallel.
//
// Replaces src/repro/kernels/flash_decode.py:
//   flash_decode_pallas -> flash_decode_launch
//       out[b, hq] = softmax_t(scale * q[b, hq] . K[b, t, hq / g]) V[b, t, hq / g]
//       over t < min(lengths[b], S); a length <= 0 weighs all S rows alike
//       (the mean of V), as the JAX oracle does.
//
// The Pallas wrapper repeats every kv head g times in device memory
// (jnp.repeat) and its grid (slot, head, S / block_s) reads each repeated
// row once per query head; here each kv row is read once for its whole GQA
// group, in place, and only below the length.
#include "flash_decode.cuh"

namespace {

template <typename KV, int G, int HD>
struct Launch {
  static int run(const Args* a, cudaStream_t s) { return launch_t<KV, G, HD, false>(*a, s); }
};

template <typename KV, int G, int HD>
struct Blocks {
  static int run(int* blocks) { return blocks_t<KV, G, HD, false>(0, blocks); }
};

template <typename KV, int G, int HD>
struct Regs {
  static int run(int* regs, int* local_bytes) { return regs_t<KV, G, HD, false>(regs, local_bytes); }
};

}  // namespace

// q (B, Hq, hd); k, v (B, S, Hkv, hd); lengths (B,) int32; the split runs
// over `unit`-token pieces of the cache.
extern "C" int flash_decode_launch(const void* q, int q_bf16, const void* k, const void* v,
                                   int kv_bf16, const void* lengths, void* out, void* o_part,
                                   void* ml_part, int B, int S, int Hq, int Hkv, int hd,
                                   int unit, int splits, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || unit <= 0 || splits <= 0 ||
      splits > kMaxSplits || (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q, q_bf16, k, v, nullptr, (const int*)lengths, (float*)out, (float*)o_part,
         (float*)ml_part, B, Hq, Hkv, 0, unit, (S + unit - 1) / unit, splits, S, scale, 0.f};
  return dispatch<Launch>(kv_bf16, Hq / Hkv, hd, &a, (cudaStream_t)stream);
}

// Pass-1 blocks of the instantiation for (kv_bf16, g, hd) that one SM holds.
extern "C" int flash_decode_blocks_per_sm(int kv_bf16, int g, int hd, int* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<Blocks>(kv_bf16, g, hd, blocks);
}

// Registers and local-memory (spill and stack) bytes per thread of the
// contiguous pass-1 kernel for (kv_bf16, g, hd).
extern "C" int flash_decode_regs(int kv_bf16, int g, int hd, int* regs, int* local_bytes) {
  if (regs == nullptr || local_bytes == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<Regs>(kv_bf16, g, hd, regs, local_bytes);
}
