// Paged flash-decode attention for Hopper (sm_90a), plain C interface bound
// with ctypes (see kernels/build.py and kernels/ops.py).  The kernels are in
// flash_decode.cuh, shared with the contiguous entry points.
//
// Replaces src/repro/kernels/flash_decode.py:
//   paged_flash_decode_pallas -> paged_flash_decode_launch
//       out[b, hq] = softmax_t(softcap(scale * q[b, hq] . K[b, t])) V[b, t]
//       over the slot's logical tokens t < lengths[b]; token t lives in
//       physical page table[b, t / psz] at offset t % psz; query head hq
//       reads kv head hq / g (GQA); rows with length 0 are exact zeros.
//
// Only pages below ceil(length / psz) are read, where the Pallas grid
// (slot, query head, page) walks all maxp pages of the table and masks the
// rest, and loads each page g times.
#include "flash_decode.cuh"

namespace {

template <typename KV, int G, int HD>
struct Launch {
  static int run(const Args* a, cudaStream_t s) { return launch_t<KV, G, HD, true>(*a, s); }
};

template <typename KV, int G, int HD>
struct Blocks {
  static int run(int maxp, int* blocks) { return blocks_t<KV, G, HD, true>(maxp, blocks); }
};

template <typename KV, int G, int HD>
struct Regs {
  static int run(int* regs, int* local_bytes) { return regs_t<KV, G, HD, true>(regs, local_bytes); }
};

}  // namespace

extern "C" int paged_flash_decode_launch(const void* q, int q_bf16, const void* pages_k,
                                         const void* pages_v, int kv_bf16, const void* table,
                                         const void* lengths, void* out, void* o_part,
                                         void* ml_part, int B, int Hq, int Hkv, int hd,
                                         int num_pages, int psz, int maxp, int splits,
                                         float scale, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || num_pages <= 0 || psz <= 0 || maxp <= 0 ||
      splits <= 0 || splits > kMaxSplits ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q, q_bf16, pages_k, pages_v, (const int*)table, (const int*)lengths, (float*)out,
         (float*)o_part, (float*)ml_part, B, Hq, Hkv, num_pages, psz, maxp, splits, 0,
         scale, softcap};
  return dispatch<Launch>(kv_bf16, Hq / Hkv, hd, &a, (cudaStream_t)stream);
}

// Pass-1 blocks of the instantiation for (kv_bf16, g, hd) that one SM holds
// at once with a table of maxp pages (the wrapper sizes the page split so
// that the grid fills the card in one wave).
extern "C" int paged_flash_decode_blocks_per_sm(int kv_bf16, int g, int hd, int maxp,
                                                int* blocks) {
  if (maxp <= 0 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<Blocks>(kv_bf16, g, hd, maxp, blocks);
}

// Ring stages of the pass-1 kernel for (kv_bf16, hd), shared by the paged
// and the contiguous kernels (1: float32 K/V, one tile buffer).
extern "C" int flash_decode_stages(int kv_bf16, int hd, int* stages) {
  if (stages == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<Stages>(kv_bf16, 1, hd, stages);
}

// Registers and local-memory (spill and stack) bytes per thread of the
// paged pass-1 kernel for (kv_bf16, g, hd).
extern "C" int paged_flash_decode_regs(int kv_bf16, int g, int hd, int* regs,
                                       int* local_bytes) {
  if (regs == nullptr || local_bytes == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<Regs>(kv_bf16, g, hd, regs, local_bytes);
}
