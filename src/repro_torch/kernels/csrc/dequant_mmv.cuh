// Building blocks of the tensor-core decode kernels, shared by the dense
// dequant-matmul (dequant_mmv_kernel in dequant_matmul.cu) and the grouped
// lo-expert pair (grouped_mmv_kernel in dequant.cu): the exact bf16 decode
// of packed codes (a byte permute, one LOP3 and one bf16x2 subtraction per
// pair of 4- or 2-bit codes), the A fragments of the swapped-operand
// mma.sync m16n8k16 (16 weight columns as the MMA's rows, x rows as its n8
// columns), the per-warp TMA ring's geometry, and host-side TMA tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace {

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// (a & b) ^ c in one LOP3.
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

constexpr int kMmvThreads = 256;             // 8 warps, each streaming its own run of K
constexpr int kMmvWarps = kMmvThreads / 32;
constexpr int kMmvCols = 128;                // columns of a block: 16 per lane, 8 m16 tiles
constexpr int kMmvStages = 2;                // ring stages of a warp
constexpr int kMmvStageRows = 32;            // packed rows of a stage: 4 KB of codes
constexpr int kMmvCodeBytes = kMmvStageRows * kMmvCols;
constexpr int kMmvMaxCluster = 8;            // the portable cluster size

// k16 steps of a stage (a k16 step is 2 * bits packed rows), and a warp's
// stage bytes: the code tile, then x for the stage's k values, 8 rows
// (rows past M zero) of 16 k per step.
__host__ __device__ constexpr int mmv_steps_per_stage(int bits) {
  return kMmvStageRows / (2 * bits);
}
__host__ __device__ constexpr int mmv_x_bytes(int bits) {
  return 8 * 16 * 2 * mmv_steps_per_stage(bits);
}
// Dynamic shared memory: the warps' rings (code tiles 1024-byte aligned for
// the 128-byte swizzle, x tiles after them), their mbarriers, and slack to
// align the base.
__host__ __device__ constexpr int mmv_ring_bytes(int bits) {
  return kMmvWarps * kMmvStages * (kMmvCodeBytes + mmv_x_bytes(bits));
}
__host__ __device__ constexpr int mmv_smem(int bits) {
  return 1024 + mmv_ring_bytes(bits) + kMmvWarps * kMmvStages * 8;
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A 2-D TMA tile copy global -> shared, completing on mbarrier `bar`; the
// tile is box (c0, c1) of the tensor map (columns past the tensor's edge
// read as zero).
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Fields f and f + 1 (4 or 2 bits) of byte b of the packed word w, one
// column's codes of two consecutive k, as exact bf16 integers, the lower k
// in the low half: a byte permute, one LOP3 and one bf16x2 subtraction, as
// in load_b (dequant_matmul.cu).
template <int BITS>
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int b, int f) {
  constexpr uint32_t kMask = ((1u << BITS) - 1) * 0x00010001u;
  constexpr uint32_t kBase = (0x4300u | (1u << (BITS - 1))) * 0x00010001u;  // 128 + 2^(bits-1)
  const uint32_t v =
      and_xor(prmt(w >> (BITS * f), w >> (BITS * (f + 1)), b | (4 + b) << 8), kMask, kBase);
  return sub_bf16x2(v, kBase);
}

// Byte b of the 8-bit words lo and hi (one column, two k) as exact bf16.
__device__ __forceinline__ uint32_t code_pair8(uint32_t lo, uint32_t hi, int b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(decode<8>(lo, 8 * b), decode<8>(hi, 8 * b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of m16 tile j: rows g and g + 8 are the lane's columns 2j and
// 2j + 1 (bytes b, b + 1 of word j / 2 of every piece), k pairs (2t, 2t + 1)
// and (2t + 8, 2t + 9) the k values 4t, 4t + 1 and 4t + 2, 4t + 3 of the
// step.  w[i] is the lane's piece i: 16 columns of one packed row.
template <int BITS>
__device__ __forceinline__ void mmv_a(uint32_t (&w)[BITS / 2][4], int j, uint32_t (&a)[4]) {
  const int q = j >> 1;
  const int b = 2 * (j & 1);
  if constexpr (BITS == 8) {                 // pieces 0-3: k 4t, 4t + 1, 4t + 2, 4t + 3
    a[0] = code_pair8(w[0][q], w[1][q], b);
    a[1] = code_pair8(w[0][q], w[1][q], b + 1);
    a[2] = code_pair8(w[2][q], w[3][q], b);
    a[3] = code_pair8(w[2][q], w[3][q], b + 1);
  } else if constexpr (BITS == 4) {          // piece 0: k 4t, 4t + 1; piece 1: 4t + 2, 4t + 3
    a[0] = code_pair<4>(w[0][q], b, 0);
    a[1] = code_pair<4>(w[0][q], b + 1, 0);
    a[2] = code_pair<4>(w[1][q], b, 0);
    a[3] = code_pair<4>(w[1][q], b + 1, 0);
  } else {                                   // one piece: k 4t .. 4t + 3, fields 0-3 of a byte
    a[0] = code_pair<2>(w[0][q], b, 0);
    a[1] = code_pair<2>(w[0][q], b + 1, 0);
    a[2] = code_pair<2>(w[0][q], b, 2);
    a[3] = code_pair<2>(w[0][q], b + 1, 2);
  }
}

// The most dynamic shared memory a block of the card may take.
int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A 2-D tensor map over a row-major (rows, cols) tensor of `elem` bytes per
// element, boxes of box_rows x box_cols.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                       int rows, int cols, int box_rows, int box_cols,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
