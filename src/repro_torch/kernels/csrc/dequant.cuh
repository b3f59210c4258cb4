// Code decoding shared by the dequant kernels (dequant.cu, dequant_matmul.cu).
//
// Layout of the JAX package's quantize: a (K, N) weight is stored as
// data (K / pack, N) int8, pack = 8 / bits codes of consecutive k packed
// into one byte, code i of a byte in bits [bits * i, bits * i + bits) as
// two's complement; scale (K / group, N) float32, one per quant group of
// k and column.  w[k, n] = code(k, n) * scale[k / group, n].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The two's-complement field of BITS bits at bit `sh` of `w`, as an exact
// float: flipping its sign bit gives offset binary (value + 2^(BITS-1));
// placed in the mantissa of 2^23 and minus 2^23 + 2^(BITS-1) that is the
// value again.  One shift, one LOP3 and one FADD, all full-rate, where an
// int -> float conversion would run at a quarter of the rate and bound the
// kernel on instructions rather than bytes.
template <int BITS>
__device__ __forceinline__ float decode(uint32_t w, int sh) {
  constexpr uint32_t kMask = (1u << BITS) - 1;
  constexpr uint32_t kOff = 1u << (BITS - 1);
  const uint32_t u = ((w >> sh) & kMask) ^ (0x4B000000u | kOff);
  return __uint_as_float(u) - (8388608.0f + (float)kOff);
}

}  // namespace
