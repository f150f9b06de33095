// Shared device helpers of the anet_torch kernels (sm_90a).
//
// Input samples arrive as float32 (dtype code 0), bfloat16 (code 1) or
// int8 (code 2, the quantized stream buffers and captures) and are widened
// to float32 on load; every sum accumulates in float32. With int8 samples
// and the x127 integer basis every product is an integer of at most
// 127^2 = 16,129 and a symbol sums at most 128 of them, below 2^24: the
// float32 sums are then exactly the reference kernels' int32 I/Q.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace anet {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_I8 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// I^2 + Q^2 rounded after each operation (no fused multiply-add), as the
// reference and the plain versions compute it: integer I/Q from int8
// samples tie often, and only bit-equal energies give the same argmax.
__device__ __forceinline__ float tone_energy(float i, float q) {
  return __fadd_rn(__fmul_rn(i, i), __fmul_rn(q, q));
}

// Sample i of a row of length len; zero outside [0, len), the zero padding
// the reference kernels read past either end of a buffer.
template <typename T>
__device__ __forceinline__ float load_or_zero(const T* row, int64_t i, int64_t len) {
  return (i >= 0 && i < len) ? to_f32(row[i]) : 0.0f;
}

// (value, index) pair reductions that keep the FIRST index on ties, as
// jnp.argmax / torch.argmax do.
__device__ __forceinline__ bool better(float qa, int ia, float qb, int ib) {
  return qa > qb || (qa == qb && ia < ib);
}

}  // namespace anet
