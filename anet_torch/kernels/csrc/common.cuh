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

// The CUDA-core filterbank of demod_at_energies.cu's float32 route: one
// block takes a tile of SYM_TILE symbols of one stream, staged in shared
// memory with coalesced loads; lane c of every warp holds basis column c
// of the [SPS, 32] basis (cos of 16 tones in columns 0..15, sin in 16..31;
// tones past num_tones are zero columns) in registers, and each warp takes
// every 8th symbol of the tile, reading its samples as float4 broadcasts.
// Needs blocks of DEMOD_THREADS threads and `stage` sized SYM_TILE * SPS
// floats.
constexpr int SYM_TILE = 64;
// Block size of the kernels built on energies_symbols (and of
// tone_energies.cu's plain kernel). A compile-time stride lets the staging
// loop unroll, so each thread keeps several loads in flight.
constexpr int DEMOD_THREADS = 256;

// The staged samples of one symbol (16-byte aligned) against this lane's
// basis column: float4 broadcasts, float32 FMAs in sample order.
template <int SPS>
__device__ __forceinline__ float basis_dot(const float* __restrict__ stage,
                                           const float (&breg)[SPS]) {
  const float4* xs = reinterpret_cast<const float4*>(stage);
  float acc = 0.0f;
#pragma unroll
  for (int j4 = 0; j4 < SPS / 4; ++j4) {
    const float4 v = xs[j4];
    acc = fmaf(v.x, breg[4 * j4 + 0], acc);
    acc = fmaf(v.y, breg[4 * j4 + 1], acc);
    acc = fmaf(v.z, breg[4 * j4 + 2], acc);
    acc = fmaf(v.w, breg[4 * j4 + 3], acc);
  }
  return acc;
}

// One block's tile of n_sym <= SYM_TILE symbols of one row, the first at
// row[base] (zero outside [0, len)): the energy I^2 + Q^2 of every tone,
// out[u * m + c] for the tile's symbol u and tone c < m; lanes 0..m-1 of
// the warp that takes a symbol store it.
template <typename T, int SPS>
__device__ void energies_symbols(const T* __restrict__ row, int64_t len, int64_t base, int n_sym,
                                 int m, const float* __restrict__ basis,
                                 float* __restrict__ stage, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float breg[SPS];
#pragma unroll
  for (int j = 0; j < SPS; ++j) breg[j] = basis[j * 32 + lane];

  for (int i = threadIdx.x; i < n_sym * SPS; i += DEMOD_THREADS)
    stage[i] = load_or_zero(row, base + i, len);
  __syncthreads();
  for (int u = warp; u < n_sym; u += DEMOD_THREADS / 32) {
    const float acc = basis_dot<SPS>(stage + u * SPS, breg);
    const float q = __shfl_down_sync(0xffffffffu, acc, 16);
    if (lane < m) out[u * m + lane] = tone_energy(acc, q);
  }
}

}  // namespace anet
