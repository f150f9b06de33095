// Shared device helpers of the anet_torch kernels (sm_90a).
//
// Input samples arrive as float32 (dtype code 0) or bfloat16 (code 1) and
// are widened to float32 on load; every sum accumulates in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace anet {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Argmax and sum over the 16 tone energies held by lanes 0..15 of a warp
// (lanes 16..31 pass anything; they are outside the width-16 segment that
// holds lane 0). Result valid in lane 0.
__device__ __forceinline__ void tone_reduce16(float e, int& tone, float& best, float& total) {
  float bq = e, tot = e;
  int bi = threadIdx.x & 15;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    float oq = __shfl_down_sync(0xffffffffu, bq, off, 16);
    int oi = __shfl_down_sync(0xffffffffu, bi, off, 16);
    tot += __shfl_down_sync(0xffffffffu, tot, off, 16);
    if (better(oq, oi, bq, bi)) {
      bq = oq;
      bi = oi;
    }
  }
  tone = bi;
  best = bq;
  total = tot;
}

// One block demodulates symbols [s_begin, s_end) of one stream whose data
// section starts at row[d0]: per symbol, the SPS samples hit the [SPS, 32]
// basis (cos of 16 tones in columns 0..15, sin in 16..31; tones past
// num_tones are zero columns and never win an argmax), then I^2+Q^2,
// argmax (first index on ties), best and total.
//
// Lane c of every warp holds basis column c in registers; a tile of
// SYM_TILE symbols is staged in shared memory with coalesced loads, and
// each warp takes every (blockDim/32)-th symbol of the tile, reading its
// samples as float4 broadcasts. Needs blockDim.x a multiple of 32 and
// `stage` sized SYM_TILE * SPS floats.
constexpr int SYM_TILE = 64;

template <typename T, int SPS>
__device__ void demod_symbols(const T* __restrict__ row, int64_t len, int64_t d0,
                              int s_begin, int s_end, const float* __restrict__ basis,
                              float* __restrict__ stage, int32_t* __restrict__ tone_out,
                              float* __restrict__ best_out, float* __restrict__ total_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float breg[SPS];
#pragma unroll
  for (int j = 0; j < SPS; ++j) breg[j] = basis[j * 32 + lane];

  for (int t0 = s_begin; t0 < s_end; t0 += SYM_TILE) {
    const int n_sym = min(SYM_TILE, s_end - t0);
    const int64_t base = d0 + (int64_t)t0 * SPS;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < n_sym * SPS; i += blockDim.x)
      stage[i] = load_or_zero(row, base + i, len);
    __syncthreads();
    for (int u = warp; u < n_sym; u += n_warps) {
      const float4* xs = reinterpret_cast<const float4*>(stage + u * SPS);
      float acc = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < SPS / 4; ++j4) {
        const float4 v = xs[j4];
        acc = fmaf(v.x, breg[4 * j4 + 0], acc);
        acc = fmaf(v.y, breg[4 * j4 + 1], acc);
        acc = fmaf(v.z, breg[4 * j4 + 2], acc);
        acc = fmaf(v.w, breg[4 * j4 + 3], acc);
      }
      const float q = __shfl_down_sync(0xffffffffu, acc, 16);
      const float e = acc * acc + q * q;  // valid in lanes 0..15
      int tone;
      float best, total;
      tone_reduce16(e, tone, best, total);
      if (lane == 0) {
        const int s = t0 + u;
        tone_out[s] = tone;
        best_out[s] = best;
        total_out[s] = total;
      }
    }
  }
}

}  // namespace anet
