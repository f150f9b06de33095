// ofdm_track_decide_fused: the OFDM equalizer's back half, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py ofdm_track_decide_fused
// (pallas_call at line 2718, body _ofdm_track_kernel at line 2542). Per
// stream, on its equalized symbol estimates z_eq[S, C] (complex64), the
// per-carrier channel power w[C] and the preamble slope seed c0:
//   1. with clock tracking, two decision-directed fit iterations of the
//      drift slope c: rotate every point by exp(-i c (s+1) m) (m the absolute
//      carrier index), hard-decide it, u = w z conj(d), then
//      c += sum((s+1) m Im u) / max(sum(((s+1) m)^2 max(Re u, 0)), 1e-20);
//   2. the identity gate: keep the fitted rotation only where the weighted
//      decision coherence sum(Re u) / sum(|u|) of the rotated points beats
//      that of the unrotated ones (ties keep the identity);
//   3. the max-log LLR planes of the kept points, written straight into the
//      interleaved layout [S, C, bpc] (QPSK -(a w); 16-QAM sign, inner;
//      64-QAM sign, mid, inner; I planes then Q planes);
//   4. evm2 = mean over the first evm_rows symbols of |z - ideal|^2, with
//      the ideal point implied by the LLR signs (strict boundaries, as
//      bits_to_carriers(llrs > 0) gives it).
// Decisions round half to even (rintf), as jnp.round; angles reach several
// radians, so the accurate sincosf, never __sincosf, and no fast math.
//
// What bounds it on the H100: the bytes. One read of z_eq (8 bytes a point)
// and of w, one write of the LLRs (4 x bpc bytes a point): 75.5 MB in and
// 75.5 MB out for ofdm-fast at B = 8192 (S = 12, C = 96), 0.05 ms at
// 3.35 TB/s. The work is ~100 float32 operations a point and pass (four
// passes), ~9 GFLOP there: 0.14 ms on the CUDA cores at 67 TFLOP/s, so this
// simple form is held by its arithmetic and its block-wide barriers.
//
// Design: one block of 128 threads per stream. The block stages its
// stream's S x C points (S * C * 8 bytes, 9.2 KB for ofdm-fast) and w in
// shared memory, so device memory is read once; each pass is a strided
// loop over the points followed by a block-wide sum (warp shuffles, then
// one slot per warp in shared memory, summed in the same order by every
// thread, so all threads hold the same slope and the same gate). z_eq is
// read by strides, so the time-major receiver passes its [S, C, B] layout
// as a [B, S, C] view and nothing is transposed. Nothing of the TPU
// kernel's tiling survives: no padding of S to 8, no batch tile, no
// single-axis reduce.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block can opt in to

// Constants rounded once from double, as the reference's Python floats are.
constexpr float QPSK_AMP = (float)0.7071067811865476;
constexpr float S16 = (float)0.31622776601683794;
constexpr float S16_2 = (float)(2.0 * 0.31622776601683794);
constexpr float S64 = (float)0.1543033499620919;
constexpr float S64_2 = (float)(2.0 * 0.1543033499620919);
constexpr float S64_4 = (float)(4.0 * 0.1543033499620919);
constexpr float S64_6 = (float)(6.0 * 0.1543033499620919);

// Nearest odd level in [-max_level, max_level], times scale.
__device__ __forceinline__ float qam_nearest(float a, float scale, float max_level) {
  const float v = 2.0f * rintf((a / scale - 1.0f) / 2.0f) + 1.0f;
  return fminf(fmaxf(v, -max_level), max_level) * scale;
}

// The hard decision inside the fit (ofdm._hard_decision per axis).
template <int BPC>
__device__ __forceinline__ float decide(float a) {
  if (BPC == 2) return a >= 0.0f ? QPSK_AMP : -QPSK_AMP;
  if (BPC == 4) return qam_nearest(a, S16, 3.0f);
  return qam_nearest(a, S64, 7.0f);
}

// The constellation point the LLR signs imply (strict boundaries).
template <int BPC>
__device__ __forceinline__ float ideal(float a) {
  if (BPC == 2) return a < 0.0f ? -QPSK_AMP : QPSK_AMP;
  const float mag_a = fabsf(a);
  const float sign = a > 0.0f ? 1.0f : -1.0f;
  if (BPC == 4) return sign * (mag_a < S16_2 ? 1.0f : 3.0f) * S16;
  const float mag = mag_a <= S64_2 ? 1.0f : mag_a < S64_4 ? 3.0f : mag_a < S64_6 ? 5.0f : 7.0f;
  return sign * mag * S64;
}

// The LLR planes of one axis into out[0 .. BPC/2).
template <int BPC>
__device__ __forceinline__ void llr_axis(float a, float w, float* out) {
  if (BPC == 2) {
    out[0] = -(a * w);
  } else if (BPC == 4) {
    out[0] = a * w;
    out[1] = (S16_2 - fabsf(a)) * w;
  } else {
    const float mag = fabsf(a);
    out[0] = a * w;
    out[1] = (S64_4 - mag) * w;
    out[2] = (S64_2 - fabsf(mag - S64_4)) * w;
  }
}

// Sums N values over the block; every thread gets the totals, added in
// the same order, so they agree bit for bit.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*red)[WARPS]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  __syncthreads();  // the previous sum's readers are done with red
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][threadIdx.x >> 5] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[i][w];
    v[i] = s;
  }
}

// z rotated by exp(-i ang).
__device__ __forceinline__ void rotate(float2 z, float ang, float& zr, float& zi) {
  float si, co;
  sincosf(ang, &si, &co);
  zr = z.x * co + z.y * si;
  zi = z.y * co - z.x * si;
}

// u = w z conj(d(z)): (Re u, Im u).
template <int BPC>
__device__ __forceinline__ void decision_product(float zr, float zi, float w, float& ure, float& uim) {
  const float dre = decide<BPC>(zr);
  const float dim = decide<BPC>(zi);
  ure = w * (zr * dre + zi * dim);
  uim = w * (zi * dre - zr * dim);
}

template <int BPC>
__global__ void __launch_bounds__(THREADS)
ofdm_track_kernel(const float2* __restrict__ z, int64_t zs_b, int64_t zs_s, int64_t zs_c,
                  const float* __restrict__ hp, int64_t hs_b, int64_t hs_c,
                  const float* __restrict__ slope, int S, int C, int first_carrier, int track,
                  int evm_rows, float* __restrict__ llrs, float* __restrict__ evm2,
                  float* __restrict__ coh) {
  extern __shared__ float2 sz[];                          // [S * C] this stream's points
  float* sw = reinterpret_cast<float*>(sz + (size_t)S * C);  // [C] channel power
  __shared__ float red[4][WARPS];

  const int b = blockIdx.x;
  const int n = S * C;
  const float2* zb = z + (int64_t)b * zs_b;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const int s = p / C, c = p - s * C;
    sz[p] = zb[(int64_t)s * zs_s + (int64_t)c * zs_c];
  }
  for (int c = threadIdx.x; c < C; c += THREADS) sw[c] = hp[(int64_t)b * hs_b + (int64_t)c * hs_c];
  __syncthreads();

  float cc = 0.0f;
  bool keep = false;
  if (track) {
    cc = slope[b];
    for (int it = 0; it < 2; ++it) {
      float v[2] = {0.0f, 0.0f};  // num, den
      for (int p = threadIdx.x; p < n; p += THREADS) {
        const int s = p / C, c = p - s * C;
        const float phase = (float)((s + 1) * (c + first_carrier));
        float zr, zi, ure, uim;
        rotate(sz[p], cc * phase, zr, zi);
        decision_product<BPC>(zr, zi, sw[c], ure, uim);
        v[0] += phase * uim;
        v[1] += phase * phase * fmaxf(ure, 0.0f);
      }
      block_sum(v, red);
      cc = cc + v[0] / fmaxf(v[1], 1e-20f);
    }
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // tracked sum(Re u), sum|u|; unrotated the same
    for (int p = threadIdx.x; p < n; p += THREADS) {
      const int s = p / C, c = p - s * C;
      const float w = sw[c];
      float zr, zi, ure, uim;
      rotate(sz[p], cc * (float)((s + 1) * (c + first_carrier)), zr, zi);
      decision_product<BPC>(zr, zi, w, ure, uim);
      v[0] += ure;
      v[1] += sqrtf(ure * ure + uim * uim);
      decision_product<BPC>(sz[p].x, sz[p].y, w, ure, uim);
      v[2] += ure;
      v[3] += sqrtf(ure * ure + uim * uim);
    }
    block_sum(v, red);
    const float coh1 = v[0] / fmaxf(v[1], 1e-20f);
    const float coh0 = v[2] / fmaxf(v[3], 1e-20f);
    keep = coh1 > coh0;
    if (coh != nullptr && threadIdx.x == 0) {
      coh[2 * (int64_t)b] = coh1;
      coh[2 * (int64_t)b + 1] = coh0;
    }
  }

  float e[1] = {0.0f};
  float* out = llrs + (int64_t)b * n * BPC;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const int s = p / C, c = p - s * C;
    const float w = sw[c];
    float zr = sz[p].x, zi = sz[p].y;
    if (keep) rotate(sz[p], cc * (float)((s + 1) * (c + first_carrier)), zr, zi);
    float planes[BPC];
    llr_axis<BPC>(zr, w, planes);
    llr_axis<BPC>(zi, w, planes + BPC / 2);
#pragma unroll
    for (int k = 0; k < BPC; ++k) out[(int64_t)p * BPC + k] = planes[k];
    if (s < evm_rows) {
      const float er = zr - ideal<BPC>(zr);
      const float ei = zi - ideal<BPC>(zi);
      e[0] += er * er + ei * ei;
    }
  }
  block_sum(e, red);
  if (threadIdx.x == 0) evm2[b] = e[0] / (float)(evm_rows * C);
}

template <int BPC>
cudaError_t launch(const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c, const void* hp,
                   int64_t hs_b, int64_t hs_c, const void* slope, int B, int S, int C,
                   int first_carrier, int track, int evm_rows, void* llrs, void* evm2, void* coh,
                   cudaStream_t st) {
  const size_t smem = (size_t)S * C * sizeof(float2) + (size_t)C * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ofdm_track_kernel<BPC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ofdm_track_kernel<BPC><<<B, THREADS, smem, st>>>(
      static_cast<const float2*>(z), zs_b, zs_s, zs_c, static_cast<const float*>(hp), hs_b, hs_c,
      static_cast<const float*>(slope), S, C, first_carrier, track, evm_rows,
      static_cast<float*>(llrs), static_cast<float*>(evm2), static_cast<float*>(coh));
  return cudaGetLastError();
}

}  // namespace

// z: complex64 [B, S, C] read by strides (zs_*, in complex elements, 8-byte
// aligned); hp: float32 [B, C] by strides; slope: float32 [B]; llrs:
// float32 [B, S * C * bpc] contiguous; evm2: float32 [B]; coh: float32
// [B, 2] (tracked, unrotated coherence) or null, written only when
// track != 0. Returns the launch's cudaError_t.
extern "C" int anet_ofdm_track(const void* z, long long zs_b, long long zs_s, long long zs_c,
                               const void* hp, long long hs_b, long long hs_c, const void* slope,
                               int B, int S, int C, int bpc, int first_carrier, int track,
                               int evm_rows, void* llrs, void* evm2, void* coh, void* stream) {
  if (B < 1 || S < 1 || C < 1 || evm_rows < 1 || evm_rows > S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (bpc) {
    case 2:
      return (int)launch<2>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                            track, evm_rows, llrs, evm2, coh, st);
    case 4:
      return (int)launch<4>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                            track, evm_rows, llrs, evm2, coh, st);
    case 6:
      return (int)launch<6>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                            track, evm_rows, llrs, evm2, coh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
