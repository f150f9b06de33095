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
// 75.5 MB out for ofdm-fast at B = 8192 (S = 12, C = 96), 0.046 ms at
// 3.35 TB/s. The work is ~110 float32 operations a point and three sincosf
// (and for QAM four divisions and roundings a decision pass), ~1 G
// operations at that size, on the CUDA cores: it is close behind the
// bytes, so the passes must add no barriers, no index divisions and no
// sincosf the result does not need.
//
// Design: one warp per stream, WARPS streams a block, and no block-wide
// barrier after staging. Two routes, which the wrapper picks from S and C
// before the launch (kernels._ofdm_track_route) and names by the C entry
// it calls:
// - staged (anet_ofdm_track), wherever one stream's points and weights fit
//   in a block's shared memory (stream_bytes(S, C) <= MAX_SMEM: S <= 302 at
//   C = 96). The block stages its streams' points and w in
// shared memory with cp.async (8 bytes a point, 4 a weight), consecutive
// threads on consecutive addresses in whichever layout the strides give:
// a stream's own row, carriers fastest, in the batch-major layout (each
// warp stages its own stream and syncs only itself); the block's streams
// side by side, streams fastest, in the time-major [S, C, B] layout the
// receiver passes as its [B, S, C] view (point stride 1: a run of WARPS
// streams a carrier; the block syncs once). Then lane l owns carriers
// l, l + 32, ... for every symbol, reading its points from shared memory
// without a bank conflict, so no pass divides an index. Every sum is the
// lane's partial, then a warp xor-shuffle tree in a fixed order, so every
// lane holds the same slope and the same gate, bit for bit. The gate pass
// also stores the rotated points' LLRs and sums their error power, on the
// guess that the gate keeps the rotation (every drifted frame), so each
// point's rotation by the final slope is taken once; where the gate keeps
// the identity (a clean clock's near-tie) or nothing is tracked, one more
// pass stores the unrotated points' over them. The LLRs are stored as the
// stream's contiguous [S, C, bpc] run, a point's planes as one float2
// (QPSK), float4 (16-QAM) or three float2 (64-QAM) from its lane. Phases
// (s + 1) m are float products, exact below 2^24, as the plain version's.
// Lanes past C idle in every pass.
// - global (anet_ofdm_track_global), for longer frames: the block stages
//   only its streams' C weights, and every pass (the two fit iterations,
//   the gate pass, the identity pass) reads the points from global memory
//   by their strides, behind the one accessor `point`. The arithmetic, its
//   order, the shuffle trees and the stores are the staged route's, so both
//   give the same bits. Batch-major, lanes on carriers read a symbol's
//   points coalesced; in the time-major view (point stride 1 between
//   streams) lanes read points B elements apart, a sector each, which the
//   block's streams share in L1. The bound: up to four reads of the points
//   in place of one (a 4,096-byte ofdm-coded frame, S = 343, C = 96, is
//   263,424 bytes of points: at B = 1,024 about 0.40 ms at 3.35 TB/s for
//   four reads plus the LLRs, against 0.16 ms for one), since L2 (50 MB)
//   holds some 190 streams' points, far fewer than B.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // streams a block, fewer where a stream's points need the room
constexpr int THREADS = 32 * WARPS;
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

// The sum of v over the warp, the same in every lane (xor tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Bytes of shared memory a stream takes: its S x C points, then C weights
// (the staged route); only the weights (the global route).
__host__ __device__ __forceinline__ int stream_bytes(int S, int C) {
  return (S * C * 8 + C * 4 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int weight_bytes(int C) { return (C * 4 + 15) / 16 * 16; }

// The LLR planes of a point, one vector store: BPC floats at out.
template <int BPC>
__device__ __forceinline__ void store_planes(float* out, const float (&v)[BPC]) {
  if (BPC == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else if (BPC == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < BPC; k += 2) *reinterpret_cast<float2*>(out + k) = make_float2(v[k], v[k + 1]);
  }
}

// Store the LLR planes of the point (zr, zi), weight w, at out as one
// vector; returns its error power |z - ideal|^2 where `evm` (a symbol
// below evm_rows), else 0.
template <int BPC>
__device__ __forceinline__ float store_point(float* out, float zr, float zi, float w, bool evm) {
  float planes[BPC];
  llr_axis<BPC>(zr, w, planes);
  llr_axis<BPC>(zi, w, planes + BPC / 2);
  store_planes<BPC>(out, planes);
  if (!evm) return 0.0f;
  const float er = zr - ideal<BPC>(zr);
  const float ei = zi - ideal<BPC>(zi);
  return er * er + ei * ei;
}

// STAGED: the points staged in shared memory; else read from global memory
// on every pass.
template <int BPC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
ofdm_track_kernel(const float2* __restrict__ z, int64_t zs_b, int64_t zs_s, int64_t zs_c,
                  const float* __restrict__ hp, int64_t hs_b, int64_t hs_c,
                  const float* __restrict__ slope, int B, int S, int C, int first_carrier,
                  int track, int evm_rows, float* __restrict__ llrs, float* __restrict__ evm2,
                  float* __restrict__ coh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, lg = __ffs(nw) - 1;  // streams a block, a power of two
  const int b0 = blockIdx.x * nw;
  const int b = b0 + warp;
  const int per = STAGED ? stream_bytes(S, C) : weight_bytes(C);
  const int n = S * C;
  const int w_at = STAGED ? 8 * n : 0;  // the weights' byte offset in a stream's share

  // staging (the staged route's points; either route's weights):
  // time-major (stride 1 between streams) streams fastest, the block
  // together; otherwise each warp its own stream, carriers fastest
  if constexpr (STAGED) {
    if (zs_b == 1) {
      for (int s = 0; s < S; ++s)
        for (int i = threadIdx.x; i < C * nw; i += blockDim.x) {
          const int w = i & (nw - 1), c = i >> lg;
          if (b0 + w < B)
            cp_async(smem + w * per + 8 * (s * C + c), z + (b0 + w) + s * zs_s + c * zs_c, 8);
        }
    } else if (b < B) {
      const float2* zb = z + (int64_t)b * zs_b;
      for (int s = 0; s < S; ++s)
        for (int c = lane; c < C; c += 32)
          cp_async(smem + warp * per + 8 * (s * C + c), zb + s * zs_s + c * zs_c, 8);
    }
  }
  if (hs_b == 1) {
    for (int i = threadIdx.x; i < C * nw; i += blockDim.x) {
      const int w = i & (nw - 1), c = i >> lg;
      if (b0 + w < B) cp_async(smem + w * per + w_at + 4 * c, hp + (b0 + w) + c * hs_c, 4);
    }
  } else if (b < B) {
    for (int c = lane; c < C; c += 32)
      cp_async(smem + warp * per + w_at + 4 * c, hp + (int64_t)b * hs_b + c * hs_c, 4);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if ((STAGED && zs_b == 1) || hs_b == 1)
    __syncthreads();  // the only block-wide barrier: the block staged its streams together
  else
    __syncwarp();
  if (b >= B) return;
  const float2* sz = reinterpret_cast<const float2*>(smem + warp * per);  // [S][C], staged
  const float* sw = reinterpret_cast<const float*>(smem + warp * per + w_at);  // [C]
  const float2* zb = z + (int64_t)b * zs_b;
  // point (s, c) of the stream: staged, or read by its strides
  const auto point = [&](int s, int c) -> float2 {
    if constexpr (STAGED)
      return sz[s * C + c];
    else
      return zb[s * zs_s + c * zs_c];
  };

  float cc = 0.0f;
  bool keep = false;
  float e = 0.0f;  // error power of the points whose LLRs were stored
  float* out = llrs + (int64_t)b * n * BPC;
  if (track) {
    cc = slope[b];
    for (int it = 0; it < 2; ++it) {
      float num = 0.0f, den = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float w = sw[c], fm = (float)(c + first_carrier);
        float fs = 0.0f;  // s + 1, exact
#pragma unroll 4
        for (int s = 0; s < S; ++s) {
          fs += 1.0f;
          const float phase = fs * fm;  // (s + 1) m, exact below 2^24
          float zr, zi, ure, uim;
          rotate(point(s, c), cc * phase, zr, zi);
          decision_product<BPC>(zr, zi, w, ure, uim);
          num += phase * uim;
          den += phase * phase * fmaxf(ure, 0.0f);
        }
      }
      num = warp_sum(num);
      den = warp_sum(den);
      cc = cc + num / fmaxf(den, 1e-20f);
    }
    // the gate's sums, and the rotated points' LLRs and error power stored
    // on the guess that the gate keeps the rotation (a drifted frame's
    // case): the rotation is taken once a point, and the LLR pass below
    // runs only where the gate keeps the identity
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // tracked sum(Re u), sum|u|; unrotated the same
    for (int c = lane; c < C; c += 32) {
      const float w = sw[c], fm = (float)(c + first_carrier);
      float fs = 0.0f;
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        fs += 1.0f;
        const float2 p = point(s, c);
        float zr, zi, ure, uim;
        rotate(p, cc * (fs * fm), zr, zi);
        decision_product<BPC>(zr, zi, w, ure, uim);
        v[0] += ure;
        v[1] += sqrtf(ure * ure + uim * uim);
        decision_product<BPC>(p.x, p.y, w, ure, uim);
        v[2] += ure;
        v[3] += sqrtf(ure * ure + uim * uim);
        e += store_point<BPC>(out + (int64_t)(s * C + c) * BPC, zr, zi, w, s < evm_rows);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = warp_sum(v[i]);
    const float coh1 = v[0] / fmaxf(v[1], 1e-20f);
    const float coh0 = v[2] / fmaxf(v[3], 1e-20f);
    keep = coh1 > coh0;
    if (coh != nullptr && lane == 0) reinterpret_cast<float2*>(coh)[b] = make_float2(coh1, coh0);
  }
  if (!keep) {  // untracked, or the gate keeps the identity: the points as they are
    e = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float w = sw[c];
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float2 p = point(s, c);
        e += store_point<BPC>(out + (int64_t)(s * C + c) * BPC, p.x, p.y, w, s < evm_rows);
      }
    }
  }
  e = warp_sum(e);
  if (lane == 0) evm2[b] = e / (float)(evm_rows * C);
}

template <int BPC, bool STAGED>
cudaError_t launch(const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c, const void* hp,
                   int64_t hs_b, int64_t hs_c, const void* slope, int B, int S, int C,
                   int first_carrier, int track, int evm_rows, void* llrs, void* evm2, void* coh,
                   cudaStream_t st) {
  static size_t smem_set = 48 * 1024;  // this instantiation's dynamic shared memory limit
  const int per = STAGED ? stream_bytes(S, C) : weight_bytes(C);
  int nw = WARPS;
  while (nw > 1 && (size_t)nw * per > MAX_SMEM) nw /= 2;
  const size_t smem = (size_t)nw * per;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ofdm_track_kernel<BPC, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  ofdm_track_kernel<BPC, STAGED><<<(B + nw - 1) / nw, 32 * nw, smem, st>>>(
      static_cast<const float2*>(z), zs_b, zs_s, zs_c, static_cast<const float*>(hp), hs_b, hs_c,
      static_cast<const float*>(slope), B, S, C, first_carrier, track, evm_rows,
      static_cast<float*>(llrs), static_cast<float*>(evm2), static_cast<float*>(coh));
  return cudaGetLastError();
}

template <bool STAGED>
int dispatch(const void* z, long long zs_b, long long zs_s, long long zs_c, const void* hp,
             long long hs_b, long long hs_c, const void* slope, int B, int S, int C, int bpc,
             int first_carrier, int track, int evm_rows, void* llrs, void* evm2, void* coh,
             void* stream) {
  if (B < 1 || S < 1 || C < 1 || evm_rows < 1 || evm_rows > S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (bpc) {
    case 2:
      return (int)launch<2, STAGED>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                    first_carrier, track, evm_rows, llrs, evm2, coh, st);
    case 4:
      return (int)launch<4, STAGED>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                    first_carrier, track, evm_rows, llrs, evm2, coh, st);
    case 6:
      return (int)launch<6, STAGED>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                    first_carrier, track, evm_rows, llrs, evm2, coh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The staged route. z: complex64 [B, S, C] read by strides (zs_*, in
// complex elements, 8-byte aligned); hp: float32 [B, C] by strides; slope:
// float32 [B]; llrs: float32 [B, S * C * bpc] contiguous, 16-byte aligned;
// evm2: float32 [B]; coh: float32 [B, 2] contiguous (tracked, unrotated
// coherence) or null, written only when track != 0. Refuses (returns
// cudaErrorInvalidValue) a stream whose points do not fit in shared memory.
// Returns the launch's cudaError_t.
extern "C" int anet_ofdm_track(const void* z, long long zs_b, long long zs_s, long long zs_c,
                               const void* hp, long long hs_b, long long hs_c, const void* slope,
                               int B, int S, int C, int bpc, int first_carrier, int track,
                               int evm_rows, void* llrs, void* evm2, void* coh, void* stream) {
  return dispatch<true>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, bpc, first_carrier,
                        track, evm_rows, llrs, evm2, coh, stream);
}

// The global route: the same arguments and outputs, the points read from
// global memory on every pass, any S.
extern "C" int anet_ofdm_track_global(const void* z, long long zs_b, long long zs_s,
                                      long long zs_c, const void* hp, long long hs_b,
                                      long long hs_c, const void* slope, int B, int S, int C,
                                      int bpc, int first_carrier, int track, int evm_rows,
                                      void* llrs, void* evm2, void* coh, void* stream) {
  return dispatch<false>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, bpc, first_carrier,
                         track, evm_rows, llrs, evm2, coh, stream);
}
