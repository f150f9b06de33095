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
// Two routes, which the wrapper picks from S and C before the launch
// (kernels._ofdm_track_route, by the staged route's warps an SM, one boundary
// for both layouts, whose bits agree only on one route) and names by the C
// entry it calls:
// - staged (anet_ofdm_track): one warp per stream, WARPS streams a block,
//   and no block-wide barrier after staging. The block stages its streams'
//   points and w in shared memory with cp.async (8 bytes a point, 4 a
//   weight), consecutive threads on consecutive addresses in whichever
//   layout the strides give: a stream's own row, carriers fastest, in the
//   batch-major layout (each warp stages its own stream and syncs only
//   itself); the block's streams side by side, streams fastest, in the
//   time-major [S, C, B] layout the receiver passes as its [B, S, C] view
//   (point stride 1: a run of WARPS streams a carrier; the block syncs
//   once). Then lane l owns carriers l, l + 32, ... for every symbol,
//   reading its points from shared memory without a bank conflict, so no
//   pass divides an index. Every sum is the lane's partial, then a warp
//   xor-shuffle tree in a fixed order, so every lane holds the same slope
//   and the same gate, bit for bit. The gate pass also stores the rotated
//   points' LLRs and sums their error power, on the guess that the gate
//   keeps the rotation (every drifted frame), so each point's rotation by
//   the final slope is taken once; where the gate keeps the identity (a
//   clean clock's near-tie) or nothing is tracked, one more pass stores the
//   unrotated points' over them. The LLRs are stored as the stream's
//   contiguous [S, C, bpc] run, a point's planes as one float2 (QPSK),
//   float4 (16-QAM) or three float2 (64-QAM) from its lane. Phases (s + 1)
//   m are float products, exact below 2^24, as the plain version's. Lanes
//   past C idle in every pass. A stream must fit in a block's shared memory
//   (S <= 302 at C = 96), and the room it takes sets the warps an SM: 20 at
//   S = 12, 12 at 19-24, 8 at 25-37, 4 at 38-75, 2 at 76-150, 1 from 151 on.
// - block (anet_ofdm_track_block), wherever the staged route would keep
//   fewer than 8 warps an SM (S > 37 at C = 96), so for every stream past
//   shared memory: one block of NW warps per stream (NW from S,
//   block_warps: a power of two, about RUN = 12 symbols a warp, at most
//   32), so every SM holds 32 warps
//   whatever S is (__launch_bounds__(1024, 1): at most 64 registers a
//   thread). Lanes own carriers l, l + 32, ... as above; warp k owns the
//   contiguous symbols [k S / NW, (k + 1) S / NW). A pass's per-lane
//   partials go through the warp's xor tree, then into shared memory,
//   where every thread sums the NW warps' values in warp order: one barrier
//   a reduction (each reduction has slots of its own), and every warp holds
//   the same slope and gate, so a stream's bits do not depend on
//   scheduling. Only the weights are staged; each pass reads the points
//   from global memory, L2 after the first: at S = 343 an SM's 32 warps
//   hold one stream, 132 x 263,424 bytes = 35 MB of points in flight,
//   inside the 50 MB L2, so HBM sees the points about once, as the bound
//   counts them. (Keeping each warp's first symbols in shared memory from
//   the first pass, about 9 a warp in 228 KB an SM, measured slower at all
//   but two shapes: tools/exp_ofdm_stage.py, PERF.md.) The LLRs go out with
//   streaming stores (st.global.cs), which keep them from evicting the
//   points. In the time-major view a
//   block takes G = 4 streams: their points at (s, c) are one 32-byte
//   sector, which a lane loads as two 16-byte vectors and works through
//   stream by stream, where one stream a block read a sector for each 8
//   bytes. Every rounding of the block route's arithmetic is spelled out
//   (__fmaf_rn, __fmul_rn: nothing left to the compiler's contraction), so
//   G = 1 and G = 4 give the same bits and the two layouts agree. What
//   binds it: the instructions, about 242 a point of a drifted QPSK stream
//   off sincosf's slow path (sass_mix --loops), 0.24 ms at S = 343, B =
//   1,024 on 132 SMs issuing 4 a clock at 1,980 MHz, above the bytes'
//   0.16 ms.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // streams a block, fewer where a stream's points need the room
constexpr int THREADS = 32 * WARPS;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block can opt in to
// The block route: the most warps a stream takes, the symbols a warp aims
// for, and its reductions' slots (floats a stream).
constexpr int BLOCK_WARPS = 32;
constexpr int RUN = 12;
constexpr int RED_SLOTS = 9;  // two fit iterations x 2 sums, the gate's 4, the error power

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

// The block route's rotation, decision product and magnitude with every
// rounding spelled out (no contraction left to the compiler), so its
// instantiations (1 or 4 streams a block) give the same bits.
__device__ __forceinline__ void rotate_rn(float2 z, float ang, float& zr, float& zi) {
  float si, co;
  sincosf(ang, &si, &co);
  zr = __fmaf_rn(z.x, co, __fmul_rn(z.y, si));
  zi = __fmaf_rn(z.y, co, -__fmul_rn(z.x, si));
}

template <int BPC>
__device__ __forceinline__ void decision_product_rn(float zr, float zi, float w, float& ure, float& uim) {
  const float dre = decide<BPC>(zr);
  const float dim = decide<BPC>(zi);
  ure = __fmul_rn(w, __fmaf_rn(zr, dre, __fmul_rn(zi, dim)));
  uim = __fmul_rn(w, __fmaf_rn(zi, dre, -__fmul_rn(zr, dim)));
}

__device__ __forceinline__ float magnitude_rn(float a, float b) {
  return __fsqrt_rn(__fmaf_rn(a, a, __fmul_rn(b, b)));
}

// The sum of v over the warp, the same in every lane (xor tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of each v[i] over the block, the same in every thread: each
// warp's xor tree, then the nw warps' sums in warp order from shared memory
// (slot: NV x BLOCK_WARPS floats that this reduction alone writes, so one
// barrier does).
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* slot, int lane, int warp, int nw) {
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) slot[i * BLOCK_WARPS + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float t = slot[i * BLOCK_WARPS];
    for (int k = 1; k < nw; ++k) t += slot[i * BLOCK_WARPS + k];
    v[i] = t;
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Bytes of shared memory a stream takes on the staged route: its S x C
// points, then C weights; the block route stages only the weights.
__host__ __device__ __forceinline__ int stream_bytes(int S, int C) {
  return (S * C * 8 + C * 4 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int weight_bytes(int C) { return (C * 4 + 15) / 16 * 16; }

// The block route's warps a stream: a power of two (so 32 warps an SM take
// whole blocks), about RUN symbols a warp, at most BLOCK_WARPS.
int block_warps(int S) {
  int nw = 1;
  while (nw < BLOCK_WARPS && nw * RUN < S) nw *= 2;
  return nw;
}

// The LLR planes of a point, one vector store: BPC floats at out; BLOCK
// (the block route) a streaming store (st.global.cs, evict first).
template <int BPC, bool BLOCK = false>
__device__ __forceinline__ void store_planes(float* out, const float (&v)[BPC]) {
  if (BPC == 2) {
    const float2 x = make_float2(v[0], v[1]);
    if (BLOCK)
      __stcs(reinterpret_cast<float2*>(out), x);
    else
      *reinterpret_cast<float2*>(out) = x;
  } else if (BPC == 4) {
    const float4 x = make_float4(v[0], v[1], v[2], v[3]);
    if (BLOCK)
      __stcs(reinterpret_cast<float4*>(out), x);
    else
      *reinterpret_cast<float4*>(out) = x;
  } else {
#pragma unroll
    for (int k = 0; k < BPC; k += 2) {
      const float2 x = make_float2(v[k], v[k + 1]);
      if (BLOCK)
        __stcs(reinterpret_cast<float2*>(out + k), x);
      else
        *reinterpret_cast<float2*>(out + k) = x;
    }
  }
}

// Store the LLR planes of the point (zr, zi), weight w, at out as one
// vector; returns its error power |z - ideal|^2 where `evm` (a symbol
// below evm_rows), else 0 (BLOCK: streaming stores, the power's rounding
// spelled out).
template <int BPC, bool BLOCK = false>
__device__ __forceinline__ float store_point(float* out, float zr, float zi, float w, bool evm) {
  float planes[BPC];
  llr_axis<BPC>(zr, w, planes);
  llr_axis<BPC>(zi, w, planes + BPC / 2);
  store_planes<BPC, BLOCK>(out, planes);
  if (!evm) return 0.0f;
  const float er = zr - ideal<BPC>(zr);
  const float ei = zi - ideal<BPC>(zi);
  if (BLOCK) return __fmaf_rn(er, er, __fmul_rn(ei, ei));
  return er * er + ei * ei;
}

// The staged route: a warp a stream, its points staged in shared memory.
template <int BPC>
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
  const int per = stream_bytes(S, C);
  const int n = S * C;
  const int w_at = 8 * n;  // the weights' byte offset in a stream's share

  // staging: time-major (stride 1 between streams) streams fastest, the
  // block together; otherwise each warp its own stream, carriers fastest
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
  if (zs_b == 1 || hs_b == 1)
    __syncthreads();  // the only block-wide barrier: the block staged its streams together
  else
    __syncwarp();
  if (b >= B) return;
  const float2* sz = reinterpret_cast<const float2*>(smem + warp * per);  // [S][C]
  const float* sw = reinterpret_cast<const float*>(smem + warp * per + w_at);  // [C]
  // point (s, c) of the stream
  const auto point = [&](int s, int c) -> float2 { return sz[s * C + c]; };

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

// The block route: G streams (blockIdx.x G, ...) on nw = blockDim.x / 32
// warps. A thread's arithmetic on each stream is the same for G = 1 and 4,
// so G changes no bit; G = 4 in the time-major view, where the 4 streams'
// points at (s, c) share a 32-byte sector.
template <int BPC, int G>
__global__ void __launch_bounds__(32 * BLOCK_WARPS, 1)
ofdm_track_block_kernel(const float2* __restrict__ z, int64_t zs_b, int64_t zs_s, int64_t zs_c,
                        const float* __restrict__ hp, int64_t hs_b, int64_t hs_c,
                        const float* __restrict__ slope, int B, int S, int C, int first_carrier,
                        int track, int evm_rows, float* __restrict__ llrs,
                        float* __restrict__ evm2, float* __restrict__ coh) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[RED_SLOTS * G * BLOCK_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b0 = blockIdx.x * G;
  const int ng = B - b0 < G ? B - b0 : G;  // the block's streams
  float* sw = reinterpret_cast<float*>(smem);  // [G][C]
  for (int i = threadIdx.x; i < G * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    sw[i] = j < ng ? hp[(int64_t)(b0 + j) * hs_b + c * hs_c] : 0.0f;
  }
  // this warp's symbols [s0, s0 + run)
  const int s0 = warp * S / nw, run = (warp + 1) * S / nw - s0;
  const float2* zw = z + (int64_t)b0 * zs_b + (int64_t)s0 * zs_s;
  // 4 streams' points at (s, c) as two 16-byte loads: one whole sector
  const bool vec = G == 4 && ng == 4 && zs_b == 1 && zs_s % 2 == 0 && zs_c % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(zw) % 16 == 0;
  __syncthreads();
  // the streams' points (s0 + r, c); a stream past B reads stream b0's and
  // stores nothing
  const auto fetch = [&](int r, int c, float2(&p)[G]) {
    const float2* at = zw + r * zs_s + c * zs_c;
    if constexpr (G == 4) {
      if (vec) {
        const float4 lo = reinterpret_cast<const float4*>(at)[0];
        const float4 hi = reinterpret_cast<const float4*>(at)[1];
        p[0] = make_float2(lo.x, lo.y);
        p[1] = make_float2(lo.z, lo.w);
        p[2] = make_float2(hi.x, hi.y);
        p[3] = make_float2(hi.z, hi.w);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) p[j] = at[(j < ng ? j : 0) * zs_b];
  };
  const auto out = [&](int j, int r, int c) {
    return llrs + (((int64_t)(b0 + j) * S + s0 + r) * C + c) * BPC;
  };

  float cc[G];
  bool keep[G];
  float e[G];  // error power of the points whose LLRs were stored
#pragma unroll
  for (int j = 0; j < G; ++j) {
    cc[j] = track && j < ng ? slope[b0 + j] : 0.0f;
    keep[j] = false;
    e[j] = 0.0f;
  }
  if (track) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      float v[2 * G];  // each stream's sum((s+1) m Im u), sum(((s+1) m)^2 max(Re u, 0))
#pragma unroll
      for (int i = 0; i < 2 * G; ++i) v[i] = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float fm = (float)(c + first_carrier);
        float w[G];
#pragma unroll
        for (int j = 0; j < G; ++j) w[j] = sw[j * C + c];
        float fs = (float)s0;  // s + 1 after the increment, exact
#pragma unroll(G == 1 ? 4 : 1)
        for (int r = 0; r < run; ++r) {
          fs += 1.0f;
          const float phase = fs * fm;  // (s + 1) m, exact below 2^24
          float2 p[G];
          fetch(r, c, p);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            float zr, zi, ure, uim;
            rotate_rn(p[j], __fmul_rn(cc[j], phase), zr, zi);
            decision_product_rn<BPC>(zr, zi, w[j], ure, uim);
            v[2 * j] = __fmaf_rn(phase, uim, v[2 * j]);
            v[2 * j + 1] = __fmaf_rn(__fmul_rn(phase, phase), fmaxf(ure, 0.0f), v[2 * j + 1]);
          }
        }
      }
      block_sum(v, red + 2 * G * it * BLOCK_WARPS, lane, warp, nw);
#pragma unroll
      for (int j = 0; j < G; ++j) cc[j] = cc[j] + v[2 * j] / fmaxf(v[2 * j + 1], 1e-20f);
    }
    // the gate, with the rotated points' LLRs stored on the guess that it
    // keeps the rotation (as the staged route)
    float v[4 * G];  // each stream's tracked sum(Re u), sum|u|; unrotated the same
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) v[i] = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float fm = (float)(c + first_carrier);
      float w[G];
#pragma unroll
      for (int j = 0; j < G; ++j) w[j] = sw[j * C + c];
      float fs = (float)s0;
#pragma unroll(G == 1 ? 4 : 1)
      for (int r = 0; r < run; ++r) {
        fs += 1.0f;
        float2 p[G];
        fetch(r, c, p);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          float zr, zi, ure, uim;
          rotate_rn(p[j], __fmul_rn(cc[j], fs * fm), zr, zi);
          decision_product_rn<BPC>(zr, zi, w[j], ure, uim);
          v[4 * j] += ure;
          v[4 * j + 1] += magnitude_rn(ure, uim);
          decision_product_rn<BPC>(p[j].x, p[j].y, w[j], ure, uim);
          v[4 * j + 2] += ure;
          v[4 * j + 3] += magnitude_rn(ure, uim);
          if (j < ng) e[j] += store_point<BPC, true>(out(j, r, c), zr, zi, w[j], s0 + r < evm_rows);
        }
      }
    }
    block_sum(v, red + 4 * G * BLOCK_WARPS, lane, warp, nw);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float coh1 = v[4 * j] / fmaxf(v[4 * j + 1], 1e-20f);
      const float coh0 = v[4 * j + 2] / fmaxf(v[4 * j + 3], 1e-20f);
      keep[j] = coh1 > coh0;
      if (coh != nullptr && threadIdx.x == 0 && j < ng)
        reinterpret_cast<float2*>(coh)[b0 + j] = make_float2(coh1, coh0);
    }
  }
  bool redo = false;  // untracked, or a gate keeps the identity: those points as they are
#pragma unroll
  for (int j = 0; j < G; ++j) redo |= !keep[j];
  if (redo) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (!keep[j]) e[j] = 0.0f;
    for (int c = lane; c < C; c += 32) {
      float w[G];
#pragma unroll
      for (int j = 0; j < G; ++j) w[j] = sw[j * C + c];
#pragma unroll(G == 1 ? 4 : 1)
      for (int r = 0; r < run; ++r) {
        float2 p[G];
        fetch(r, c, p);
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (!keep[j] && j < ng)
            e[j] += store_point<BPC, true>(out(j, r, c), p[j].x, p[j].y, w[j], s0 + r < evm_rows);
      }
    }
  }
  block_sum(e, red + 8 * G * BLOCK_WARPS, lane, warp, nw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < ng) evm2[b0 + j] = e[j] / (float)(evm_rows * C);
  }
}

template <int BPC>
cudaError_t launch_staged(const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c, const void* hp,
                          int64_t hs_b, int64_t hs_c, const void* slope, int B, int S, int C,
                          int first_carrier, int track, int evm_rows, void* llrs, void* evm2,
                          void* coh, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;  // this instantiation's dynamic shared memory limit
  const int per = stream_bytes(S, C);
  int nw = WARPS;
  while (nw > 1 && (size_t)nw * per > MAX_SMEM) nw /= 2;
  const size_t smem = (size_t)nw * per;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ofdm_track_kernel<BPC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  ofdm_track_kernel<BPC><<<(B + nw - 1) / nw, 32 * nw, smem, st>>>(
      static_cast<const float2*>(z), zs_b, zs_s, zs_c, static_cast<const float*>(hp), hs_b, hs_c,
      static_cast<const float*>(slope), B, S, C, first_carrier, track, evm_rows,
      static_cast<float*>(llrs), static_cast<float*>(evm2), static_cast<float*>(coh));
  return cudaGetLastError();
}

template <int BPC, int G>
cudaError_t launch_block(const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c, const void* hp,
                         int64_t hs_b, int64_t hs_c, const void* slope, int B, int S, int C,
                         int first_carrier, int track, int evm_rows, void* llrs, void* evm2,
                         void* coh, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;  // this instantiation's dynamic shared memory limit
  const size_t smem = weight_bytes(G * C);  // the streams' weights
  if (smem + RED_SLOTS * G * BLOCK_WARPS * 4 > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(ofdm_track_block_kernel<BPC, G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  ofdm_track_block_kernel<BPC, G><<<(B + G - 1) / G, 32 * block_warps(S), smem, st>>>(
      static_cast<const float2*>(z), zs_b, zs_s, zs_c, static_cast<const float*>(hp), hs_b, hs_c,
      static_cast<const float*>(slope), B, S, C, first_carrier, track, evm_rows,
      static_cast<float*>(llrs), static_cast<float*>(evm2), static_cast<float*>(coh));
  return cudaGetLastError();
}

// The staged route, or the block route with 4 streams a block in the
// time-major view (stride 1 between streams) and 1 otherwise.
template <int BPC>
cudaError_t launch(bool block, const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c,
                   const void* hp, int64_t hs_b, int64_t hs_c, const void* slope, int B, int S,
                   int C, int first_carrier, int track, int evm_rows, void* llrs, void* evm2,
                   void* coh, cudaStream_t st) {
  if (!block)
    return launch_staged<BPC>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                              track, evm_rows, llrs, evm2, coh, st);
  if (zs_b == 1)
    return launch_block<BPC, 4>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                                track, evm_rows, llrs, evm2, coh, st);
  return launch_block<BPC, 1>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                              track, evm_rows, llrs, evm2, coh, st);
}

int dispatch(bool block, const void* z, long long zs_b, long long zs_s, long long zs_c,
             const void* hp, long long hs_b, long long hs_c, const void* slope, int B, int S,
             int C, int bpc, int first_carrier, int track, int evm_rows, void* llrs, void* evm2,
             void* coh, void* stream) {
  if (B < 1 || S < 1 || C < 1 || evm_rows < 1 || evm_rows > S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (bpc) {
    case 2:
      return (int)launch<2>(block, z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                            first_carrier, track, evm_rows, llrs, evm2, coh, st);
    case 4:
      return (int)launch<4>(block, z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                            first_carrier, track, evm_rows, llrs, evm2, coh, st);
    case 6:
      return (int)launch<6>(block, z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
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
  return dispatch(false, z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, bpc,
                  first_carrier, track, evm_rows, llrs, evm2, coh, stream);
}

// The block route: the same arguments and outputs, a block of warps a
// stream, any S.
extern "C" int anet_ofdm_track_block(const void* z, long long zs_b, long long zs_s,
                                     long long zs_c, const void* hp, long long hs_b,
                                     long long hs_c, const void* slope, int B, int S, int C,
                                     int bpc, int first_carrier, int track, int evm_rows,
                                     void* llrs, void* evm2, void* coh, void* stream) {
  return dispatch(true, z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, bpc,
                  first_carrier, track, evm_rows, llrs, evm2, coh, stream);
}
