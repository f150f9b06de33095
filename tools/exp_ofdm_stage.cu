// The OFDM equalizer's block route with its first pass's points kept in
// shared memory: an experiment beside anet_torch/kernels/csrc/ofdm_track.cu,
// which it includes whole (tools/exp_ofdm_stage.py builds and times it).
//
// ofdm_track_block_stage_kernel is ofdm_track_block_kernel with one change:
// each warp keeps the points of its first K symbols (K from the room, at
// most its run) in shared memory, [warp][r][c][G] float2. The first pass
// that reads a point (the first fit iteration; the identity pass where
// nothing is tracked) loads it from global memory and stores it there;
// every later pass reads those symbols from shared memory and the rest from
// global memory (L2), as the block route does for all of them. A lane
// writes and reads only its own points, so no barrier is added. The
// arithmetic is the block route's, so it gives the same bits.
#include "../anet_torch/kernels/csrc/ofdm_track.cu"

namespace {

template <int BPC, int G>
__global__ void __launch_bounds__(32 * BLOCK_WARPS, 1)
ofdm_track_block_stage_kernel(const float2* __restrict__ z, int64_t zs_b, int64_t zs_s,
                              int64_t zs_c, const float* __restrict__ hp, int64_t hs_b,
                              int64_t hs_c, const float* __restrict__ slope, int B, int S, int C,
                              int first_carrier, int track, int evm_rows, int K,
                              float* __restrict__ llrs, float* __restrict__ evm2,
                              float* __restrict__ coh) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[RED_SLOTS * G * BLOCK_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b0 = blockIdx.x * G;
  const int ng = B - b0 < G ? B - b0 : G;
  float* sw = reinterpret_cast<float*>(smem);  // [G][C]
  float2* kept = reinterpret_cast<float2*>(smem + weight_bytes(G * C)) + (size_t)warp * K * C * G;
  for (int i = threadIdx.x; i < G * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    sw[i] = j < ng ? hp[(int64_t)(b0 + j) * hs_b + c * hs_c] : 0.0f;
  }
  const int s0 = warp * S / nw, run = (warp + 1) * S / nw - s0;
  const float2* zw = z + (int64_t)b0 * zs_b + (int64_t)s0 * zs_s;
  const bool vec = G == 4 && ng == 4 && zs_b == 1 && zs_s % 2 == 0 && zs_c % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(zw) % 16 == 0;
  __syncthreads();
  const auto load = [&](int r, int c, float2(&p)[G]) {
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
  // first: the pass that stores the kept symbols' points, else one that
  // reads them back
  const auto fetch = [&](int r, int c, float2(&p)[G], bool first) {
    if (r < K) {
      float2* at = kept + ((size_t)r * C + c) * G;
      if (!first) {
#pragma unroll
        for (int j = 0; j < G; ++j) p[j] = at[j];
        return;
      }
      load(r, c, p);
#pragma unroll
      for (int j = 0; j < G; ++j) at[j] = p[j];
      return;
    }
    load(r, c, p);
  };
  const auto out = [&](int j, int r, int c) {
    return llrs + (((int64_t)(b0 + j) * S + s0 + r) * C + c) * BPC;
  };

  float cc[G];
  bool keep[G];
  float e[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    cc[j] = track && j < ng ? slope[b0 + j] : 0.0f;
    keep[j] = false;
    e[j] = 0.0f;
  }
  if (track) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      float v[2 * G];
#pragma unroll
      for (int i = 0; i < 2 * G; ++i) v[i] = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float fm = (float)(c + first_carrier);
        float w[G];
#pragma unroll
        for (int j = 0; j < G; ++j) w[j] = sw[j * C + c];
        float fs = (float)s0;
#pragma unroll(G == 1 ? 4 : 1)
        for (int r = 0; r < run; ++r) {
          fs += 1.0f;
          const float phase = fs * fm;
          float2 p[G];
          fetch(r, c, p, it == 0);
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
    float v[4 * G];
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
        fetch(r, c, p, false);
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
  bool redo = false;
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
        fetch(r, c, p, !track);
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

// K: the symbols a warp keeps, as many as fit beside the weights and the
// static reductions, at most a warp's longest run.
template <int BPC, int G>
cudaError_t launch_stage(const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c, const void* hp,
                         int64_t hs_b, int64_t hs_c, const void* slope, int B, int S, int C,
                         int first_carrier, int track, int evm_rows, void* llrs, void* evm2,
                         void* coh, cudaStream_t st) {
  const int nw = block_warps(S);
  const size_t w_bytes = weight_bytes(G * C);
  const size_t room = MAX_SMEM - w_bytes - RED_SLOTS * G * BLOCK_WARPS * 4;
  const size_t row = (size_t)nw * C * G * 8;  // a symbol kept by every warp
  int K = (int)(room / row);
  const int longest = (S + nw - 1) / nw;
  if (K > longest) K = longest;
  const size_t smem = w_bytes + (size_t)K * row;
  static size_t smem_set = 48 * 1024;  // this instantiation's dynamic shared memory limit
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(ofdm_track_block_stage_kernel<BPC, G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  ofdm_track_block_stage_kernel<BPC, G><<<(B + G - 1) / G, 32 * nw, smem, st>>>(
      static_cast<const float2*>(z), zs_b, zs_s, zs_c, static_cast<const float*>(hp), hs_b, hs_c,
      static_cast<const float*>(slope), B, S, C, first_carrier, track, evm_rows, K,
      static_cast<float*>(llrs), static_cast<float*>(evm2), static_cast<float*>(coh));
  return cudaGetLastError();
}

template <int BPC>
cudaError_t launch_stage_any(const void* z, int64_t zs_b, int64_t zs_s, int64_t zs_c,
                             const void* hp, int64_t hs_b, int64_t hs_c, const void* slope, int B,
                             int S, int C, int first_carrier, int track, int evm_rows, void* llrs,
                             void* evm2, void* coh, cudaStream_t st) {
  if (zs_b == 1)
    return launch_stage<BPC, 4>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                first_carrier, track, evm_rows, llrs, evm2, coh, st);
  return launch_stage<BPC, 1>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C, first_carrier,
                              track, evm_rows, llrs, evm2, coh, st);
}

}  // namespace

// anet_ofdm_track_block's arguments and outputs, on the staging variant.
extern "C" int exp_ofdm_track_block_stage(const void* z, long long zs_b, long long zs_s,
                                          long long zs_c, const void* hp, long long hs_b,
                                          long long hs_c, const void* slope, int B, int S, int C,
                                          int bpc, int first_carrier, int track, int evm_rows,
                                          void* llrs, void* evm2, void* coh, void* stream) {
  if (B < 1 || S < 1 || C < 1 || evm_rows < 1 || evm_rows > S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (bpc) {
    case 2:
      return (int)launch_stage_any<2>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                      first_carrier, track, evm_rows, llrs, evm2, coh, st);
    case 4:
      return (int)launch_stage_any<4>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                      first_carrier, track, evm_rows, llrs, evm2, coh, st);
    case 6:
      return (int)launch_stage_any<6>(z, zs_b, zs_s, zs_c, hp, hs_b, hs_c, slope, B, S, C,
                                      first_carrier, track, evm_rows, llrs, evm2, coh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
