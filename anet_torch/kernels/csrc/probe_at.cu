// probe_at_fused: the frame-lock verify/refine probe, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py probe_at_fused
// (pallas_call at line 1710, body _probe_at_kernel at line 1585). For each
// stream b with probe base st = st0[b]:
//   corr[o] = sum_j buf[st + o + j] * t[j]                  (o < n_lags <= 8)
//   energy  = sum of buf[i]^2 over the st-ALIGNED superset span
//             [st, st + 128 * pw_e), pw_e = ceil((k + n_lags - 1)/128) + 1
//   q[o]    = |corr[o]| * rsqrt(te * max(energy, 1e-4 te))
// Reads past the buffer's end are zero. (demod_probe_fused, the merged
// kernel of the uncoded lock step, sums its energy over the row-aligned
// span instead and goes on to demodulate; this one stops at the quality.)
//
// What bounds it on the H100: bytes, and few of them: each stream reads its
// own 128 * pw_e samples (1,280 at the main path's 1,024-sample preamble)
// and writes n_lags floats, so at 8,192 streams the launch itself is most
// of the time.
//
// Design: one warp per stream, 8 streams a block. The TPU kernel's span
// DMAs, row selects and banded template matrix existed for its 128-lane
// rows; here a lane indexes buf[st + o + j] directly, takes every 32nd
// template tap for all n_lags lags and every 32nd sample of the energy
// span (neighbouring lanes on neighbouring addresses), and the warp
// reduces by shuffles in a fixed order.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MAX_LAGS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
probe_at_kernel(const T* __restrict__ buf, int n_streams, int64_t len,
                const int32_t* __restrict__ st0, const float* __restrict__ tpl, int k, int n_lags,
                int pw_e, float te, float* __restrict__ q_out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= n_streams) return;  // whole warps leave; no block-wide barrier follows
  const T* row = buf + (int64_t)b * len;
  const int64_t st = st0[b];

  float acc[MAX_LAGS + 1];  // n_lags correlations, then the window energy
#pragma unroll
  for (int o = 0; o <= MAX_LAGS; ++o) acc[o] = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const float tv = tpl[j];
#pragma unroll
    for (int o = 0; o < MAX_LAGS; ++o)
      if (o < n_lags) acc[o] = fmaf(anet::load_or_zero(row, st + o + j, len), tv, acc[o]);
  }
  for (int i = lane; i < pw_e * 128; i += 32) {
    const float v = anet::load_or_zero(row, st + i, len);
    acc[MAX_LAGS] = fmaf(v, v, acc[MAX_LAGS]);
  }
#pragma unroll
  for (int o = 0; o <= MAX_LAGS; ++o) {
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], sh);
  }
  const float scale = rsqrtf(te * fmaxf(acc[MAX_LAGS], 1e-4f * te));
#pragma unroll
  for (int o = 0; o < MAX_LAGS; ++o)
    if (o < n_lags && lane == o) q_out[(int64_t)b * n_lags + o] = fabsf(acc[o]) * scale;
}

template <typename T>
cudaError_t launch(const void* buf, int B, long long len, const void* st0, const void* tpl, int k,
                   int n_lags, int pw_e, float te, void* q, cudaStream_t st) {
  probe_at_kernel<T><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      static_cast<const T*>(buf), B, len, static_cast<const int32_t*>(st0),
      static_cast<const float*>(tpl), k, n_lags, pw_e, te, static_cast<float*>(q));
  return cudaGetLastError();
}

}  // namespace

// buf: [B, len] contiguous; st0: [B] int32 probe bases; tpl: [k] float32;
// q: [B, n_lags] float32; n_lags <= 8. Returns cudaGetLastError().
extern "C" int anet_probe_at(const void* buf, int dtype, int B, long long len, const void* st0,
                             const void* tpl, int k, int n_lags, int pw_e, float te, void* q,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_lags < 1 || n_lags > MAX_LAGS) return (int)cudaErrorInvalidValue;
  if (dtype == anet::DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(buf, B, len, st0, tpl, k, n_lags, pw_e, te, q, st);
  return (int)launch<float>(buf, B, len, st0, tpl, k, n_lags, pw_e, te, q, st);
}
