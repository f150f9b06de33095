// demod_probe_fused: the locked stream's merged probe + demod, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py demod_probe_fused
// (pallas_call at line 2415, body _demod_probe_kernel at line 2092). For
// each stream b with probe base st = st0[b]:
//   corr[o] = sum_j buf[st + o + j] * t[j]                (o < n_lags <= 8)
//   cmax    = max_o |corr[o]|, off = its first argmax (ties: earliest lag)
//   energy  = sum of buf[i]^2 over the row-aligned superset span
//             [128*(st//128), 128*(st//128 + pw_e)),
//             pw_e = ceil((k + n_lags - 1)/128) + 1
//   then the demod triple (tone, best, total) of the frame whose preamble
//   starts at st + off, data at st + off + pre. Reads past the buffer's
//   end are zero.
// The caller normalizes q = cmax * rsqrt(te * max(energy, 1e-4 te)).
// An int8 buffer (the quantized stream carry) comes with the template
// quantized by the wrapper to round(t * 127 / max|t|); the correlation then
// sums in int32 and the wrapper scales cmax back by max|t| / 127. The
// window energy sums squares of the integer samples in float32 (exact
// below 2^24) and the demod takes the x127 integer basis (common.cuh).
//
// What bounds it on the H100: one read of each stream's span, preamble
// window plus data section (~36,600 bf16 samples a stream at the main path:
// ~0.6 GB, ~0.18 ms at B = 8192); the probe's n_lags x k FMAs a stream are
// small beside the filterbank's.
//
// Design: one block per stream. The TPU kernel's row selects, the second
// lag block for residues st % 128 in 124..127 and the one-hot slab shift
// were artefacts of its 128-lane rows; here threads index the buffer
// directly, so the servo window never meets a row boundary. The block's
// threads take strided slices of the template for all n_lags lags and of
// the energy span, reduce in a fixed tree, and thread 0 picks the servo
// offset; then the block demodulates at the refined start with the shared
// demod_symbols (common.cuh).
#include "common.cuh"

namespace {

constexpr int THREADS = anet::DEMOD_THREADS;
constexpr int MAX_LAGS = 8;

template <typename T, int SPS>
__global__ void __launch_bounds__(THREADS)
demod_probe_kernel(const T* __restrict__ buf, int64_t len, const int32_t* __restrict__ st0,
                   const float* __restrict__ tpl, int k, int n_lags, int pw_e, int pre,
                   int n_symbols, const float* __restrict__ basis, float* __restrict__ cmax_out,
                   int32_t* __restrict__ off_out, float* __restrict__ energy_out,
                   int32_t* __restrict__ tone, float* __restrict__ best,
                   float* __restrict__ total) {
  __shared__ __align__(16) float stage[anet::SYM_TILE * SPS];
  __shared__ float red[THREADS / 32][MAX_LAGS + 1];
  __shared__ int ired[THREADS / 32][MAX_LAGS];
  __shared__ int s_off;
  const int b = blockIdx.x;
  const T* row = buf + (int64_t)b * len;
  const int64_t st = st0[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // int8 buffers correlate in int32 against the template's x127 integers:
  // a sum of k products reaches ~3.3e7, past float32's 2^24, so it stays
  // exact in int32 and converts to float32 once, as the reference's int32
  // matmul does (reference lines 2188-2196).
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  float acc[MAX_LAGS + 1];  // n_lags correlations, then the window energy
  int iacc[MAX_LAGS];       // the correlations of an int8 buffer
#pragma unroll
  for (int o = 0; o <= MAX_LAGS; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int o = 0; o < MAX_LAGS; ++o) iacc[o] = 0;
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const float tv = tpl[j];
#pragma unroll
    for (int o = 0; o < MAX_LAGS; ++o) {
      if (o >= n_lags) continue;
      if constexpr (kInt8) {
        const int64_t i = st + o + j;
        const int v = (i >= 0 && i < len) ? (int)row[i] : 0;
        iacc[o] += v * (int)tv;
      } else {
        acc[o] = fmaf(anet::load_or_zero(row, st + o + j, len), tv, acc[o]);
      }
    }
  }
  const int64_t e0 = st / 128 * 128;
  for (int i = threadIdx.x; i < pw_e * 128; i += THREADS) {
    const float v = anet::load_or_zero(row, e0 + i, len);
    acc[MAX_LAGS] = fmaf(v, v, acc[MAX_LAGS]);
  }
#pragma unroll
  for (int o = 0; o <= MAX_LAGS; ++o) {
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) acc[o] += __shfl_down_sync(0xffffffffu, acc[o], sh);
    if (lane == 0) red[warp][o] = acc[o];
  }
  if constexpr (kInt8) {
#pragma unroll
    for (int o = 0; o < MAX_LAGS; ++o) {
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) iacc[o] += __shfl_down_sync(0xffffffffu, iacc[o], sh);
      if (lane == 0) ired[warp][o] = iacc[o];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sums[MAX_LAGS + 1];
#pragma unroll
    for (int o = 0; o <= MAX_LAGS; ++o) {
      sums[o] = 0.0f;
      for (int w = 0; w < THREADS / 32; ++w) sums[o] += red[w][o];
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int o = 0; o < MAX_LAGS; ++o) {
        int c = 0;
        for (int w = 0; w < THREADS / 32; ++w) c += ired[w][o];
        sums[o] = (float)c;  // round to nearest, as the reference's astype
      }
    }
    float cm = -1.0f;
    int off = 0;
#pragma unroll
    for (int o = 0; o < MAX_LAGS; ++o)
      if (o < n_lags && fabsf(sums[o]) > cm) {  // strict: the first lag wins ties
        cm = fabsf(sums[o]);
        off = o;
      }
    cmax_out[b] = cm;
    off_out[b] = off;
    energy_out[b] = sums[MAX_LAGS];
    s_off = off;
  }
  __syncthreads();
  const int64_t o = (int64_t)b * n_symbols;
  anet::demod_symbols<T, SPS>(row, len, st + s_off + pre, 0, n_symbols, basis, stage, tone + o,
                              best + o, total + o);
}

template <typename T, int SPS>
cudaError_t launch(const void* buf, int B, long long len, const void* st0, const void* tpl, int k,
                   int n_lags, int pw_e, int pre, int n_symbols, const void* basis, void* cmax,
                   void* off, void* energy, void* tone, void* best, void* total,
                   cudaStream_t st) {
  demod_probe_kernel<T, SPS><<<B, THREADS, 0, st>>>(
      static_cast<const T*>(buf), len, static_cast<const int32_t*>(st0),
      static_cast<const float*>(tpl), k, n_lags, pw_e, pre, n_symbols,
      static_cast<const float*>(basis), static_cast<float*>(cmax), static_cast<int32_t*>(off),
      static_cast<float*>(energy), static_cast<int32_t*>(tone), static_cast<float*>(best),
      static_cast<float*>(total));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sps(int sps, const void* buf, int B, long long len, const void* st0,
                         const void* tpl, int k, int n_lags, int pw_e, int pre, int n_symbols,
                         const void* basis, void* cmax, void* off, void* energy, void* tone,
                         void* best, void* total, cudaStream_t st) {
  switch (sps) {
    case 32:
      return launch<T, 32>(buf, B, len, st0, tpl, k, n_lags, pw_e, pre, n_symbols, basis, cmax,
                           off, energy, tone, best, total, st);
    case 64:
      return launch<T, 64>(buf, B, len, st0, tpl, k, n_lags, pw_e, pre, n_symbols, basis, cmax,
                           off, energy, tone, best, total, st);
    case 128:
      return launch<T, 128>(buf, B, len, st0, tpl, k, n_lags, pw_e, pre, n_symbols, basis, cmax,
                            off, energy, tone, best, total, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// buf: [B, len] contiguous; st0: [B] int32 probe bases; tpl: [k] float32;
// basis: [sps, 32] float32; cmax, energy: [B] float32; off: [B] int32;
// tone: [B, n_symbols] int32; best, total: [B, n_symbols] float32.
// n_lags <= 8; sps must be 32, 64 or 128. Returns cudaGetLastError().
extern "C" int anet_demod_probe(const void* buf, int dtype, int B, long long len,
                                const void* st0, const void* tpl, int k, int n_lags, int pw_e,
                                int pre, int sps, int n_symbols, const void* basis, void* cmax,
                                void* off, void* energy, void* tone, void* best, void* total,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16)
    return (int)dispatch_sps<__nv_bfloat16>(sps, buf, B, len, st0, tpl, k, n_lags, pw_e, pre,
                                            n_symbols, basis, cmax, off, energy, tone, best,
                                            total, st);
  if (dtype == anet::DTYPE_I8)
    return (int)dispatch_sps<int8_t>(sps, buf, B, len, st0, tpl, k, n_lags, pw_e, pre,
                                     n_symbols, basis, cmax, off, energy, tone, best,
                                     total, st);
  return (int)dispatch_sps<float>(sps, buf, B, len, st0, tpl, k, n_lags, pw_e, pre, n_symbols,
                                  basis, cmax, off, energy, tone, best, total, st);
}
