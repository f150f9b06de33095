// tone_energies_fused / decide_tones_fused: the batch-major filterbank,
// Hopper.
//
// Replaces the TPU kernels anet/kernels/__init__.py tone_energies_fused
// (pallas_call at line 117, body _energy_kernel at line 76) and
// decide_tones_fused (pallas_call at line 200, body _decide_kernel at line
// 152). Input: R batch-major rows of symbol-aligned samples, row r at
// x + r * row_stride (float32 or bfloat16; a view into whole frames, so the
// preamble is skipped in place), S symbols of sps samples each. Per symbol
// the [sps, 2M] basis gives I/Q in float32, then
//   anet_tone_energies: I^2 + Q^2 of every tone, float32 [R, S, M];
//   anet_decide_tones:  (argmax tone, first index on ties; best; total),
//                       [R, S] each.
//
// What bounds it on the H100: bytes. At the aligned batch-major path
// (16,384 mfsk16-fast frames of 536 data symbols, sps 64, bf16) the read is
// 1.12 GB; the energies write 0.56 GB more (0.50 ms in all at 3.35 TB/s),
// the decisions 0.11 GB (0.37 ms). The filterbank's 2 x 32 x sps flops a
// symbol (36 GFLOP at that size) stay under the bytes even on the CUDA
// cores in float32.
//
// Design: one block per (row, tile of 64 symbols). The tile's samples are
// staged in shared memory by coalesced loads; lane c of each warp holds
// basis column c (cos of tone c in lanes 0..15, sin in 16..31) in
// registers, each warp takes one symbol at a time, and one shuffle brings Q
// beside I (energies_symbols in common.cuh). The decisions reduce the 16
// tone energies with shuffles (demod_symbols and tone_reduce16): the
// align+demod kernels' fronts with a start of 0. The TPU kernels' flattened
// [T, sps] windows and their zero padding to 512-symbol tiles are not
// carried over. Any other geometry (sps not 32, 64 or 128, or more than 16
// tones: mfsk8-audible, mfsk32-dense) takes a plain kernel instead: one
// warp per symbol, its samples staged in shared memory, lane c summing the
// I and Q of tones c, c + 32, ... over the samples in order from the
// [sps, 2M] basis (cos columns, then sin).
#include "common.cuh"

namespace {

constexpr int THREADS = anet::DEMOD_THREADS;

template <typename T, int SPS>
__global__ void __launch_bounds__(THREADS)
tone_energies_kernel(const T* __restrict__ x, int64_t row_stride, int n_symbols, int m,
                     const float* __restrict__ basis, float* __restrict__ energies) {
  __shared__ __align__(16) float stage[anet::SYM_TILE * SPS];
  const int r = blockIdx.x;
  const int s0 = blockIdx.y * anet::SYM_TILE;
  anet::energies_symbols<T, SPS>(x + (int64_t)r * row_stride, (int64_t)n_symbols * SPS,
                                 (int64_t)s0 * SPS, min(anet::SYM_TILE, n_symbols - s0), m, basis,
                                 stage, energies + ((int64_t)r * n_symbols + s0) * m);
}

template <typename T, int SPS>
__global__ void __launch_bounds__(THREADS)
decide_tones_kernel(const T* __restrict__ x, int64_t row_stride, int n_symbols,
                    const float* __restrict__ basis, int32_t* __restrict__ tone,
                    float* __restrict__ best, float* __restrict__ total) {
  __shared__ __align__(16) float stage[anet::SYM_TILE * SPS];
  const int r = blockIdx.x;
  const int s0 = blockIdx.y * anet::SYM_TILE;
  const int s1 = min(s0 + anet::SYM_TILE, n_symbols);
  const int64_t o = (int64_t)r * n_symbols;
  anet::demod_symbols<T, SPS>(x + (int64_t)r * row_stride, (int64_t)n_symbols * SPS, 0, s0, s1,
                              basis, stage, tone + o, best + o, total + o);
}

constexpr int ANY_WARPS = THREADS / 32;  // symbols a block of the plain kernel
constexpr int ANY_MAX_SPS = 48 * 1024 / (ANY_WARPS * 4);

// Tone energies (DECIDE false) or the decisions of one symbol a warp, any
// sps and m; basis [sps, 2m] float32.
template <typename T, bool DECIDE>
__global__ void __launch_bounds__(THREADS)
any_geometry_kernel(const T* __restrict__ x, int64_t row_stride, int n_symbols, int sps, int m,
                    const float* __restrict__ basis, float* __restrict__ energies,
                    int32_t* __restrict__ tone, float* __restrict__ best,
                    float* __restrict__ total) {
  extern __shared__ float stage_any[];  // ANY_WARPS * sps floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x;
  const int s = blockIdx.y * ANY_WARPS + warp;
  if (s >= n_symbols) return;  // the whole warp: it only syncs within itself
  float* w = stage_any + warp * sps;
  const T* src = x + (int64_t)r * row_stride + (int64_t)s * sps;
  for (int j = lane; j < sps; j += 32) w[j] = anet::to_f32(src[j]);
  __syncwarp();
  const int64_t o = (int64_t)r * n_symbols + s;
  float bv = -1.0f, tot = 0.0f;
  int bi = 0;
  for (int c = lane; c < m; c += 32) {
    float i = 0.0f, q = 0.0f;
    for (int j = 0; j < sps; ++j) {
      i = fmaf(w[j], basis[j * 2 * m + c], i);
      q = fmaf(w[j], basis[j * 2 * m + m + c], q);
    }
    const float e = anet::tone_energy(i, q);
    if constexpr (DECIDE) {
      if (e > bv) {  // a lane's tones ascend: strict > keeps the first
        bv = e;
        bi = c;
      }
      tot += e;
    } else {
      energies[o * m + c] = e;
    }
  }
  if constexpr (DECIDE) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      tot += __shfl_down_sync(0xffffffffu, tot, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      tone[o] = bi;
      best[o] = bv;
      total[o] = tot;
    }
  }
}

template <typename T>
cudaError_t launch_any(const void* x, int R, long long row_stride, int n_symbols, int sps, int m,
                       bool decide, const void* basis, void* out0, void* out1, void* out2,
                       cudaStream_t st) {
  if (sps > ANY_MAX_SPS) return cudaErrorInvalidValue;
  dim3 grid(R, (n_symbols + ANY_WARPS - 1) / ANY_WARPS);
  const size_t smem = (size_t)ANY_WARPS * sps * sizeof(float);
  const T* xs = static_cast<const T*>(x);
  const float* bs = static_cast<const float*>(basis);
  if (decide) {
    any_geometry_kernel<T, true><<<grid, THREADS, smem, st>>>(
        xs, row_stride, n_symbols, sps, m, bs, nullptr, static_cast<int32_t*>(out0),
        static_cast<float*>(out1), static_cast<float*>(out2));
  } else {
    any_geometry_kernel<T, false><<<grid, THREADS, smem, st>>>(
        xs, row_stride, n_symbols, sps, m, bs, static_cast<float*>(out0), nullptr, nullptr,
        nullptr);
  }
  return cudaGetLastError();
}

// out0 is the energies, or out0..out2 tone/best/total when m < 0 (the decisions).
template <typename T, int SPS>
cudaError_t launch(const void* x, int R, long long row_stride, int n_symbols, int m,
                   const void* basis, void* out0, void* out1, void* out2, cudaStream_t st) {
  dim3 grid(R, (n_symbols + anet::SYM_TILE - 1) / anet::SYM_TILE);
  if (m > 0) {
    tone_energies_kernel<T, SPS><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), row_stride, n_symbols, m, static_cast<const float*>(basis),
        static_cast<float*>(out0));
  } else {
    decide_tones_kernel<T, SPS><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), row_stride, n_symbols, static_cast<const float*>(basis),
        static_cast<int32_t*>(out0), static_cast<float*>(out1), static_cast<float*>(out2));
  }
  return cudaGetLastError();
}

// The fast kernels for sps 32, 64 or 128 and at most 16 tones (basis [sps,
// 32]), the plain one otherwise (basis [sps, 2m]).
template <typename T>
cudaError_t dispatch_geometry(int sps, const void* x, int R, long long row_stride, int n_symbols,
                              int m, bool decide, const void* basis, void* out0, void* out1,
                              void* out2, cudaStream_t st) {
  const int mf = decide ? -1 : m;
  if (m <= 16) {
    switch (sps) {
      case 32:
        return launch<T, 32>(x, R, row_stride, n_symbols, mf, basis, out0, out1, out2, st);
      case 64:
        return launch<T, 64>(x, R, row_stride, n_symbols, mf, basis, out0, out1, out2, st);
      case 128:
        return launch<T, 128>(x, R, row_stride, n_symbols, mf, basis, out0, out1, out2, st);
      default:
        break;
    }
  }
  return launch_any<T>(x, R, row_stride, n_symbols, sps, m, decide, basis, out0, out1, out2, st);
}

int dispatch(int dtype, int sps, const void* x, int R, long long row_stride, int n_symbols,
             int m, bool decide, const void* basis, void* out0, void* out1, void* out2,
             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1 || n_symbols < 1 || m < 1 || sps < 1) return (int)cudaErrorInvalidValue;
  if (dtype == anet::DTYPE_BF16)
    return (int)dispatch_geometry<__nv_bfloat16>(sps, x, R, row_stride, n_symbols, m, decide,
                                                 basis, out0, out1, out2, st);
  if (dtype == anet::DTYPE_F32)
    return (int)dispatch_geometry<float>(sps, x, R, row_stride, n_symbols, m, decide, basis,
                                         out0, out1, out2, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: R rows of >= n_symbols * sps samples, `row_stride` elements apart
// (contiguous within a row), float32 or bfloat16; basis: [sps, 32] float32
// for sps 32, 64 or 128 and m <= 16, else [sps, 2m]; energies: [R,
// n_symbols, m] float32. Returns cudaGetLastError().
extern "C" int anet_tone_energies(const void* x, int dtype, int R, long long row_stride,
                                  int n_symbols, int sps, int m, const void* basis,
                                  void* energies, void* stream) {
  return dispatch(dtype, sps, x, R, row_stride, n_symbols, m, false, basis, energies, nullptr,
                  nullptr, stream);
}

// The same rows and basis; tone: [R, n_symbols] int32; best, total: [R,
// n_symbols] float32. Returns cudaGetLastError().
extern "C" int anet_decide_tones(const void* x, int dtype, int R, long long row_stride,
                                 int n_symbols, int sps, int m, const void* basis, void* tone,
                                 void* best, void* total, void* stream) {
  return dispatch(dtype, sps, x, R, row_stride, n_symbols, m, true, basis, tone, best, total,
                  stream);
}
