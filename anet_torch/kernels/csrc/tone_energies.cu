// tone_energies_fused / decide_tones_fused: the batch-major filterbank,
// Hopper.
//
// Replaces the TPU kernels anet/kernels/__init__.py tone_energies_fused
// (pallas_call at line 117, body _energy_kernel at line 76) and
// decide_tones_fused (pallas_call at line 200, body _decide_kernel at line
// 152). Input: R batch-major rows of symbol-aligned samples, row r at
// x + r * row_stride (a view into whole frames, so the preamble is skipped
// in place), S symbols of sps samples each. Per symbol the [sps, 2M] basis
// gives I/Q in float32, then
//   energies:  I^2 + Q^2 of every tone, float32 [R, S, M];
//   decisions: (argmax tone, first index on ties; best; total), [R, S] each.
//
// What bounds it on the H100: bytes. At the aligned batch-major path
// (16,384 mfsk16-fast frames of 536 data symbols, sps 64, bf16) the read is
// 1.12 GB; the energies write 0.56 GB more (0.50 ms in all at 3.35 TB/s),
// the decisions 0.11 GB (0.37 ms). The filterbank's 2 x 32 x sps flops a
// symbol (36 GFLOP at that size) take 0.04 ms on the tensor cores.
//
// Design: three routes, which the wrapper picks from the compute dtype and
// the geometry, never from the rows' dtype (bfloat16 rows under float32
// compute are widened on load and meet the float32 basis), and names to
// the C entry it calls:
// - bfloat16 compute, sps 32, 64 or 128, at most 16 tones (the *_mma
//   entries): the align+demod filterbank of demod_core.cuh with every start
//   at 0. The rows are its PitchedSpan: buf the first row, pitch the row
//   stride, len the row's whole symbols (n_symbols * sps), start a zero
//   vector, pre 0. Each warp walks (row, tile of symbols) items with its
//   own ring of 16-byte cp.async chunks aligned down, so rows at any pitch
//   and 16-byte residue take full-width loads; a tile copies only its live
//   symbols' chunks, and each copy stops at len: no read passes a row's
//   last whole symbol, into the gap after it or past the allocation's end.
//   16 symbols x sps samples are an mma.sync A tile against the basis held
//   in registers as B fragments (kernels._demod_mma_basis); the epilogues
//   are demod_core.cuh's store_energies and store_decisions, those of
//   demod_at_energies_fused and demod_at_fused.
// - float32 compute, same geometry: one block per (row, tile of 64
//   symbols) on the CUDA cores. The tile's samples are staged in shared
//   memory as float32; lane c of each warp holds basis column c (cos of
//   tone c in lanes 0..15, sin in 16..31, [sps, 32] float32) in registers,
//   each warp takes one symbol at a time, and one shuffle brings Q beside
//   I (energies_symbols, demod_symbols and tone_reduce16 in common.cuh).
// - any other geometry (sps 48 of mfsk8-audible, the 32 tones of
//   mfsk32-dense), either compute dtype: a plain kernel, one warp per
//   symbol, its samples staged in shared memory, lane c summing the I and
//   Q of tones c, c + 32, ... over the samples in order from the [sps, 2M]
//   basis (cos columns, then sin).
// The TPU kernels' flattened [T, sps] windows and their zero padding to
// 512-symbol tiles are not carried over.
#include "demod_core.cuh"

namespace {

constexpr int THREADS = anet::DEMOD_THREADS;

// bfloat16 compute on the tensor cores: demod_core.cuh's walk over the
// rows with one of its two epilogues.
template <int SPS, int NT>
__global__ void __launch_bounds__(anet::demod::THREADS)
tone_energies_mma(anet::demod::PitchedSpan sp, int m, const uint32_t* __restrict__ basis,
                  float* __restrict__ energies) {
  const int n_symbols = sp.n_symbols;
  anet::demod::walk<__nv_bfloat16, SPS, NT>(sp, basis, [&](int b, int s, const float (&e)[NT][2]) {
    anet::demod::store_energies<NT>(b, s, e, n_symbols, m, energies);
  });
}

template <int SPS, int NT>
__global__ void __launch_bounds__(anet::demod::THREADS)
decide_tones_mma(anet::demod::PitchedSpan sp, const uint32_t* __restrict__ basis,
                 int32_t* __restrict__ tone, float* __restrict__ best,
                 float* __restrict__ total) {
  const int n_symbols = sp.n_symbols;
  anet::demod::walk<__nv_bfloat16, SPS, NT>(sp, basis, [&](int b, int s, const float (&e)[NT][2]) {
    anet::demod::store_decisions<NT>(b, s, e, n_symbols, tone, best, total);
  });
}

struct MmaArgs {
  const void* x;
  int R;
  long long pitch, len;  // the row stride; a row's whole symbols, the bound of its reads
  const void* start;
  int n_symbols, m;
  const void* basis;
  void *out0, *out1, *out2;
  cudaStream_t st;
};

template <int SPS, int NT, bool DECIDE>
cudaError_t launch_mma(const MmaArgs& a) {
  static int resident = 0;  // one per kernel instantiation
  const uint32_t* basis = static_cast<const uint32_t*>(a.basis);
  if constexpr (DECIDE)
    return anet::demod::launch<__nv_bfloat16, SPS>(
        decide_tones_mma<SPS, NT>, resident, a.x, a.R, a.pitch, a.len, a.start, 0, a.n_symbols,
        a.st, basis, static_cast<int32_t*>(a.out0), static_cast<float*>(a.out1),
        static_cast<float*>(a.out2));
  else
    return anet::demod::launch<__nv_bfloat16, SPS>(
        tone_energies_mma<SPS, NT>, resident, a.x, a.R, a.pitch, a.len, a.start, 0, a.n_symbols,
        a.st, a.m, basis, static_cast<float*>(a.out0));
}

template <int SPS, bool DECIDE>
cudaError_t dispatch_mma_tones(const MmaArgs& a) {
  if (a.m <= 4) return launch_mma<SPS, 1, DECIDE>(a);
  if (a.m <= 8) return launch_mma<SPS, 2, DECIDE>(a);
  return launch_mma<SPS, 4, DECIDE>(a);
}

template <bool DECIDE>
int dispatch_mma(const void* x, int R, long long row_stride, const void* start, int n_symbols,
                 int sps, int m, const void* basis, void* out0, void* out1, void* out2,
                 void* stream) {
  const long long row = (long long)n_symbols * sps;
  if (R < 1 || n_symbols < 1 || m < 1 || m > 16 || (R > 1 && row_stride < row))
    return (int)cudaErrorInvalidValue;
  const long long pitch = R > 1 ? row_stride : row;  // one row: its pitch is never used
  const MmaArgs a{x, R, pitch, row, start, n_symbols, m, basis, out0, out1, out2,
                  reinterpret_cast<cudaStream_t>(stream)};
  switch (sps) {
    case 32:
      return (int)dispatch_mma_tones<32, DECIDE>(a);
    case 64:
      return (int)dispatch_mma_tones<64, DECIDE>(a);
    case 128:
      return (int)dispatch_mma_tones<128, DECIDE>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// float32 compute: the CUDA-core kernels.

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

// float32 compute, and any geometry. x: R rows of >= n_symbols * sps
// samples, `row_stride` elements apart (contiguous within a row), float32
// or bfloat16 (widened on load); basis: [sps, 32] float32 for sps 32, 64 or
// 128 and m <= 16, else [sps, 2m] (either compute dtype's entries);
// energies: [R, n_symbols, m] float32. Returns cudaGetLastError().
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

// bfloat16 compute on the tensor cores. x: R rows of >= n_symbols * sps
// bfloat16 samples, `row_stride` elements apart (>= n_symbols * sps when R >
// 1), contiguous within a row, any alignment; start: [R] int32 zeros; sps
// 32, 64 or 128, m <= 16; basis: the B fragments of demod_core.cuh
// (kernels._demod_mma_basis for bfloat16); energies: [R, n_symbols, m]
// float32. Returns cudaGetLastError().
extern "C" int anet_tone_energies_mma(const void* x, int R, long long row_stride,
                                      const void* start, int n_symbols, int sps, int m,
                                      const void* basis, void* energies, void* stream) {
  return dispatch_mma<false>(x, R, row_stride, start, n_symbols, sps, m, basis, energies, nullptr,
                             nullptr, stream);
}

// The same rows, zeros and basis; tone: [R, n_symbols] int32; best, total:
// [R, n_symbols] float32. Returns cudaGetLastError().
extern "C" int anet_decide_tones_mma(const void* x, int R, long long row_stride, const void* start,
                                     int n_symbols, int sps, int m, const void* basis, void* tone,
                                     void* best, void* total, void* stream) {
  return dispatch_mma<true>(x, R, row_stride, start, n_symbols, sps, m, basis, tone, best, total,
                            stream);
}
