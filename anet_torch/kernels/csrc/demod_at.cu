// demod_at_fused: align + demodulate at per-stream dynamic starts, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py demod_at_fused
// (pallas_call at line 2063, body _demod_at_kernel at line 1727, with
// _demod_at_front at 1487 and _demod_at_setup at 1840). For each stream b
// the frame's data section starts at buffer[b, start[b] + pre]; each of its
// n_symbols symbols hits the [sps, 2M] basis, giving (tone, best, total) in
// symbol order. Reads past the buffer's end are zero.
//
// What bounds it on the H100: the read of each stream's data span
// (34,304 bf16 samples a stream at the main path: 0.56 GB, 0.17 ms at
// B = 8192). The filterbank's 2 x 32 x sps flops a symbol (18 GFLOP at
// B = 8192) stay under that bound even on the CUDA cores in float32.
// An int8 buffer (the quantized stream carry, reference _demod_at_setup
// lines 1885-1893) halves the read; it takes the x127 integer basis, so
// its float32 I/Q sums are exact (common.cuh).
//
// Design: the TPU kernel's 8-row-aligned span DMAs, sub-row selects and
// one-hot lane-shift matmuls existed only for the TPU's (8, 128) layout; a
// thread here indexes buffer[b, start + pre + i] directly. One block per
// (stream, tile of 64 symbols): the tile's samples are staged in shared
// memory by coalesced loads; lane c of each warp holds basis column c in
// registers, and a warp reduces one symbol's 16 tone energies with
// shuffles (demod_symbols in common.cuh).
#include "common.cuh"

namespace {

constexpr int THREADS = anet::DEMOD_THREADS;

template <typename T, int SPS>
__global__ void __launch_bounds__(THREADS)
demod_at_kernel(const T* __restrict__ buf, int64_t len, const int32_t* __restrict__ start,
                int pre, int n_symbols, const float* __restrict__ basis,
                int32_t* __restrict__ tone, float* __restrict__ best, float* __restrict__ total) {
  __shared__ __align__(16) float stage[anet::SYM_TILE * SPS];
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * anet::SYM_TILE;
  const int s1 = min(s0 + anet::SYM_TILE, n_symbols);
  const int64_t d0 = (int64_t)start[b] + pre;
  const int64_t o = (int64_t)b * n_symbols;
  anet::demod_symbols<T, SPS>(buf + (int64_t)b * len, len, d0, s0, s1, basis, stage, tone + o,
                              best + o, total + o);
}

template <typename T, int SPS>
cudaError_t launch(const void* buf, int B, long long len, const void* start, int pre,
                   int n_symbols, const void* basis, void* tone, void* best, void* total,
                   cudaStream_t st) {
  dim3 grid(B, (n_symbols + anet::SYM_TILE - 1) / anet::SYM_TILE);
  demod_at_kernel<T, SPS><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(buf), len, static_cast<const int32_t*>(start), pre, n_symbols,
      static_cast<const float*>(basis), static_cast<int32_t*>(tone), static_cast<float*>(best),
      static_cast<float*>(total));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sps(int sps, const void* buf, int B, long long len, const void* start,
                         int pre, int n_symbols, const void* basis, void* tone, void* best,
                         void* total, cudaStream_t st) {
  switch (sps) {
    case 32:
      return launch<T, 32>(buf, B, len, start, pre, n_symbols, basis, tone, best, total, st);
    case 64:
      return launch<T, 64>(buf, B, len, start, pre, n_symbols, basis, tone, best, total, st);
    case 128:
      return launch<T, 128>(buf, B, len, start, pre, n_symbols, basis, tone, best, total, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// buf: [B, len] contiguous; start: [B] int32 preamble starts; basis:
// [sps, 32] float32; tone: [B, n_symbols] int32; best, total: [B,
// n_symbols] float32. sps must be 32, 64 or 128. Returns cudaGetLastError().
extern "C" int anet_demod_at(const void* buf, int dtype, int B, long long len, const void* start,
                             int pre, int sps, int n_symbols, const void* basis, void* tone,
                             void* best, void* total, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16)
    return (int)dispatch_sps<__nv_bfloat16>(sps, buf, B, len, start, pre, n_symbols, basis, tone,
                                            best, total, st);
  if (dtype == anet::DTYPE_I8)
    return (int)dispatch_sps<int8_t>(sps, buf, B, len, start, pre, n_symbols, basis, tone,
                                     best, total, st);
  return (int)dispatch_sps<float>(sps, buf, B, len, start, pre, n_symbols, basis, tone, best,
                                  total, st);
}
