// demod_at_energies_fused: align + demodulate at per-stream dynamic starts,
// every tone's energy, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py demod_at_energies_fused
// (pallas_call at line 1971, body _demod_at_energies_kernel at line 1795,
// with _demod_at_front at 1487 and _demod_at_setup at 1840). For each stream
// b the frame's data section starts at buffer[b, start[b] + pre]; each of its
// n_symbols symbols hits the [sps, 2M] basis and the kernel writes
// I^2 + Q^2 of every tone, float32 [B, n_symbols, M] in symbol order, for
// the soft decisions of the coded receiver. Reads past the buffer's end are
// zero.
//
// What bounds it on the H100: bytes. Each stream's data span is read once
// (2 bytes a bf16 sample) and M float32 energies a symbol are written; at
// the coded path's 4 tones and 32 samples a symbol that is 64 bytes in and
// 16 bytes out a symbol, against 512 multiply-adds.
// An int8 buffer (the quantized stream carry, reference _demod_at_setup
// lines 1885-1893) halves the read; it takes the x127 integer basis, so
// its float32 I/Q sums are exact (common.cuh).
//
// Design: the front of demod_at_fused (demod_at.cu). The TPU kernel's
// 8-row-aligned span DMAs, its start-bound padding and its I-block-then-
// Q-block basis order existed only for the TPU's (8, 128) layout; a thread
// here indexes buffer[b, start + pre + i] directly. One block per (stream,
// tile of 64 symbols), energies_symbols in common.cuh: the tile's samples
// are staged in shared memory by coalesced loads; lane c of each warp holds
// basis column c (cos of tone c in lanes 0..15, sin in 16..31) in
// registers, one shuffle brings Q beside I, and lanes 0..M-1 store the
// symbol's energies. With M = 4 only 8 of a
// warp's 32 lanes do live work; packing several symbols into a warp is left
// for the pass that makes this kernel fast.
#include "common.cuh"

namespace {

constexpr int THREADS = anet::DEMOD_THREADS;

template <typename T, int SPS>
__global__ void __launch_bounds__(THREADS)
demod_at_energies_kernel(const T* __restrict__ buf, int64_t len, const int32_t* __restrict__ start,
                         int pre, int n_symbols, int m, const float* __restrict__ basis,
                         float* __restrict__ energies) {
  __shared__ __align__(16) float stage[anet::SYM_TILE * SPS];
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * anet::SYM_TILE;
  const int64_t base = (int64_t)start[b] + pre + (int64_t)s0 * SPS;
  anet::energies_symbols<T, SPS>(buf + (int64_t)b * len, len, base,
                                 min(anet::SYM_TILE, n_symbols - s0), m, basis, stage,
                                 energies + ((int64_t)b * n_symbols + s0) * m);
}

template <typename T, int SPS>
cudaError_t launch(const void* buf, int B, long long len, const void* start, int pre,
                   int n_symbols, int m, const void* basis, void* energies, cudaStream_t st) {
  dim3 grid(B, (n_symbols + anet::SYM_TILE - 1) / anet::SYM_TILE);
  demod_at_energies_kernel<T, SPS><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(buf), len, static_cast<const int32_t*>(start), pre, n_symbols, m,
      static_cast<const float*>(basis), static_cast<float*>(energies));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sps(int sps, const void* buf, int B, long long len, const void* start,
                         int pre, int n_symbols, int m, const void* basis, void* energies,
                         cudaStream_t st) {
  switch (sps) {
    case 32:
      return launch<T, 32>(buf, B, len, start, pre, n_symbols, m, basis, energies, st);
    case 64:
      return launch<T, 64>(buf, B, len, start, pre, n_symbols, m, basis, energies, st);
    case 128:
      return launch<T, 128>(buf, B, len, start, pre, n_symbols, m, basis, energies, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// buf: [B, len] contiguous; start: [B] int32 preamble starts; basis:
// [sps, 32] float32; energies: [B, n_symbols, m] float32, m <= 16. sps must
// be 32, 64 or 128. Returns cudaGetLastError().
extern "C" int anet_demod_at_energies(const void* buf, int dtype, int B, long long len,
                                      const void* start, int pre, int sps, int n_symbols, int m,
                                      const void* basis, void* energies, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (m < 1 || m > 16) return (int)cudaErrorInvalidValue;
  if (dtype == anet::DTYPE_BF16)
    return (int)dispatch_sps<__nv_bfloat16>(sps, buf, B, len, start, pre, n_symbols, m, basis,
                                            energies, st);
  if (dtype == anet::DTYPE_I8)
    return (int)dispatch_sps<int8_t>(sps, buf, B, len, start, pre, n_symbols, m, basis,
                                     energies, st);
  return (int)dispatch_sps<float>(sps, buf, B, len, start, pre, n_symbols, m, basis, energies, st);
}
