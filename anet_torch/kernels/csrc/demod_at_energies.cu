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
// 16 bytes out a symbol, against 512 multiply-adds. An int8 buffer (the
// quantized stream carry, reference _demod_at_setup lines 1885-1893) halves
// the read and takes the x127 integer basis.
//
// Design: the TPU kernel's 8-row-aligned span DMAs, its start-bound padding
// and its I-block-then-Q-block basis order existed only for the TPU's
// (8, 128) layout. bfloat16 and int8 buffers run the tensor-core filterbank
// of demod_core.cuh, whose n-tiles follow the tone count: at M = 4 one
// m16n8 product a k-step holds the 4 tones' I and Q of 16 symbols, and no
// lane computes a tone that does not exist. Its epilogue store_energies
// writes tone 4 t + i of n-tile t from lane i of a quad: at M = 4 a warp's
// store is 128 contiguous bytes. float32 buffers keep the CUDA-core body
// of common.cuh (energies_symbols).
#include "demod_core.cuh"

namespace {

template <typename T, int SPS, int NT>
__global__ void __launch_bounds__(anet::demod::THREADS)
demod_at_energies_mma(anet::demod::Span sp, int m, const uint32_t* __restrict__ basis,
                      float* __restrict__ energies) {
  const int n_symbols = sp.n_symbols;
  anet::demod::walk<T, SPS, NT>(sp, basis, [&](int b, int s, const float (&e)[NT][2]) {
    anet::demod::store_energies<NT>(b, s, e, n_symbols, m, energies);
  });
}

// float32 buffers: one block per (stream, tile of 64 symbols) on the CUDA
// cores (energies_symbols in common.cuh).
template <int SPS>
__global__ void __launch_bounds__(anet::DEMOD_THREADS)
demod_at_energies_f32(const float* __restrict__ buf, int64_t len,
                      const int32_t* __restrict__ start, int pre, int n_symbols, int m,
                      const float* __restrict__ basis, float* __restrict__ energies) {
  __shared__ __align__(16) float stage[anet::SYM_TILE * SPS];
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * anet::SYM_TILE;
  const int64_t base = (int64_t)start[b] + pre + (int64_t)s0 * SPS;
  anet::energies_symbols<float, SPS>(buf + (int64_t)b * len, len, base,
                                     min(anet::SYM_TILE, n_symbols - s0), m, basis, stage,
                                     energies + ((int64_t)b * n_symbols + s0) * m);
}

struct Args {
  const void* buf;
  int B;
  long long len;
  const void* start;
  int pre, n_symbols, m;
  const void* basis;
  void* energies;
  cudaStream_t st;
};

template <typename T, int SPS, int NT>
cudaError_t launch_mma(const Args& a) {
  static int resident = 0;
  return anet::demod::launch<T, SPS>(
      demod_at_energies_mma<T, SPS, NT>, resident, a.buf, a.B, a.len, a.len, a.start, a.pre,
      a.n_symbols, a.st, a.m, static_cast<const uint32_t*>(a.basis),
      static_cast<float*>(a.energies));
}

template <int SPS>
cudaError_t launch_f32(const Args& a) {
  dim3 grid(a.B, (a.n_symbols + anet::SYM_TILE - 1) / anet::SYM_TILE);
  demod_at_energies_f32<SPS><<<grid, anet::DEMOD_THREADS, 0, a.st>>>(
      static_cast<const float*>(a.buf), a.len, static_cast<const int32_t*>(a.start), a.pre,
      a.n_symbols, a.m, static_cast<const float*>(a.basis), static_cast<float*>(a.energies));
  return cudaGetLastError();
}

template <typename T, int SPS>
cudaError_t dispatch_tones(const Args& a) {
  if (a.m <= 4) return launch_mma<T, SPS, 1>(a);
  if (a.m <= 8) return launch_mma<T, SPS, 2>(a);
  return launch_mma<T, SPS, 4>(a);
}

template <int SPS>
cudaError_t dispatch_dtype(int dtype, const Args& a) {
  if (dtype == anet::DTYPE_BF16) return dispatch_tones<__nv_bfloat16, SPS>(a);
  if (dtype == anet::DTYPE_I8) return dispatch_tones<int8_t, SPS>(a);
  return launch_f32<SPS>(a);
}

}  // namespace

// buf: [B, len] contiguous, any alignment; start: [B] int32 preamble
// starts; energies: [B, n_symbols, m] float32, m <= 16; sps 32, 64 or 128.
// basis: for bfloat16 and int8 buffers the B fragments of demod_core.cuh
// (kernels._demod_mma_basis); for float32 buffers [sps, 32] float32 (cos of
// the tones in columns 0.., sin in 16..). Returns cudaGetLastError().
extern "C" int anet_demod_at_energies(const void* buf, int dtype, int B, long long len,
                                      const void* start, int pre, int sps, int n_symbols, int m,
                                      const void* basis, void* energies, void* stream) {
  if (m < 1 || m > 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  const Args a{buf, B, len, start, pre, n_symbols, m, basis, energies,
               reinterpret_cast<cudaStream_t>(stream)};
  switch (sps) {
    case 32:
      return (int)dispatch_dtype<32>(dtype, a);
    case 64:
      return (int)dispatch_dtype<64>(dtype, a);
    case 128:
      return (int)dispatch_dtype<128>(dtype, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
