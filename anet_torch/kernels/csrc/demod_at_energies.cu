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
// (2 bytes a bf16 sample, 4 a float32 one) and M float32 energies a symbol
// are written; at the coded path's 4 tones and 32 samples a symbol that is
// 64 bytes (bf16) or 128 bytes (float32, the stream's default carry) in and
// 16 bytes out a symbol, against 512 multiply-adds. An int8 buffer (the
// quantized stream carry, reference _demod_at_setup lines 1885-1893) halves
// the bf16 read and takes the x127 integer basis.
//
// Design: the TPU kernel's 8-row-aligned span DMAs, its start-bound padding
// and its I-block-then-Q-block basis order existed only for the TPU's
// (8, 128) layout. Every buffer runs the tensor-core filterbank of
// demod_core.cuh, whose n-tiles follow the tone count: at M = 4 one m16n8
// product a k-step holds the 4 tones' I and Q of 16 symbols, and no lane
// computes a tone that does not exist. Its epilogue store_energies writes
// tone 4 t + i of n-tile t from lane i of a quad: at M = 4 a warp's store
// is 128 contiguous bytes.
// - bfloat16 and int8 buffers (demod_at_energies_mma): the one-term product
//   with the bf16 or x127 int8 basis (kernels._demod_mma_basis).
// - float32 buffers (demod_at_energies_mma_f32): demod_at.cu's float32 walk,
//   the three-term split SplitTerms (kernels._demod_split_basis) in a ring
//   of F32_RING stages, with this file's epilogue: each energy within
//   kernels.F32_SPLIT_RTOL of itself plus F32_SPLIT_ATOL of its symbol's
//   largest.
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

// float32 buffers: the walk with the three-term split of samples and basis,
// in a ring of F32_RING stages, as demod_at.cu's demod_at_mma_f32.
template <int SPS, int NT>
__global__ void __launch_bounds__(anet::demod::THREADS)
demod_at_energies_mma_f32(anet::demod::Span sp, int m, const uint32_t* __restrict__ basis,
                          float* __restrict__ energies) {
  using P = anet::demod::SplitTerms<float, SPS, NT>;
  const int n_symbols = sp.n_symbols;
  anet::demod::walk_with<float, SPS, P, anet::demod::F32_RING>(
      sp, basis, [&](int b, int s, const float (&e)[NT][2]) {
        anet::demod::store_energies<NT>(b, s, e, n_symbols, m, energies);
      });
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

template <int SPS, int NT>
cudaError_t launch_mma_f32(const Args& a) {
  static int resident = 0;  // one per kernel instantiation
  using P = anet::demod::SplitTerms<float, SPS, NT>;
  return anet::demod::launch<float, SPS, P::SMEM, anet::demod::F32_RING>(
      demod_at_energies_mma_f32<SPS, NT>, resident, a.buf, a.B, a.len, a.len, a.start, a.pre,
      a.n_symbols, a.st, a.m, static_cast<const uint32_t*>(a.basis),
      static_cast<float*>(a.energies));
}

template <typename T, int SPS>
cudaError_t dispatch_tones(const Args& a) {
  if (a.m <= 4) return launch_mma<T, SPS, 1>(a);
  if (a.m <= 8) return launch_mma<T, SPS, 2>(a);
  return launch_mma<T, SPS, 4>(a);
}

template <int SPS>
cudaError_t dispatch_tones_f32(const Args& a) {
  if (a.m <= 4) return launch_mma_f32<SPS, 1>(a);
  if (a.m <= 8) return launch_mma_f32<SPS, 2>(a);
  return launch_mma_f32<SPS, 4>(a);
}

template <int SPS>
cudaError_t dispatch_dtype(int dtype, const Args& a) {
  if (dtype == anet::DTYPE_BF16) return dispatch_tones<__nv_bfloat16, SPS>(a);
  if (dtype == anet::DTYPE_I8) return dispatch_tones<int8_t, SPS>(a);
  if (dtype == anet::DTYPE_F32) return dispatch_tones_f32<SPS>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// buf: [B, len] contiguous, any alignment; start: [B] int32 preamble
// starts; energies: [B, n_symbols, m] float32, m <= 16; sps 32, 64 or 128.
// basis: for bfloat16 and int8 buffers the B fragments of demod_core.cuh
// (kernels._demod_mma_basis, int32 [sps * elem / 32, n_tiles, 2, 32]); for
// float32 buffers SplitTerms' three terms of the float32 basis
// (kernels._demod_split_basis, int32 [3, sps / 16, n_tiles, 2, 32]).
// Returns cudaGetLastError().
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
