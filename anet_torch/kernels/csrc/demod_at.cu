// demod_at_fused: align + demodulate at per-stream dynamic starts, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py demod_at_fused
// (pallas_call at line 2063, body _demod_at_kernel at line 1727, with
// _demod_at_front at 1487 and _demod_at_setup at 1840). For each stream b
// the frame's data section starts at buffer[b, start[b] + pre]; each of its
// n_symbols symbols hits the [sps, 2M] basis, giving (tone, best, total) in
// symbol order. Reads past the buffer's end are zero.
//
// What bounds it on the H100: bytes. Each stream's data span is read once
// (34,304 bf16 samples a stream at the main path: 0.56 GB, 0.17 ms at
// B = 8192) and 12 bytes a symbol are written. The filterbank's 2 x 32 x
// sps flops a symbol (18 GFLOP at B = 8192) would take 0.27 ms in float32
// on the CUDA cores, more than the byte bound; on the tensor cores they
// take 0.02 ms. An int8 buffer (the quantized stream carry, reference
// _demod_at_setup lines 1885-1893) halves the read and takes the x127
// integer basis.
//
// float32 buffers (the stream's default carry) double the read: 0.35 ms at
// B = 8192, 536 symbols of 64 samples. Their filterbank runs as six bf16
// products (below), 0.11 ms at the bf16 tensor-core peak.
//
// Design: the TPU kernel's 8-row-aligned span DMAs, sub-row selects and
// one-hot lane-shift matmuls existed only for the TPU's (8, 128) layout.
// Every buffer runs the tensor-core filterbank of demod_core.cuh (a warp's
// ring of cp.async span reads, 16 symbols x sps samples a mma.sync A tile,
// the basis in registers as B fragments) with its decision epilogue,
// store_decisions: the argmax (first index on ties), best and sum over a
// quad's tones, each warp store 16 consecutive symbols.
// - bfloat16 and int8 buffers (demod_at_mma): the one-term product with
//   the bf16 or x127 int8 basis (kernels._demod_mma_basis).
// - float32 buffers (demod_at_mma_f32): the three-term split, SplitTerms
//   (kernels._demod_split_basis): the float32 basis as three bf16 terms, b0
//   in registers and b1, b2 in shared memory; the samples staged as
//   float32 and split in registers into three bf16 terms; six of the nine
//   products, a0 b0 in an accumulator of its own. The I/Q are float32 sums
//   to about 2^-24 (kernels.F32_SPLIT_RTOL, F32_SPLIT_ATOL). A ring of 2
//   stages a warp (demod_core.cuh's F32_RING, shared with
//   demod_at_energies.cu's float32 kernel): shared memory a block 22,656
//   bytes at sps 32, 43,136 at 64, 84,096 at 128 (16 tones).
#include "demod_core.cuh"

namespace {

template <typename T, int SPS, int NT>
__global__ void __launch_bounds__(anet::demod::THREADS)
demod_at_mma(anet::demod::Span sp, const uint32_t* __restrict__ basis, int32_t* __restrict__ tone,
             float* __restrict__ best, float* __restrict__ total) {
  const int n_symbols = sp.n_symbols;
  anet::demod::walk<T, SPS, NT>(sp, basis, [&](int b, int s, const float (&e)[NT][2]) {
    anet::demod::store_decisions<NT>(b, s, e, n_symbols, tone, best, total);
  });
}

// float32 buffers: the walk with the three-term split of samples and basis,
// in a ring of demod_core.cuh's F32_RING stages.
template <int SPS, int NT>
__global__ void __launch_bounds__(anet::demod::THREADS)
demod_at_mma_f32(anet::demod::Span sp, const uint32_t* __restrict__ basis,
                 int32_t* __restrict__ tone, float* __restrict__ best, float* __restrict__ total) {
  using P = anet::demod::SplitTerms<float, SPS, NT>;
  const int n_symbols = sp.n_symbols;
  anet::demod::walk_with<float, SPS, P, anet::demod::F32_RING>(
      sp, basis, [&](int b, int s, const float (&e)[NT][2]) {
        anet::demod::store_decisions<NT>(b, s, e, n_symbols, tone, best, total);
      });
}

struct Args {
  const void* buf;
  int B;
  long long len;
  const void* start;
  int pre, n_symbols;
  const void* basis;
  void *tone, *best, *total;
  cudaStream_t st;
};

template <typename T, int SPS, int NT>
cudaError_t launch_mma(const Args& a) {
  static int resident = 0;
  return anet::demod::launch<T, SPS>(
      demod_at_mma<T, SPS, NT>, resident, a.buf, a.B, a.len, a.len, a.start, a.pre,
      a.n_symbols, a.st, static_cast<const uint32_t*>(a.basis), static_cast<int32_t*>(a.tone),
      static_cast<float*>(a.best), static_cast<float*>(a.total));
}

template <int SPS, int NT>
cudaError_t launch_mma_f32(const Args& a) {
  static int resident = 0;  // one per kernel instantiation
  return anet::demod::launch<float, SPS, anet::demod::SplitTerms<float, SPS, NT>::SMEM,
                             anet::demod::F32_RING>(
      demod_at_mma_f32<SPS, NT>, resident, a.buf, a.B, a.len, a.len, a.start, a.pre, a.n_symbols,
      a.st, static_cast<const uint32_t*>(a.basis), static_cast<int32_t*>(a.tone),
      static_cast<float*>(a.best), static_cast<float*>(a.total));
}

template <typename T, int SPS>
cudaError_t dispatch_tones(int m, const Args& a) {
  if (m <= 4) return launch_mma<T, SPS, 1>(a);
  if (m <= 8) return launch_mma<T, SPS, 2>(a);
  return launch_mma<T, SPS, 4>(a);
}

template <int SPS>
cudaError_t dispatch_tones_f32(int m, const Args& a) {
  if (m <= 4) return launch_mma_f32<SPS, 1>(a);
  if (m <= 8) return launch_mma_f32<SPS, 2>(a);
  return launch_mma_f32<SPS, 4>(a);
}

template <int SPS>
cudaError_t dispatch_dtype(int dtype, int m, const Args& a) {
  if (dtype == anet::DTYPE_BF16) return dispatch_tones<__nv_bfloat16, SPS>(m, a);
  if (dtype == anet::DTYPE_I8) return dispatch_tones<int8_t, SPS>(m, a);
  if (dtype == anet::DTYPE_F32) return dispatch_tones_f32<SPS>(m, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// buf: [B, len] contiguous, any alignment; start: [B] int32 preamble
// starts; tone: [B, n_symbols] int32; best, total: [B, n_symbols] float32;
// m <= 16 tones, sps 32, 64 or 128. basis: for bfloat16 and int8 buffers
// the B fragments of demod_core.cuh (kernels._demod_mma_basis, int32
// [sps * elem / 32, n_tiles, 2, 32]); for float32 buffers SplitTerms'
// three terms of the float32 basis (kernels._demod_split_basis, int32 [3,
// sps / 16, n_tiles, 2, 32]). Returns cudaGetLastError().
extern "C" int anet_demod_at(const void* buf, int dtype, int B, long long len, const void* start,
                             int pre, int sps, int n_symbols, int m, const void* basis, void* tone,
                             void* best, void* total, void* stream) {
  if (m < 1 || m > 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  const Args a{buf, B, len, start, pre, n_symbols, basis, tone, best, total,
               reinterpret_cast<cudaStream_t>(stream)};
  switch (sps) {
    case 32:
      return (int)dispatch_dtype<32>(dtype, m, a);
    case 64:
      return (int)dispatch_dtype<64>(dtype, m, a);
    case 128:
      return (int)dispatch_dtype<128>(dtype, m, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
