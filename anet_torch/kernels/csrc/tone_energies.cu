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
// the decisions 0.11 GB (0.37 ms); float32 rows double the read (0.84 ms
// with the energies). The filterbank's 2 x 32 x sps flops a symbol (36
// GFLOP at that size) take 0.04 ms on the tensor cores, 0.11 ms as float32
// compute's three products on bf16 rows, 0.22 ms as its six on float32
// rows.
//
// Design: the wrapper picks the route from the compute dtype and the
// geometry, never from the rows' dtype, and names the C entry it calls
// (kernels._filterbank_operands, on kernels.
// _filterbank_tensor_core_geometry). This source takes
// - sps 32, 48, 64, 80 or 128 (whole k-steps of 16 samples) and at most 32
//   tones (8 n-tiles; mfsk8-audible and mfsk32-dense among them): the
//   align+demod filterbank of demod_core.cuh with every start at 0, on the
//   tensor cores. The rows are
//   its PitchedSpan: buf the first row, pitch the row stride, len the row's
//   whole symbols (n_symbols * sps), start a zero vector, pre 0. Each warp
//   walks (row, tile of symbols) items with its own ring of 16-byte
//   cp.async chunks aligned down, so rows at any pitch and 16-byte residue
//   take full-width loads; a tile copies only its live symbols' chunks, and
//   each copy stops at len: no read passes a row's last whole symbol, into
//   the gap after it or past the allocation's end. 16 symbols x sps
//   samples are an mma.sync A tile; the epilogues are demod_core.cuh's
//   store_energies and store_decisions, those of demod_at_energies_fused
//   and demod_at_fused.
//   - bfloat16 compute (the *_mma entries): bf16 rows against the bf16
//     basis in registers (OneTerm, kernels._demod_mma_basis); at 17-32
//     tones the basis in shared memory (SharedTerms), the same products.
//   - float32 compute (the *_mma_f32 entries): the float32 basis as three
//     bf16 terms that sum to it exactly (SplitTerms,
//     kernels._demod_split_basis), b0 in registers, b1 and b2 in shared
//     memory. The rows' dtype picks the A form: bf16 rows are exact in bf16
//     and meet the three terms; float32 rows are staged as float32 in the
//     same ring and split in registers into three bf16 terms, six of the
//     nine products kept. Each product is exact in float32; the largest
//     sums in an accumulator of its own, as the tensor cores truncate what
//     they add below a sum's largest addend. At 17-32 tones b0 too lies in
//     shared memory (SharedTerms), the same products in the same order.
//   At sps 48 and 80 a symbol is 96 or 160 bytes of bf16 (192 or 320 of
//   float32), a tile one m16 tile of 16 symbols, and the padded rows (28,
//   44, 52 or 84 words) keep the 8 symbols of an A fragment in 8 distinct
//   bank groups.
// Any other geometry (custom configs: sps 15, 24, 40, 96, 100, 160 or
// 1,920, or more than 32 tones) takes filterbank_any.cu, the same product
// with the geometry known at run time.
// The TPU kernels' flattened [T, sps] windows and their zero padding to
// 512-symbol tiles are not carried over.
#include "demod_core.cuh"

namespace {

// The tensor-core kernels: demod_core.cuh's walk over the rows, T the
// staged samples and P the product (OneTerm: bf16 compute; SplitTerms:
// float32 compute), with one of its two epilogues.
template <typename T, int SPS, typename P>
__global__ void __launch_bounds__(anet::demod::THREADS)
tone_energies_mma(anet::demod::PitchedSpan sp, int m, const uint32_t* __restrict__ basis,
                  float* __restrict__ energies) {
  const int n_symbols = sp.n_symbols;
  anet::demod::walk_with<T, SPS, P>(sp, basis, [&](int b, int s, const float (&e)[P::NT][2]) {
    anet::demod::store_energies<P::NT>(b, s, e, n_symbols, m, energies);
  });
}

template <typename T, int SPS, typename P>
__global__ void __launch_bounds__(anet::demod::THREADS)
decide_tones_mma(anet::demod::PitchedSpan sp, const uint32_t* __restrict__ basis,
                 int32_t* __restrict__ tone, float* __restrict__ best,
                 float* __restrict__ total) {
  const int n_symbols = sp.n_symbols;
  anet::demod::walk_with<T, SPS, P>(sp, basis, [&](int b, int s, const float (&e)[P::NT][2]) {
    anet::demod::store_decisions<P::NT>(b, s, e, n_symbols, tone, best, total);
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

template <typename T, int SPS, typename P, bool DECIDE>
cudaError_t launch_mma(const MmaArgs& a) {
  static int resident = 0;  // one per kernel instantiation
  const uint32_t* basis = static_cast<const uint32_t*>(a.basis);
  if constexpr (DECIDE)
    return anet::demod::launch<T, SPS, P::SMEM>(
        decide_tones_mma<T, SPS, P>, resident, a.x, a.R, a.pitch, a.len, a.start, 0, a.n_symbols,
        a.st, basis, static_cast<int32_t*>(a.out0), static_cast<float*>(a.out1),
        static_cast<float*>(a.out2));
  else
    return anet::demod::launch<T, SPS, P::SMEM>(
        tone_energies_mma<T, SPS, P>, resident, a.x, a.R, a.pitch, a.len, a.start, 0, a.n_symbols,
        a.st, a.m, basis, static_cast<float*>(a.out0));
}

// The product of a route: SPLIT false, bfloat16 compute (one term); true,
// float32 compute (three terms) on T rows. Up to 4 n-tiles the basis's b0
// stays in registers (OneTerm, SplitTerms); at 8 every term is staged in
// shared memory (SharedTerms), where b0 in registers would spill.
template <typename T, int SPS, int NT, bool SPLIT>
using Product = typename std::conditional<
    (NT > 4), anet::demod::SharedTerms<T, SPS, NT, SPLIT ? 3 : 1>,
    typename std::conditional<SPLIT, anet::demod::SplitTerms<T, SPS, NT>,
                              anet::demod::OneTerm<T, SPS, NT>>::type>::type;

template <typename T, int SPS, bool SPLIT, bool DECIDE>
cudaError_t dispatch_mma_tones(const MmaArgs& a) {
  if (a.m <= 4) return launch_mma<T, SPS, Product<T, SPS, 1, SPLIT>, DECIDE>(a);
  if (a.m <= 8) return launch_mma<T, SPS, Product<T, SPS, 2, SPLIT>, DECIDE>(a);
  if (a.m <= 16) return launch_mma<T, SPS, Product<T, SPS, 4, SPLIT>, DECIDE>(a);
  return launch_mma<T, SPS, Product<T, SPS, 8, SPLIT>, DECIDE>(a);
}

template <typename T, bool SPLIT, bool DECIDE>
int dispatch_mma(const void* x, int R, long long row_stride, const void* start, int n_symbols,
                 int sps, int m, const void* basis, void* out0, void* out1, void* out2,
                 void* stream) {
  const long long row = (long long)n_symbols * sps;
  if (R < 1 || n_symbols < 1 || m < 1 || m > 32 || (R > 1 && row_stride < row))
    return (int)cudaErrorInvalidValue;
  const long long pitch = R > 1 ? row_stride : row;  // one row: its pitch is never used
  const MmaArgs a{x, R, pitch, row, start, n_symbols, m, basis, out0, out1, out2,
                  reinterpret_cast<cudaStream_t>(stream)};
  switch (sps) {
    case 32:
      return (int)dispatch_mma_tones<T, 32, SPLIT, DECIDE>(a);
    case 48:
      return (int)dispatch_mma_tones<T, 48, SPLIT, DECIDE>(a);
    case 64:
      return (int)dispatch_mma_tones<T, 64, SPLIT, DECIDE>(a);
    case 80:
      return (int)dispatch_mma_tones<T, 80, SPLIT, DECIDE>(a);
    case 128:
      return (int)dispatch_mma_tones<T, 128, SPLIT, DECIDE>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// float32 compute on the tensor cores: the rows' dtype picks the A form.
template <bool DECIDE>
int dispatch_split(const void* x, int dtype, int R, long long row_stride, const void* start,
                   int n_symbols, int sps, int m, const void* basis, void* out0, void* out1,
                   void* out2, void* stream) {
  if (dtype == anet::DTYPE_BF16)
    return dispatch_mma<__nv_bfloat16, true, DECIDE>(x, R, row_stride, start, n_symbols, sps, m,
                                                     basis, out0, out1, out2, stream);
  if (dtype == anet::DTYPE_F32)
    return dispatch_mma<float, true, DECIDE>(x, R, row_stride, start, n_symbols, sps, m, basis,
                                             out0, out1, out2, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bfloat16 compute on the tensor cores. x: R rows of >= n_symbols * sps
// bfloat16 samples, `row_stride` elements apart (>= n_symbols * sps when R >
// 1), contiguous within a row, any alignment; start: [R] int32 zeros; sps
// 32, 48, 64, 80 or 128, m <= 32; basis: the B fragments of demod_core.cuh
// (kernels._demod_mma_basis for bfloat16); energies: [R, n_symbols, m]
// float32. Returns cudaGetLastError().
extern "C" int anet_tone_energies_mma(const void* x, int R, long long row_stride,
                                      const void* start, int n_symbols, int sps, int m,
                                      const void* basis, void* energies, void* stream) {
  return dispatch_mma<__nv_bfloat16, false, false>(x, R, row_stride, start, n_symbols, sps, m,
                                                   basis, energies, nullptr, nullptr, stream);
}

// The same rows, zeros and basis; tone: [R, n_symbols] int32; best, total:
// [R, n_symbols] float32. Returns cudaGetLastError().
extern "C" int anet_decide_tones_mma(const void* x, int R, long long row_stride, const void* start,
                                     int n_symbols, int sps, int m, const void* basis, void* tone,
                                     void* best, void* total, void* stream) {
  return dispatch_mma<__nv_bfloat16, false, true>(x, R, row_stride, start, n_symbols, sps, m, basis,
                                                  tone, best, total, stream);
}

// float32 compute on the tensor cores: the rows as the bfloat16 entries
// take them, bfloat16 (dtype 1, exact in bf16) or float32 (dtype 0, split
// into three bf16 terms on load); basis: SplitTerms' three terms of the
// float32 basis (kernels._demod_split_basis); the outputs as above.
// Returns cudaGetLastError().
extern "C" int anet_tone_energies_mma_f32(const void* x, int dtype, int R, long long row_stride,
                                          const void* start, int n_symbols, int sps, int m,
                                          const void* basis, void* energies, void* stream) {
  return dispatch_split<false>(x, dtype, R, row_stride, start, n_symbols, sps, m, basis, energies,
                               nullptr, nullptr, stream);
}

extern "C" int anet_decide_tones_mma_f32(const void* x, int dtype, int R, long long row_stride,
                                         const void* start, int n_symbols, int sps, int m,
                                         const void* basis, void* tone, void* best, void* total,
                                         void* stream) {
  return dispatch_split<true>(x, dtype, R, row_stride, start, n_symbols, sps, m, basis, tone, best,
                              total, stream);
}
