// decide_tones_tm: time-major per-symbol decisions with no frame parse,
// float32 data on the CUDA cores.
//
// Replaces the TPU kernel anet/kernels/__init__.py decide_tones_tm
// (pallas_call at line 304, body _decide_tm_kernel at line 236). Input: a
// time-major data section x[T, B], symbol-aligned at row 0. Per stream and
// symbol s < T / sps: the [sps, 2M] filterbank in float32, I^2+Q^2, argmax
// (first index on ties), best and total, written as [S, B]. It is the
// aligned receiver's path for a window that is not exactly one frame long,
// where the full-fusion kernel's pack, CRC and quality tail
// (decide_frame_tm) does not apply.
//
// bfloat16 data takes the tensor-core kernel of decide_frame_tm.cu
// (frame_tm_mma with its TONES epilogue, anet_decide_tones_tm_mma): the
// same walk over time-major rows, each symbol's decisions stored in place
// of the packed word. float32 data stays here: the reference's float32
// route uses a float32 basis, and a bf16 hi + lo split of the samples would
// lose 2^-16 of weak tones' I/Q.
//
// What bounds it on the H100: the one read of the float32 rows (544 symbols
// of 64 samples at the oversized window of the smoke run: 2.28 GB at B =
// 16384, 0.68 ms at 3.35 TB/s) plus 12 bytes a symbol written. The
// filterbank's 2 x 32 x sps flops a symbol on the CUDA cores (67 TFLOP/s
// float32) take ~0.55 ms at that size, close behind.
//
// Design: decide_frame_tm's float32 front. One thread per stream, so
// consecutive threads read consecutive streams of a time-major row and
// every load and store coalesces; the symbol axis is split across
// blockIdx.y. The basis sits in shared memory and is read as float4
// broadcasts. The TPU kernel's lane tiles and sublane reductions are not
// carried over.
#include "common.cuh"

namespace {

constexpr int NCOL = 32;    // basis columns: cos/sin of 16 (padded) tones
constexpr int THREADS = 128;
constexpr int SYMS_PER_BLOCK = 8;

__global__ void __launch_bounds__(THREADS)
decide_tones_tm_kernel(const float* __restrict__ x, int B, int sps, int n_symbols,
                       const float* __restrict__ basis, int32_t* __restrict__ tone_out,
                       float* __restrict__ best_out, float* __restrict__ total_out) {
  extern __shared__ float4 sbasis4[];  // [sps][NCOL / 4]
  for (int i = threadIdx.x; i < sps * NCOL / 4; i += blockDim.x)
    sbasis4[i] = reinterpret_cast<const float4*>(basis)[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int s0 = blockIdx.y * SYMS_PER_BLOCK;
  const int s1 = min(s0 + SYMS_PER_BLOCK, n_symbols);

  for (int s = s0; s < s1; ++s) {
    float acc[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[c] = 0.0f;
    const float* xs = x + (int64_t)s * sps * B + b;
    for (int j = 0; j < sps; ++j) {
      const float v = xs[(int64_t)j * B];
      const float4* bj = sbasis4 + j * (NCOL / 4);
#pragma unroll
      for (int c4 = 0; c4 < NCOL / 4; ++c4) {
        const float4 w = bj[c4];
        acc[4 * c4 + 0] = fmaf(v, w.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(v, w.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(v, w.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(v, w.w, acc[4 * c4 + 3]);
      }
    }
    float best = -1.0f, total = 0.0f;
    int tone = 0;
#pragma unroll
    for (int c = 0; c < NCOL / 2; ++c) {
      const float e = anet::tone_energy(acc[c], acc[c + NCOL / 2]);
      if (e > best) {  // strict: the first index wins ties
        best = e;
        tone = c;
      }
      total += e;
    }
    const int64_t o = (int64_t)s * B + b;
    tone_out[o] = tone;
    best_out[o] = best;
    total_out[o] = total;
  }
}

}  // namespace

// float32 x: [>= n_symbols * sps, B] time-major, contiguous; basis: [sps, 32]
// float32; tone: [n_symbols, B] int32; best, total: [n_symbols, B] float32.
// Returns cudaGetLastError().
extern "C" int anet_decide_tones_tm(const void* x, int B, int sps, int n_symbols, const void* basis,
                                    void* tone, void* best, void* total, void* stream) {
  dim3 grid((B + THREADS - 1) / THREADS, (n_symbols + SYMS_PER_BLOCK - 1) / SYMS_PER_BLOCK);
  const size_t smem = (size_t)sps * NCOL * sizeof(float);
  decide_tones_tm_kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), B, sps, n_symbols, static_cast<const float*>(basis),
      static_cast<int32_t*>(tone), static_cast<float*>(best), static_cast<float*>(total));
  return (int)cudaGetLastError();
}
