// decide_frame_tm: the aligned receiver's full-fusion kernel for Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py decide_frame_tm
// (pallas_call at line 586, body _decide_frame_tm_kernel at line 335).
// Input: time-major whole frames x[T, B] (float32, bfloat16 or int8), the data
// section starting at row `row0` (the preamble offset, skipped in place: no
// copy of the data section is made). Per stream and symbol: the [sps, 2M]
// filterbank in float32, I^2+Q^2, argmax (first index on ties), best and
// total; Gray decode; 8 symbols packed per int32 word, MSB-first; header
// and payload CRC-32 as float32 bit counts against the P table (exact below
// 2^24; parity is taken by the caller); quality sums conf/best/total.
//
// What bounds it on the H100: the one read of the data rows (34,304 x B
// bf16 at the main path, 1.12 GB at B = 16384: 0.34 ms at 3.35 TB/s). The
// filterbank is 2 x 34,304 x 32 flops per stream, which on the CUDA cores in
// float32 (67 TFLOP/s) is ~0.54 ms at B = 16384, so this simple form is
// bound by its FMAs, not by memory; tensor cores (mma.sync on bf16) are the
// way past that, left for a later change. The int8 instantiation (the
// quantized-ingest path, reference lines 378-395 and 570-578) halves the
// read (0.56 GB at B = 16384: 0.17 ms) and leaves the FMAs as they are.
//
// Design: one thread per stream, so consecutive threads read consecutive
// streams of a time-major row and every load coalesces. The symbol axis is
// split across blockIdx.y (tiles_per_block words each) for occupancy; each
// block adds its CRC counts and quality sums into the outputs with
// atomicAdd (the counts are integers, so their sums are exact in any order;
// the quality sums differ from the reference only in float rounding order).
// With int8 samples the basis is the reference's x127 integer table held
// as floats, so every I/Q sum is exact (common.cuh) and the energies equal
// the reference's int32-then-float32 ones bit for bit.
// The basis sits in shared memory and is read as float4 broadcasts; the P
// table rows are read from global memory at warp-uniform addresses.
#include "common.cuh"

namespace {

constexpr int SB = 8;       // symbols per packed word (TM_SYMBOL_TILE)
constexpr int NCOL = 32;    // basis columns: cos/sin of 16 (padded) tones
constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
decide_frame_tm_kernel(const T* __restrict__ x, int B, int row0, int sps, int n_symbols,
                       int n_tiles, int tiles_per_block, int bps,
                       const float* __restrict__ basis, const float* __restrict__ ptab,
                       int hdr_bits, int pay_lo, int pay_hi, int32_t* __restrict__ words,
                       float* __restrict__ crc, float* __restrict__ qual) {
  extern __shared__ float4 sbasis4[];  // [sps][NCOL / 4]
  for (int i = threadIdx.x; i < sps * NCOL / 4; i += blockDim.x)
    sbasis4[i] = reinterpret_cast<const float4*>(basis)[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_tiles);

  float cnt[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) cnt[c] = 0.0f;
  float conf = 0.0f, bsum = 0.0f, tsum = 0.0f;

  for (int tile = tile0; tile < tile1; ++tile) {
    uint32_t word = 0;
    for (int s8 = 0; s8 < SB; ++s8) {
      const int s = tile * SB + s8;
      int data = 0;
      if (s < n_symbols) {
        float acc[NCOL];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[c] = 0.0f;
        const T* xs = x + (int64_t)(row0 + (int64_t)s * sps) * B + b;
        for (int j = 0; j < sps; ++j) {
          const float v = anet::to_f32(xs[(int64_t)j * B]);
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
        conf += best / fmaxf(total, 1e-20f);
        bsum += best;
        tsum += total;
        data = tone;  // Gray -> binary
        for (int sh = 1; sh < bps; sh <<= 1) data ^= data >> sh;
      }
      word |= (uint32_t)data << ((SB - 1 - s8) * bps);
      // CRC bit counts: message bit r = s * bps + k (MSB-first in a symbol)
      for (int k = 0; k < bps; ++k) {
        const int r = s * bps + k;
        const float bit = (float)((data >> (bps - 1 - k)) & 1);
        if (r < hdr_bits) {
          const float4* p = reinterpret_cast<const float4*>(ptab + (int64_t)r * 64);
#pragma unroll
          for (int c4 = 0; c4 < 8; ++c4) {
            const float4 w = __ldg(p + c4);
            cnt[4 * c4 + 0] = fmaf(bit, w.x, cnt[4 * c4 + 0]);
            cnt[4 * c4 + 1] = fmaf(bit, w.y, cnt[4 * c4 + 1]);
            cnt[4 * c4 + 2] = fmaf(bit, w.z, cnt[4 * c4 + 2]);
            cnt[4 * c4 + 3] = fmaf(bit, w.w, cnt[4 * c4 + 3]);
          }
        }
        if (r >= pay_lo && r < pay_hi) {
          const float4* p = reinterpret_cast<const float4*>(ptab + (int64_t)r * 64 + 32);
#pragma unroll
          for (int c4 = 0; c4 < 8; ++c4) {
            const float4 w = __ldg(p + c4);
            cnt[32 + 4 * c4 + 0] = fmaf(bit, w.x, cnt[32 + 4 * c4 + 0]);
            cnt[32 + 4 * c4 + 1] = fmaf(bit, w.y, cnt[32 + 4 * c4 + 1]);
            cnt[32 + 4 * c4 + 2] = fmaf(bit, w.z, cnt[32 + 4 * c4 + 2]);
            cnt[32 + 4 * c4 + 3] = fmaf(bit, w.w, cnt[32 + 4 * c4 + 3]);
          }
        }
      }
    }
    words[(int64_t)tile * B + b] = (int32_t)word;
  }
#pragma unroll
  for (int c = 0; c < 64; ++c)
    if (cnt[c] != 0.0f) atomicAdd(crc + (int64_t)c * B + b, cnt[c]);
  atomicAdd(qual + b, conf);
  atomicAdd(qual + (int64_t)B + b, bsum);
  atomicAdd(qual + 2 * (int64_t)B + b, tsum);
}

}  // namespace

// x: [T, B] time-major; basis: [sps, 32] float32; ptab: [n_tiles*8*bps, 64]
// float32 in message-bit row order; words: [n_tiles, B] int32; crc: [64, B]
// and qual: [8, B] float32, zeroed by the caller. Returns cudaGetLastError().
extern "C" int anet_decide_frame_tm(const void* x, int dtype, int B, int row0, int sps,
                                    int n_symbols, int n_tiles, int bps, const void* basis,
                                    const void* ptab, int hdr_bits, int pay_lo, int pay_hi,
                                    void* words, void* crc, void* qual, void* stream) {
  const int tiles_per_block = 4;
  dim3 grid((B + THREADS - 1) / THREADS, (n_tiles + tiles_per_block - 1) / tiles_per_block);
  const size_t smem = (size_t)sps * NCOL * sizeof(float);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) {
    decide_frame_tm_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), B, row0, sps, n_symbols, n_tiles, tiles_per_block,
        bps, static_cast<const float*>(basis), static_cast<const float*>(ptab), hdr_bits, pay_lo,
        pay_hi, static_cast<int32_t*>(words), static_cast<float*>(crc), static_cast<float*>(qual));
  } else if (dtype == anet::DTYPE_I8) {
    decide_frame_tm_kernel<int8_t><<<grid, THREADS, smem, st>>>(
        static_cast<const int8_t*>(x), B, row0, sps, n_symbols, n_tiles, tiles_per_block, bps,
        static_cast<const float*>(basis), static_cast<const float*>(ptab), hdr_bits, pay_lo,
        pay_hi, static_cast<int32_t*>(words), static_cast<float*>(crc), static_cast<float*>(qual));
  } else {
    decide_frame_tm_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), B, row0, sps, n_symbols, n_tiles, tiles_per_block, bps,
        static_cast<const float*>(basis), static_cast<const float*>(ptab), hdr_bits, pay_lo,
        pay_hi, static_cast<int32_t*>(words), static_cast<float*>(crc), static_cast<float*>(qual));
  }
  return (int)cudaGetLastError();
}
