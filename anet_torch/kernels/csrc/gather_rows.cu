// gather_rows_fused: per-stream timing-alignment gather, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py gather_rows_fused
// (pallas_call at line 1460, body _gather_rows_kernel at line 1394):
//   out[b, i] = buffer[b, start[b] + i]          (i < size)
// Pure data movement, bit-exact in any dtype: the samples are moved as 16-
// or 32-bit words and never converted. Callers guarantee
// 0 <= start and start + size <= L; positions outside [0, L) read as zero
// (the reference reads its zero padding there).
//
// What bounds it on the H100: bytes. Each output sample is read once and
// written once (size x B x 2 x itemsize: 1.19 GB at B = 8192, size = 36,352
// bf16, 0.36 ms at 3.35 TB/s) plus the 4-byte start of each stream.
//
// Design: the TPU kernel's 128-lane row split, its slack rows, the lane
// roll and the iota select exist because a TPU cannot index the minor axis;
// a CUDA thread can, so each thread copies buffer[b, start[b] + i] for a
// strided set of i. Consecutive threads take consecutive samples, so loads
// and stores coalesce up to the misalignment of start[b]. The loads are
// scalar: a bf16 span at an odd start is not 4-byte aligned, and a wider
// load would need a per-stream alignment case.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;  // samples per thread

template <typename W>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const W* __restrict__ buf, int64_t len, const int32_t* __restrict__ start,
                   int size, W* __restrict__ out) {
  const int b = blockIdx.x;
  const int64_t st = start[b];
  const W* row = buf + (int64_t)b * len;
  W* orow = out + (int64_t)b * size;
  const int i0 = blockIdx.y * (THREADS * ITEMS) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int i = i0 + u * THREADS;
    if (i < size) {
      const int64_t p = st + i;
      orow[i] = (p >= 0 && p < len) ? row[p] : W(0);
    }
  }
}

}  // namespace

// buf: [B, len] contiguous, elements of `itemsize` bytes (2 or 4); start:
// [B] int32; out: [B, size] of the same element type. Returns
// cudaGetLastError().
extern "C" int anet_gather_rows(const void* buf, int itemsize, int B, long long len,
                                const void* start, int size, void* out, void* stream) {
  dim3 grid(B, (size + THREADS * ITEMS - 1) / (THREADS * ITEMS));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (itemsize == 2) {
    gather_rows_kernel<uint16_t><<<grid, THREADS, 0, st>>>(
        static_cast<const uint16_t*>(buf), len, static_cast<const int32_t*>(start), size,
        static_cast<uint16_t*>(out));
  } else if (itemsize == 4) {
    gather_rows_kernel<uint32_t><<<grid, THREADS, 0, st>>>(
        static_cast<const uint32_t*>(buf), len, static_cast<const int32_t*>(start), size,
        static_cast<uint32_t*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
