// correlate_fused: valid-mode correlation with every lag written out, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py correlate_fused
// (pallas_call at line 945, body _corr_kernel at line 850). For every lag
// l < out_len of each stream's segment seg[b, :]:
//   out[b, l] = sum_j seg[b, l + j] * t[j]                   (j < k)
// in float32, whatever the input dtype; samples past the end of seg read as
// zero (the reference zero-pads the segment to whole cells). The
// multi-candidate variable-length stream step masks and re-reads this array
// (quality-order extraction), so unlike sync_search_fused the lags cannot be
// folded in the kernel.
//
// What bounds it on the H100: the product's 2 x k x out_len flops per
// stream (0.79 TFLOP at B = 8192, k = 2048, out_len = 23,552: 0.80 ms at the
// bf16 tensor-core peak); the segment read (0.42 GB) and the float32 output
// (0.77 GB) are 0.36 ms. This simple form runs the product on the CUDA cores
// in float32 (67 TFLOP/s, so >= 12 ms), far from the bound by design: a
// first kernel that is right. The block-Toeplitz product as bf16 mma is the
// way down, as for the search.
//
// Design: the search kernel's, without the energy and the fold. The TPU
// kernel's supercell, its two aliased input blocks and its banded template
// matrix feed a matrix unit and are not carried over. One block per (stream,
// lag tile of 2048): the tile's segment span and the template are staged in
// shared memory as float32; each thread owns 8 consecutive lags and slides a
// 16-register window of samples along the template, so every shared load
// feeds 8 FMAs; the span is stored skewed (index i at i + i/8) so the 32
// threads of a warp, 8 samples apart, hit 32 distinct banks. The tile's sums
// go back through shared memory so the stores to out[b, lag0 ...] coalesce.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LPT = 8;                // lags per thread
constexpr int TILE = THREADS * LPT;   // lags per block

__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 3); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
correlate_tile_kernel(const T* __restrict__ seg, int64_t row_stride, int seg_len,
                      const float* __restrict__ tpl, int k, int kp, int out_len, int n_load,
                      float* __restrict__ out) {
  extern __shared__ float sm[];
  float* s_x = sm;                          // skew(n_load) floats
  float* s_t = sm + skew(n_load) + 8;       // kp floats

  const int b = blockIdx.x;
  const int64_t lag0 = (int64_t)blockIdx.y * TILE;
  const T* row = seg + (int64_t)b * row_stride;

  for (int i = threadIdx.x; i < n_load; i += THREADS)
    s_x[skew(i)] = anet::load_or_zero(row, lag0 + i, seg_len);
  for (int i = threadIdx.x; i < kp; i += THREADS) s_t[i] = i < k ? tpl[i] : 0.0f;
  __syncthreads();

  // correlation at lags base .. base + 7 of the tile
  const int base = threadIdx.x * LPT;
  float acc[LPT];
  float w[2 * LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    acc[r] = 0.0f;
    w[r] = s_x[skew(base + r)];
  }
  for (int j0 = 0; j0 < kp; j0 += LPT) {
#pragma unroll
    for (int r = 0; r < LPT; ++r) w[LPT + r] = s_x[skew(base + j0 + LPT + r)];
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const float tv = s_t[j0 + u];
#pragma unroll
      for (int r = 0; r < LPT; ++r) acc[r] = fmaf(w[u + r], tv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < LPT; ++r) w[r] = w[LPT + r];
  }
  __syncthreads();  // every thread is done reading the span

  // the span's first TILE (unskewed) floats now hold the tile's sums
#pragma unroll
  for (int r = 0; r < LPT; ++r) s_x[base + r] = acc[r];
  __syncthreads();
  float* orow = out + (int64_t)b * out_len;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const int64_t lag = lag0 + i;
    if (lag < out_len) orow[lag] = s_x[i];
  }
}

}  // namespace

// seg: [B, seg_len] rows `row_stride` elements apart (last dim contiguous);
// tpl: [k] float32; out: [B, out_len] float32 contiguous. Returns
// cudaGetLastError().
extern "C" int anet_correlate(const void* seg, int dtype, int B, long long row_stride,
                              int seg_len, const void* tpl, int k, int out_len, void* out,
                              void* stream) {
  const int n_tiles = (out_len + TILE - 1) / TILE;
  const int kp = (k + LPT - 1) / LPT * LPT;
  const int n_load = TILE + kp + LPT;
  const size_t smem = (size_t)(skew(n_load) + 8 + kp) * sizeof(float);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == anet::DTYPE_BF16) {
    err = cudaFuncSetAttribute(correlate_tile_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  } else {
    err = cudaFuncSetAttribute(correlate_tile_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, n_tiles);
  if (dtype == anet::DTYPE_BF16) {
    correlate_tile_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(seg), row_stride, seg_len,
        static_cast<const float*>(tpl), k, kp, out_len, n_load, static_cast<float*>(out));
  } else {
    correlate_tile_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(seg), row_stride, seg_len, static_cast<const float*>(tpl), k,
        kp, out_len, n_load, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
