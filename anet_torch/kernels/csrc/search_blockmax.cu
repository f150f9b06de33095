// sync_search_blockmax: block maxima of the acquisition search's quality,
// Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py sync_search_blockmax
// (pallas_call at line 1364, body _search_blockmax_kernel at line 1203):
// the recorded two-phase search of the JAX package's stream module, whose
// first phase writes one value per 128-lag block and leaves the fold to the
// caller. For every 128-lag block c < out_len / 128 of each stream's
// segment seg[b, :]:
//   out[b, c] = max_{l in block c} |corr[l]| * scale[c]
//             = max_{l in block c} q[l]
// with corr, the blockwise window energy and q exactly as sync_search.cu
// computes them; the scale is one value per 128-lag block, and rounding a
// product by a positive scale keeps the order, so the maximum of |corr|
// times the scale is the maximum of q. out_len is a multiple of 128, so
// the output holds whole blocks only: the reference's -2.0 fill of its
// padded output lanes has nothing to fill here.
//
// What bounds it on the H100: as sync_search_fused, the correlation's
// 2 x k x out_len flops per stream (1.22 TFLOP at B = 8192, k = 2048,
// out_len = 36,352: 1.2 ms at the bf16 tensor-core peak); the segment read
// is 0.63 GB and the output 9 MB. This simple form runs the product on the
// CUDA cores in float32, far from that bound, as the search kernel does.
//
// Design: the tile of sync_search.cu (one block per stream and tile of
// 2048 lags, the tile's segment span and the template staged in shared
// memory as float32, skewed so a warp's loads hit distinct banks, 8 lags a
// thread sliding a 16-register window along the template, block energies
// from the staged span), with its own epilogue: the 8 lags of a thread lie
// in one 128-lag block, so the 16 threads of a half-warp hold a whole
// block; a max over their |corr| by shuffles within the half-warp, times
// the block's scale, and its first thread writes the block's value.
// Nothing is folded across tiles. The loop is a copy of the search's, not
// a shared header: sharing it cost the search kernel 4-5% of its time.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LPT = 8;                // lags per thread
constexpr int TILE = THREADS * LPT;   // lags per block
constexpr int EBLK = 128;             // samples per energy block

__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 3); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
blockmax_kernel(const T* __restrict__ seg, int64_t row_stride, int seg_len,
                const float* __restrict__ tpl, int k, int kp, int n_blocks, float te, int kb,
                int n_load, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* s_x = sm;                          // skew(n_load) floats
  float* s_t = sm + skew(n_load) + 8;       // kp floats
  float* s_blk = s_t + kp;                  // TILE / EBLK + kb floats

  const int b = blockIdx.x;
  const int64_t lag0 = (int64_t)blockIdx.y * TILE;
  const T* row = seg + (int64_t)b * row_stride;

  for (int i = threadIdx.x; i < n_load; i += THREADS)
    s_x[skew(i)] = anet::load_or_zero(row, lag0 + i, seg_len);
  for (int i = threadIdx.x; i < kp; i += THREADS) s_t[i] = i < k ? tpl[i] : 0.0f;
  __syncthreads();

  // energies of the 128-sample blocks this tile's windows touch
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_blk = TILE / EBLK + kb;
  for (int blk = warp; blk < n_blk; blk += THREADS / 32) {
    float e = 0.0f;
    for (int i = lane; i < EBLK; i += 32) {
      const float v = s_x[skew(blk * EBLK + i)];
      e = fmaf(v, v, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(0xffffffffu, e, off);
    if (lane == 0) s_blk[blk] = e;
  }

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
  __syncthreads();  // s_blk complete

  // the 8 lags share one energy block (base is a multiple of 8)
  const int jb = base / EBLK;
  float win = 0.0f;
  for (int q = 0; q < kb; ++q) win += s_blk[jb + q];
  const float scale = rsqrtf(te * fmaxf(win, 1e-4f * te));
  float m = 0.0f;
#pragma unroll
  for (int r = 0; r < LPT; ++r) m = fmaxf(m, fabsf(acc[r]));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off, 16));
  const int64_t blk = (lag0 + base) / EBLK;
  if ((threadIdx.x & 15) == 0 && blk < n_blocks) out[(int64_t)b * n_blocks + blk] = m * scale;
}

}  // namespace

// seg: [B, seg_len] rows `row_stride` elements apart (last dim contiguous);
// tpl: [k] float32; out: [B, out_len / 128] float32, out_len a multiple of
// 128. Returns cudaGetLastError().
extern "C" int anet_search_blockmax(const void* seg, int dtype, int B, long long row_stride,
                                    int seg_len, const void* tpl, int k, int out_len, float te,
                                    void* out, void* stream) {
  if (out_len < EBLK || out_len % EBLK) return (int)cudaErrorInvalidValue;
  const int n_blocks = out_len / EBLK;
  const int kp = (k + LPT - 1) / LPT * LPT;
  const int kb = (k + EBLK - 1) / EBLK + 1;
  const int n_corr = TILE + kp + LPT;
  const int n_energy = (TILE / EBLK + kb) * EBLK;
  const int n_load = n_corr > n_energy ? n_corr : n_energy;
  const size_t smem = (size_t)(skew(n_load) + 8 + kp + TILE / EBLK + kb) * sizeof(float);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == anet::DTYPE_BF16) {
    err = cudaFuncSetAttribute(blockmax_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  } else {
    err = cudaFuncSetAttribute(blockmax_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (out_len + TILE - 1) / TILE);
  if (dtype == anet::DTYPE_BF16) {
    blockmax_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(seg), row_stride, seg_len,
        static_cast<const float*>(tpl), k, kp, n_blocks, te, kb, n_load,
        static_cast<float*>(out));
  } else {
    blockmax_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(seg), row_stride, seg_len, static_cast<const float*>(tpl), k,
        kp, n_blocks, te, kb, n_load, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
