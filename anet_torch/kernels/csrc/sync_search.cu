// sync_search_fused: the streaming receiver's acquisition search for Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py sync_search_fused
// (pallas_call at line 1165, body _search_kernel at line 967). For every
// lag l < out_len of each stream's segment seg[b, :]:
//   corr[l] = sum_j seg[l + j] * t[j]                       (j < k)
//   win[l]  = energy of the 128-sample blocks l//128 .. l//128 + kb - 1 of
//             seg (blocks relative to seg's start, zero past its end;
//             kb = ceil(k/128) + 1, a superset of the window)
//   q[l]    = |corr[l]| * rsqrt(te * max(win[l], 1e-4 te))
// and returns max_l q[l] with its first index (ties keep the earliest lag,
// as jnp.argmax does). Neither corr nor q ever reaches device memory.
//
// What bounds it on the H100: the correlation's 2 x k x out_len flops per
// stream (1.22 TFLOP at B = 8192, k = 2048, out_len = 36,352: 1.2 ms at the
// bf16 tensor-core peak); the segment read is only 0.63 GB (0.19 ms). This
// simple form runs the product on the CUDA cores in float32 (67 TFLOP/s,
// so >= 18 ms), far from the bound by design: a first kernel that is right.
// Tensor cores (the block-Toeplitz product as bf16 mma) are the way down.
//
// Design: one block per (stream, lag tile of 2048). The block stages the
// tile's segment span and the template in shared memory as float32. Each
// thread owns 8 consecutive lags and slides a 16-register window of samples
// along the template, so every shared load feeds 8 FMAs; the span is stored
// skewed (index i at i + i/8) so the 32 threads of a warp, 8 samples apart,
// hit 32 distinct banks. Block energies come from the staged span. Each
// block writes one (max, first argmax) pair; a second small kernel folds
// the tiles in lag order with a strict >, which keeps the first index.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LPT = 8;                // lags per thread
constexpr int TILE = THREADS * LPT;   // lags per block
constexpr int EBLK = 128;             // samples per energy block

__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 3); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
search_tile_kernel(const T* __restrict__ seg, int64_t row_stride, int seg_len,
                   const float* __restrict__ tpl, int k, int kp, int out_len, float te, int kb,
                   int n_load, float* __restrict__ part_q, int32_t* __restrict__ part_i) {
  extern __shared__ float sm[];
  float* s_x = sm;                          // skew(n_load) floats
  float* s_t = sm + skew(n_load) + 8;       // kp floats
  float* s_blk = s_t + kp;                  // TILE / EBLK + kb floats
  __shared__ float red_q[THREADS / 32];
  __shared__ int red_i[THREADS / 32];

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int64_t lag0 = (int64_t)tile * TILE;
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
  float bq = -1.0f;
  int bi = 0x7fffffff;
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    const int64_t lag = lag0 + base + r;
    const float q = fabsf(acc[r]) * scale;
    if (lag < out_len && q > bq) {
      bq = q;
      bi = (int)lag;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oq = __shfl_down_sync(0xffffffffu, bq, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (anet::better(oq, oi, bq, bi)) {
      bq = oq;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_q[warp] = bq;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < THREADS / 32; ++v)
      if (anet::better(red_q[v], red_i[v], bq, bi)) {
        bq = red_q[v];
        bi = red_i[v];
      }
    part_q[(int64_t)b * n_tiles + tile] = bq;
    part_i[(int64_t)b * n_tiles + tile] = bi;
  }
}

__global__ void search_reduce_kernel(const float* __restrict__ part_q,
                                     const int32_t* __restrict__ part_i, int B, int n_tiles,
                                     float* __restrict__ best_q, int32_t* __restrict__ best_i) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float bq = part_q[(int64_t)b * n_tiles];
  int bi = part_i[(int64_t)b * n_tiles];
  for (int t = 1; t < n_tiles; ++t) {
    const float q = part_q[(int64_t)b * n_tiles + t];
    if (q > bq) {  // later tiles hold later lags: strict > keeps the first
      bq = q;
      bi = part_i[(int64_t)b * n_tiles + t];
    }
  }
  best_q[b] = bq;
  best_i[b] = bi;
}

}  // namespace

// seg: [B, seg_len] rows `row_stride` elements apart (last dim contiguous);
// tpl: [k] float32; part_q/part_i: [B, ceil(out_len / 2048)] scratch;
// best_q: [B] float32, best_i: [B] int32. Returns cudaGetLastError().
extern "C" int anet_sync_search(const void* seg, int dtype, int B, long long row_stride,
                                int seg_len, const void* tpl, int k, int out_len, float te,
                                void* part_q, void* part_i, void* best_q, void* best_i,
                                void* stream) {
  const int n_tiles = (out_len + TILE - 1) / TILE;
  const int kp = (k + LPT - 1) / LPT * LPT;
  const int kb = (k + EBLK - 1) / EBLK + 1;
  const int n_corr = TILE + kp + LPT;
  const int n_energy = (TILE / EBLK + kb) * EBLK;
  const int n_load = n_corr > n_energy ? n_corr : n_energy;
  const size_t smem = (size_t)(skew(n_load) + 8 + kp + TILE / EBLK + kb) * sizeof(float);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == anet::DTYPE_BF16) {
    err = cudaFuncSetAttribute(search_tile_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  } else {
    err = cudaFuncSetAttribute(search_tile_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, n_tiles);
  if (dtype == anet::DTYPE_BF16) {
    search_tile_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(seg), row_stride, seg_len,
        static_cast<const float*>(tpl), k, kp, out_len, te, kb, n_load,
        static_cast<float*>(part_q), static_cast<int32_t*>(part_i));
  } else {
    search_tile_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(seg), row_stride, seg_len, static_cast<const float*>(tpl), k,
        kp, out_len, te, kb, n_load, static_cast<float*>(part_q),
        static_cast<int32_t*>(part_i));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  search_reduce_kernel<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_q), static_cast<const int32_t*>(part_i), B, n_tiles,
      static_cast<float*>(best_q), static_cast<int32_t*>(best_i));
  return (int)cudaGetLastError();
}
