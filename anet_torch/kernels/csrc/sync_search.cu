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
// What bounds it on the H100: the correlation's 2 x k x out_len operations
// per stream (1.22 TFLOP at B = 8192, k = 2048, out_len = 36,352: 1.23 ms
// at the bf16 tensor-core peak); the segment read is only 0.63 GB
// (0.19 ms). On the CUDA cores in float32 (67 TFLOP/s) the product could
// not go below 18 ms.
//
// Design: the block-Toeplitz product of search_core.cuh on the tensor cores
// (bf16 mma.sync, float32 accumulators; float32 operands as bf16 hi + lo),
// the TPU kernel's banded-template matmul re-tiled for Hopper: a block takes
// up to 128 rows of 128 lags of one stream (96 with a float32 operand) and
// stages their segment span once. Each row's maximum quality and first column come from the
// accumulators (search_core's row_best); the block folds its rows in lag
// order with a strict >, writes one (max, first argmax) pair, and a second
// small kernel folds a stream's blocks in lag order. No atomics: the result
// is deterministic. A template past the one-shot stage's shared memory
// (about 14,400 samples in float32) takes search_core.cuh's slab route,
// two blocks an SM (search_slab_kernel), with the same epilogue.
#include "search_core.cuh"

namespace {

using namespace anet::search;

// The block's (max, first argmax) of its rows from each lane's two rows'
// (rq, rc): the earlier row first, lags unique; the block's warps folded in
// lag order with a strict >.
__device__ __forceinline__ void block_best(const Geometry& g, int b, int tile, const float (&rq)[2],
                                           const int (&rc)[2], float* __restrict__ part_q,
                                           int32_t* __restrict__ part_i) {
  __shared__ float red_q[MAX_WARPS];
  __shared__ int red_i[MAX_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = tile * g.mt + warp * WARP_ROWS + (lane >> 2);
  float bq = rq[0];
  int bi = rc[0] < ROW ? row0 * ROW + rc[0] : 0x7fffffff;
  if (rc[1] < ROW && rq[1] > bq) {
    bq = rq[1];
    bi = (row0 + 8) * ROW + rc[1];
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const float oq = __shfl_xor_sync(0xffffffffu, bq, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
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
    for (int v = 1; v < (int)(blockDim.x >> 5); ++v)
      if (anet::better(red_q[v], red_i[v], bq, bi)) {
        bq = red_q[v];
        bi = red_i[v];
      }
    part_q[(int64_t)b * g.n_tiles + tile] = bq;
    part_i[(int64_t)b * g.n_tiles + tile] = bi;
  }
}

template <typename T, bool B_LO>
__global__ void __maxnreg__((max_regs<std::is_same<T, float>::value, B_LO>()))
search_tile_kernel(const T* __restrict__ seg, const uint32_t* __restrict__ tpl, Geometry g,
                   float* __restrict__ part_q, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / g.n_tiles;
  const int tile = blockIdx.x % g.n_tiles;
  float rq[2];
  int rc[2];
  anet::search::tile_rows<T, B_LO>(seg, tpl, g, b, tile, smem, rq, rc);
  block_best(g, b, tile, rq, rc, part_q, part_i);
}

// The slab route (templates past the one-shot stage): two blocks an SM.
template <typename T, bool B_LO>
__global__ void __launch_bounds__(SLAB_WARPS * 32, 2)
search_slab_kernel(const T* __restrict__ seg, const uint32_t* __restrict__ tpl, SlabGeometry g,
                   float* __restrict__ part_q, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / g.n_tiles;
  const int tile = blockIdx.x % g.n_tiles;
  float rq[2];
  int rc[2];
  anet::search::tile_rows_slab<T, B_LO>(seg, tpl, g, b, tile, smem, rq, rc);
  block_best(g, b, tile, rq, rc, part_q, part_i);
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
    if (q > bq) {  // later blocks hold later lags: strict > keeps the first
      bq = q;
      bi = part_i[(int64_t)b * n_tiles + t];
    }
  }
  best_q[b] = bq;
  best_i[b] = bi;
}

// The kernel of a launch at g: Geometry (the one-shot route) or
// SlabGeometry (the slab route).
template <typename T, bool B_LO>
auto kernel_for(const Geometry&) { return search_tile_kernel<T, B_LO>; }
template <typename T, bool B_LO>
auto kernel_for(const SlabGeometry&) { return search_slab_kernel<T, B_LO>; }

template <typename T, bool B_LO, typename G>
cudaError_t launch(const void* seg, const void* tpl, const G& g, size_t smem, int B,
                   void* part_q, void* part_i, cudaStream_t st) {
  const auto kernel = kernel_for<T, B_LO>(g);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * g.n_tiles, block_threads(g), smem, st>>>(
      static_cast<const T*>(seg), static_cast<const uint32_t*>(tpl), g,
      static_cast<float*>(part_q), static_cast<int32_t*>(part_i));
  return cudaGetLastError();
}

}  // namespace

// seg: [B, seg_len] rows `row_stride` elements apart (last dim contiguous),
// float32 (dtype 0) or bfloat16 (1); tpl: the template words of
// kernels._search_template_words, int32 [1 + b_lo, 2, w] (b_lo: a float32
// template's lo half follows its hi half); part_q/part_i: [B, blocks]
// scratch, blocks >= ceil(ceil(out_len / 128) / 16) (a block takes at least
// 16 rows); best_q: [B] float32, best_i: [B] int32. te_ptr: the template
// energy, a float32 scalar on the card, or null for te by value.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
extern "C" int anet_sync_search(const void* seg, int dtype, int B, long long row_stride,
                                int seg_len, const void* tpl, int b_lo, int w, int k,
                                int out_len, const void* te_ptr, float te, void* part_q,
                                void* part_i, void* best_q, void* best_i, void* stream) {
  const bool a_lo = dtype == anet::DTYPE_F32;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the one-shot stage where the template fits it, else the slab route
  auto run = [&](auto& g, size_t smem) -> cudaError_t {
    g.te_ptr = static_cast<const float*>(te_ptr);
    if (dtype == anet::DTYPE_BF16)
      return b_lo ? launch<__nv_bfloat16, true>(seg, tpl, g, smem, B, part_q, part_i, st)
                  : launch<__nv_bfloat16, false>(seg, tpl, g, smem, B, part_q, part_i, st);
    return b_lo ? launch<float, true>(seg, tpl, g, smem, B, part_q, part_i, st)
                : launch<float, false>(seg, tpl, g, smem, B, part_q, part_i, st);
  };
  Geometry g;
  SlabGeometry sg;
  size_t smem;
  cudaError_t err;
  int n_tiles;
  if (make_geometry(g, row_stride, seg_len, out_len, k, w, te, a_lo, b_lo != 0, smem)) {
    err = run(g, smem);
    n_tiles = g.n_tiles;
  } else if (make_slab_geometry(sg, row_stride, seg_len, out_len, k, w, te, a_lo, b_lo != 0, smem)) {
    err = run(sg, smem);
    n_tiles = sg.n_tiles;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  search_reduce_kernel<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_q), static_cast<const int32_t*>(part_i), B, n_tiles,
      static_cast<float*>(best_q), static_cast<int32_t*>(best_i));
  return (int)cudaGetLastError();
}

// The slab kernel's occupancy at a launch's geometry (slab_occupancy's
// out[8]); cudaErrorInvalidValue where the one-shot route takes the
// template or no route does.
extern "C" int anet_sync_search_slab_occupancy(int dtype, int b_lo, int w, int k, int out_len, int* out) {
  const bool a_lo = dtype == anet::DTYPE_F32;
  Geometry g;
  SlabGeometry sg;
  size_t smem;
  if (make_geometry(g, 0, 0, out_len, k, w, 1.0f, a_lo, b_lo != 0, smem) ||
      !make_slab_geometry(sg, 0, 0, out_len, k, w, 1.0f, a_lo, b_lo != 0, smem))
    return (int)cudaErrorInvalidValue;
  if (dtype == anet::DTYPE_BF16)
    return (int)(b_lo ? slab_occupancy(kernel_for<__nv_bfloat16, true>(sg), sg, smem, out)
                      : slab_occupancy(kernel_for<__nv_bfloat16, false>(sg), sg, smem, out));
  return (int)(b_lo ? slab_occupancy(kernel_for<float, true>(sg), sg, smem, out)
                    : slab_occupancy(kernel_for<float, false>(sg), sg, smem, out));
}
