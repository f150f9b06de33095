// sync_search_blockmax: block maxima of the acquisition search's quality,
// Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py sync_search_blockmax
// (pallas_call at line 1364, body _search_blockmax_kernel at line 1203):
// the recorded two-phase search of the JAX package's stream module, whose
// first phase writes one value per 128-lag block and leaves the fold to the
// caller. For every 128-lag block c < out_len / 128 of each stream's
// segment seg[b, :]:
//   out[b, c] = max_{l in block c} q[l],   q[l] = |corr[l]| * scale[c]
// with corr, the blockwise window energy and q exactly as sync_search.cu
// computes them. out_len is a multiple of 128, so the output holds whole
// blocks only: the reference's -2.0 fill of its padded output lanes has
// nothing to fill here.
//
// What bounds it on the H100: as sync_search_fused, the correlation's
// 2 x k x out_len operations per stream (1.22 TFLOP at B = 8192, k = 2048,
// out_len = 36,352: 1.23 ms at the bf16 tensor-core peak); the segment read
// is 0.63 GB and the output 9 MB.
//
// Design: the search's product core (search_core.cuh: the block-Toeplitz
// product on the tensor cores, one row per 128-lag block), with its own
// epilogue: a row's maximum quality, which search_core's row_best already
// holds in the row's four lanes, is the block's value; the first of those
// lanes stores it. Nothing is folded across rows. Sharing the core makes
// every q bit-equal to the search's, so the maximum of the block maxima is
// the search's best (on the slab route too: blockmax_slab_kernel, for a
// template past the one-shot stage).
#include "search_core.cuh"

namespace {

using namespace anet::search;

// Each of this lane's two rows' maximum, stored by the first lane of its
// quad.
__device__ __forceinline__ void store_maxima(const Geometry& g, int b, int tile, const float (&rq)[2],
                                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = tile * g.mt + warp * WARP_ROWS + (lane >> 2);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < g.n_rows) out[(int64_t)b * g.n_rows + row0 + 8 * h] = rq[h];
  }
}

template <typename T, bool B_LO>
__global__ void __maxnreg__((max_regs<std::is_same<T, float>::value, B_LO>()))
blockmax_kernel(const T* __restrict__ seg, const uint32_t* __restrict__ tpl, Geometry g,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / g.n_tiles;
  const int tile = blockIdx.x % g.n_tiles;
  float rq[2];
  int rc[2];
  anet::search::tile_rows<T, B_LO>(seg, tpl, g, b, tile, smem, rq, rc);
  store_maxima(g, b, tile, rq, out);
}

// The slab route (templates past the one-shot stage): two blocks an SM.
template <typename T, bool B_LO>
__global__ void __launch_bounds__(SLAB_WARPS * 32, 2)
blockmax_slab_kernel(const T* __restrict__ seg, const uint32_t* __restrict__ tpl, SlabGeometry g,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / g.n_tiles;
  const int tile = blockIdx.x % g.n_tiles;
  float rq[2];
  int rc[2];
  anet::search::tile_rows_slab<T, B_LO>(seg, tpl, g, b, tile, smem, rq, rc);
  if (holds_rows(g)) store_maxima(g, b, tile, rq, out);
}

// The kernel of a launch at g: Geometry (the one-shot route) or
// SlabGeometry (the slab route).
template <typename T, bool B_LO>
auto kernel_for(const Geometry&) { return blockmax_kernel<T, B_LO>; }
template <typename T, bool B_LO>
auto kernel_for(const SlabGeometry&) { return blockmax_slab_kernel<T, B_LO>; }

template <typename T, bool B_LO, typename G>
cudaError_t launch(const void* seg, const void* tpl, const G& g, size_t smem, int B,
                   void* out, cudaStream_t st) {
  const auto kernel = kernel_for<T, B_LO>(g);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * g.n_tiles, block_threads(g), smem, st>>>(
      static_cast<const T*>(seg), static_cast<const uint32_t*>(tpl), g, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// seg: [B, seg_len] rows `row_stride` elements apart (last dim contiguous),
// float32 (dtype 0) or bfloat16 (1); tpl: the template words, as
// anet_sync_search takes them, and te_ptr / te as it takes them; out:
// [B, out_len / 128] float32, out_len a multiple of 128. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a geometry the kernel does not take.
extern "C" int anet_search_blockmax(const void* seg, int dtype, int B, long long row_stride,
                                    int seg_len, const void* tpl, int b_lo, int w, int k,
                                    int out_len, const void* te_ptr, float te, void* out,
                                    void* stream) {
  if (out_len < ROW || out_len % ROW) return (int)cudaErrorInvalidValue;
  const bool a_lo = dtype == anet::DTYPE_F32;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the one-shot stage where the template fits it, else the slab route
  auto run = [&](auto& g, size_t smem) -> cudaError_t {
    g.te_ptr = static_cast<const float*>(te_ptr);
    if (dtype == anet::DTYPE_BF16)
      return b_lo ? launch<__nv_bfloat16, true>(seg, tpl, g, smem, B, out, st)
                  : launch<__nv_bfloat16, false>(seg, tpl, g, smem, B, out, st);
    return b_lo ? launch<float, true>(seg, tpl, g, smem, B, out, st)
                : launch<float, false>(seg, tpl, g, smem, B, out, st);
  };
  Geometry g;
  SlabGeometry sg;
  size_t smem;
  if (make_geometry(g, row_stride, seg_len, out_len, k, w, te, a_lo, b_lo != 0, smem))
    return (int)run(g, smem);
  if (make_slab_geometry(sg, row_stride, seg_len, out_len, k, w, te, a_lo, b_lo != 0, smem))
    return (int)run(sg, smem);
  return (int)cudaErrorInvalidValue;
}

// The slab kernel's occupancy at a launch's geometry (slab_occupancy's
// out[8]); cudaErrorInvalidValue where the one-shot route takes the
// template or no route does.
extern "C" int anet_search_blockmax_slab_occupancy(int dtype, int b_lo, int w, int k, int out_len, int* out) {
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
