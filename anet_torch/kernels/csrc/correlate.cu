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
// What bounds it on the H100: the product's 2 x k x out_len operations per
// stream (0.79 TFLOP at B = 8192, k = 2048, out_len = 23,552: 0.80 ms at the
// bf16 tensor-core peak); the segment read (0.42 GB) and the float32 output
// (0.77 GB) are 0.36 ms.
//
// Design: the acquisition search's tensor-core core (search_core.cuh) with a
// third epilogue. A block takes up to 128 rows of 128 lags of one stream (96
// with a float32 operand), stages their segment span once as bf16 rows
// (skipping the energy sums the searches need) and runs the block-Toeplitz
// product on mma.sync.m16n8k16 against the two shifted template copies
// (kernels._search_template_words, built once a template); float32 operands
// go as bf16 hi + lo, two or three products into the same float32
// accumulators. The epilogue writes each warp's 16 x 128 accumulators
// straight from their fragments (store_rows: a quad of lanes fills one
// 32-byte sector; timed against staging each warp's rows in shared memory
// for 512-byte row stores, which was slower); with two blocks a
// multiprocessor, one block's stores overlap the other's product. The TPU
// kernel's supercell and aliased input blocks fed its matrix unit and are
// not carried over. A template past the one-shot stage's shared memory takes
// search_core.cuh's slab route (correlate_slab_kernel).
#include "search_core.cuh"

namespace {

using namespace anet::search;

template <typename T, bool B_LO>
__global__ void __maxnreg__((max_regs<std::is_same<T, float>::value, B_LO>()))
correlate_kernel(const T* __restrict__ seg, const uint32_t* __restrict__ tpl, Geometry g,
                 float* __restrict__ out) {
  constexpr bool A_LO = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / g.n_tiles;
  const int tile = blockIdx.x % g.n_tiles;
  const Smem s = carve<A_LO, B_LO>(smem, g);
  stage<T, B_LO, false>(seg, tpl, g, b, tile, s);
  float acc[NT][4];
  product<A_LO, B_LO>(g, s, acc);
  store_rows(g, b, tile, acc, out);
}

// The slab route (templates past the one-shot stage): two blocks an SM.
template <typename T, bool B_LO>
__global__ void __launch_bounds__(SLAB_WARPS * 32, 2)
correlate_slab_kernel(const T* __restrict__ seg, const uint32_t* __restrict__ tpl, SlabGeometry g,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / g.n_tiles;
  const int tile = blockIdx.x % g.n_tiles;
  float sum[NT][4];
  slab_rows<T, B_LO, false>(seg, tpl, g, b, tile, smem, sum);
  if (holds_rows(g)) store_rows(g, b, tile, sum, out);
}

// The kernel of a launch at g: Geometry (the one-shot route) or
// SlabGeometry (the slab route).
template <typename T, bool B_LO>
auto kernel_for(const Geometry&) { return correlate_kernel<T, B_LO>; }
template <typename T, bool B_LO>
auto kernel_for(const SlabGeometry&) { return correlate_slab_kernel<T, B_LO>; }

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
// anet_sync_search takes them; out: [B, out_len] float32 contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
extern "C" int anet_correlate(const void* seg, int dtype, int B, long long row_stride,
                              int seg_len, const void* tpl, int b_lo, int w, int k, int out_len,
                              void* out, void* stream) {
  const bool a_lo = dtype == anet::DTYPE_F32;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the one-shot stage where the template fits it, else the slab route
  auto run = [&](const auto& g, size_t smem) -> cudaError_t {
    if (dtype == anet::DTYPE_BF16)
      return b_lo ? launch<__nv_bfloat16, true>(seg, tpl, g, smem, B, out, st)
                  : launch<__nv_bfloat16, false>(seg, tpl, g, smem, B, out, st);
    return b_lo ? launch<float, true>(seg, tpl, g, smem, B, out, st)
                : launch<float, false>(seg, tpl, g, smem, B, out, st);
  };
  Geometry g;
  SlabGeometry sg;
  size_t smem;
  if (make_geometry(g, row_stride, seg_len, out_len, k, w, 1.0f, a_lo, b_lo != 0, smem))
    return (int)run(g, smem);
  if (make_slab_geometry(sg, row_stride, seg_len, out_len, k, w, 1.0f, a_lo, b_lo != 0, smem))
    return (int)run(sg, smem);
  return (int)cudaErrorInvalidValue;
}

// The slab kernel's occupancy at a launch's geometry (slab_occupancy's
// out[8]); cudaErrorInvalidValue where the one-shot route takes the
// template or no route does.
extern "C" int anet_correlate_slab_occupancy(int dtype, int b_lo, int w, int k, int out_len, int* out) {
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
