// viterbi_trellis: 64-state rate-1/2 K=7 soft-decision Viterbi, Hopper.
//
// Replaces the TPU kernel pair anet/kernels/__init__.py viterbi_trellis
// (pallas_calls at lines 800 and 819; bodies _vit_fwd_kernel at line 663 and
// _vit_bwd_kernel at line 733). For each stream, over T trellis steps:
//   pm_0[0] = 0, pm_0[s] = 1e9 otherwise
//   cand_j[ns] = pm[(ns >> 1) | (j << 5)] + signs[ns][2j] * rx0
//                                          + signs[ns][2j+1] * rx1   (that order)
//   take[ns]  = cand_1 < cand_0 (strict: ties keep j = 0)
//   pm[ns]    = min(cand_0, cand_1), float32, never normalized
// then the traceback from state 0: bit[t] = s & 1, s = (s >> 1) | (take_t[s] << 5).
// The signs are +-1, so each fused multiply-add below rounds exactly as the
// multiply followed by the add.
//
// What bounds it on the H100: the add-compare-select arithmetic, 640 float32
// operations a step and stream on the CUDA cores (compare and select cannot
// run on tensor cores); the soft input is read once (8 bytes a step) and one
// byte a step is written.
//
// Design: one warp per stream. Lane l holds the path metrics of states l
// and l + 32; both predecessors of state l live in lane l >> 1 and both of
// state l + 32 in lane (l >> 1) + 16, so a step is four shuffles, eight
// multiply-adds and two compares. __ballot_sync of the two compares IS the
// step's pair of 32-bit decision words (bit s of word s / 32), which lane 0
// stores in shared memory: 8 bytes a step, so the decisions of a whole
// trellis never reach device memory and forward pass and traceback are one
// kernel. (The TPU kernel's rotating state labels, pre-permuted tables and
// matrix-unit bit packing served its vector layout and are not carried
// over.) Every lane then walks the traceback on the same state, lane t % 32
// keeps bit t, and each 32 steps go out as one coalesced store. A trellis
// too long for shared memory keeps its decision words in a device-memory
// scratch the wrapper allocates.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // streams per block
constexpr float BIG = 1e9f;

__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float* __restrict__ signs, const float2* __restrict__ rx, int n_streams,
               int t_steps, uint2* __restrict__ scratch, uint8_t* __restrict__ bits) {
  extern __shared__ uint2 dec_shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= n_streams) return;  // whole warps leave; no block-wide barrier follows
  uint2* dec = scratch ? scratch + (int64_t)n * t_steps : dec_shared + (int64_t)warp * t_steps;
  const float2* x = rx + (int64_t)n * t_steps;

  // signs of the transitions into states `lane` (lo) and `lane + 32` (hi)
  const float4 sl = reinterpret_cast<const float4*>(signs)[lane];
  const float4 sh = reinterpret_cast<const float4*>(signs)[lane + 32];
  float pm_lo = lane == 0 ? 0.0f : BIG;
  float pm_hi = BIG;
  const int p_lo = lane >> 1;  // lane holding states p and p + 32: predecessors of `lane`
  const int p_hi = p_lo + 16;  // and of `lane + 32`

#pragma unroll 4
  for (int t = 0; t < t_steps; ++t) {
    const float2 r = __ldg(x + t);
    const float a0 = __shfl_sync(0xffffffffu, pm_lo, p_lo);
    const float a1 = __shfl_sync(0xffffffffu, pm_hi, p_lo);
    const float b0 = __shfl_sync(0xffffffffu, pm_lo, p_hi);
    const float b1 = __shfl_sync(0xffffffffu, pm_hi, p_hi);
    const float c0_lo = fmaf(sl.y, r.y, fmaf(sl.x, r.x, a0));
    const float c1_lo = fmaf(sl.w, r.y, fmaf(sl.z, r.x, a1));
    const float c0_hi = fmaf(sh.y, r.y, fmaf(sh.x, r.x, b0));
    const float c1_hi = fmaf(sh.w, r.y, fmaf(sh.z, r.x, b1));
    const bool take_lo = c1_lo < c0_lo;
    const bool take_hi = c1_hi < c0_hi;
    pm_lo = take_lo ? c1_lo : c0_lo;
    pm_hi = take_hi ? c1_hi : c0_hi;
    const unsigned w_lo = __ballot_sync(0xffffffffu, take_lo);
    const unsigned w_hi = __ballot_sync(0xffffffffu, take_hi);
    if (lane == 0) dec[t] = make_uint2(w_lo, w_hi);
  }
  __syncwarp();

  // traceback: every lane follows the same surviving state
  uint8_t* out = bits + (int64_t)n * t_steps;
  int s = 0;
  for (int tb = (t_steps - 1) / 32 * 32; tb >= 0; tb -= 32) {
    int mine = 0;
    for (int i = min(31, t_steps - 1 - tb); i >= 0; --i) {
      const uint2 d = dec[tb + i];
      if (lane == i) mine = s & 1;
      const unsigned word = s < 32 ? d.x : d.y;
      s = (s >> 1) | (((word >> (s & 31)) & 1u) << 5);
    }
    if (tb + lane < t_steps) out[tb + lane] = (uint8_t)mine;
  }
}

}  // namespace

// signs: [64, 4] float32; rx: [n_streams, t_steps, 2] float32 contiguous;
// scratch: null (decision words in shared memory; t_steps * 8 * 4 bytes must
// fit a block's 227 KB) or [n_streams, t_steps, 2] int32; bits:
// [n_streams, t_steps] uint8. Returns the first CUDA error.
extern "C" int anet_viterbi(const void* signs, const void* rx, int n_streams, int t_steps,
                            void* scratch, void* bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  size_t shared = scratch ? 0 : (size_t)WARPS * t_steps * sizeof(uint2);
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(viterbi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_streams + WARPS - 1) / WARPS;
  viterbi_kernel<<<blocks, WARPS * 32, shared, st>>>(
      static_cast<const float*>(signs), static_cast<const float2*>(rx), n_streams, t_steps,
      static_cast<uint2*>(scratch), static_cast<uint8_t*>(bits));
  return (int)cudaGetLastError();
}
