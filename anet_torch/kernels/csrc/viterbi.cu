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
// byte a step is written. The walk is serial in t, so the card fills only
// with many streams in flight at once: 8,192 streams are 62 warps a
// multiprocessor.
//
// Design: one warp per stream and no shared memory per stream, so registers
// alone bound occupancy (blocks of 4 warps at most 48 registers a thread, 42
// warps a multiprocessor: timed against 32 and 40 registers and 8-warp
// blocks). Lane l holds the path metrics of states l and l + 32, the two
// predecessors of states 2l and 2l + 1:
// - A step is the butterfly in the lane (eight multiply-adds, two minima)
//   and two shuffles that bring states l and l + 32 back: an even lane takes
//   state l from lane l / 2 and state l + 32 from lane l / 2 + 16, an odd
//   lane the other way round, so each shuffle reads every lane once, and a
//   lane's signs (those of states 2l and 2l + 1) never change.
// - Decisions: take = cand_1 < cand_0 is the sign bit of cand_1 - cand_0 (a
//   tie is +0: no metric is ever -0), shifted into one register per state;
//   every 32 steps the warp stores one coalesced 256-byte row, word s the
//   decisions of state s, to a device-memory array the wrapper allocates,
//   [N, ceil(T / 32), 32, 2] words (141 MB at B = 8,192, T = 2,150: written
//   and read once). One path for every T.
// - Soft input: lane i loads step t0 + 32 + i's pair while the warp runs
//   steps t0 .. t0 + 31 (one coalesced 256-byte load a block, a block
//   ahead) and parks it in a two-slot ring in shared memory; each step reads
//   its pair as a broadcast, off the path-metric chain.
// - Traceback: every lane follows the same surviving state s; a block's 64
//   words are read coalesced a block ahead into the ring, and each step reads
//   word s there as a broadcast. Lane i keeps bit t0 + i; each 32 steps go
//   out as one 32-byte store. The walk stays serial per stream, as in the
//   reference; with the streams resident the walks overlap across warps.
// (The TPU kernel's rotating state labels, pre-permuted tables and
// matrix-unit bit packing served its vector layout and are not carried over.)
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // streams a block
constexpr float BIG = 1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct Acs {
  // signs of the transitions into the butterfly's two new states: f of
  // state 2 lane + (lane >= 16), g of the other one
  float4 sf, sg;
  int src0, src1;      // lanes the two exchange shuffles read
  bool odd;
  float pm_lo, pm_hi;  // path metrics of states lane and lane + 32
  uint32_t df, dg;     // this block's decisions of the f and g states

  // the next step, soft pair (r0, r1)
  __device__ __forceinline__ void step(float r0, float r1) {
    // the butterfly of states lane and lane + 32: states 2 lane and 2 lane + 1
    const float c0_f = fmaf(sf.y, r1, fmaf(sf.x, r0, pm_lo));
    const float c1_f = fmaf(sf.w, r1, fmaf(sf.z, r0, pm_hi));
    const float c0_g = fmaf(sg.y, r1, fmaf(sg.x, r0, pm_lo));
    const float c1_g = fmaf(sg.w, r1, fmaf(sg.z, r0, pm_hi));
    // take = c1 < c0 is the sign bit of c1 - c0 (a tie gives +0), shifted
    // into the decision word; on a tie both candidates are the same number
    const float n_f = fminf(c0_f, c1_f);
    const float n_g = fminf(c0_g, c1_g);
    df = __funnelshift_l(__float_as_uint(__fsub_rn(c1_f, c0_f)), df, 1);
    dg = __funnelshift_l(__float_as_uint(__fsub_rn(c1_g, c0_g)), dg, 1);
    // back to states lane and lane + 32: an even lane takes state lane from
    // lane / 2 and lane + 32 from lane / 2 + 16, an odd lane the other way
    // round, so each shuffle reads every source lane once (the first
    // reads even states from lanes below 16 and odd ones above: the f states)
    const float a = __shfl_sync(FULL, n_f, src0);
    const float b = __shfl_sync(FULL, n_g, src1);
    pm_lo = odd ? b : a;
    pm_hi = odd ? a : b;
  }
};

// one traceback step: bit b of the block's word of state s (words[s]);
// the step's decoded bit s & 1 enters `bits` from below
__device__ __forceinline__ void back_step(int& s, uint32_t& bits, const uint32_t* words, int b) {
  const uint32_t word = words[s];
  bits = (bits << 1) | (uint32_t)(s & 1);
  s = (s >> 1) | (int)(((word >> b) & 1u) << 5);
}

__global__ void __maxnreg__(48)
viterbi_kernel(const float* __restrict__ signs, const float2* __restrict__ rx, int n_streams,
               int t_steps, uint2* __restrict__ dec, uint8_t* __restrict__ bits) {
  // a warp's two slots: 32 soft pairs of the forward pass, or 64 decision
  // words of the traceback
  __shared__ float4 ring[WARPS][2][16];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= n_streams || t_steps == 0) return;  // whole warps leave; no block-wide barrier follows
  const int n_blk = (t_steps + 31) / 32;
  const float2* x = rx + (int64_t)n * t_steps;
  uint2* d = dec + (int64_t)n * n_blk * 32 + lane;

  Acs acs;
  const bool high = lane >= 16;
  acs.sf = reinterpret_cast<const float4*>(signs)[2 * lane + high];
  acs.sg = reinterpret_cast<const float4*>(signs)[2 * lane + !high];
  acs.odd = lane & 1;
  acs.src0 = acs.odd ? (lane >> 1) + 16 : lane >> 1;
  acs.src1 = acs.odd ? lane >> 1 : (lane >> 1) + 16;
  acs.pm_lo = lane == 0 ? 0.0f : BIG;
  acs.pm_hi = BIG;

  float2 ahead = lane < t_steps ? x[lane] : make_float2(0.0f, 0.0f);
  for (int blk = 0; blk < n_blk; ++blk) {
    float2* slot = reinterpret_cast<float2*>(ring[warp][blk & 1]);
    slot[lane] = ahead;
    __syncwarp();  // the other slot was last read a block ago, before the previous barrier
    const int t_next = (blk + 1) * 32 + lane;
    ahead = t_next < t_steps ? __ldg(x + t_next) : make_float2(0.0f, 0.0f);
    acs.df = acs.dg = 0u;
    const int n_steps = min(32, t_steps - blk * 32);
    if (n_steps == 32) {
      const float4* pairs = ring[warp][blk & 1];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float4 r = pairs[i >> 1];
        acs.step(r.x, r.y);
        acs.step(r.z, r.w);
      }
    } else {
      for (int i = 0; i < n_steps; ++i) acs.step(slot[i].x, slot[i].y);
    }
    // words 2 lane and 2 lane + 1 of the row (word s: state s's decisions);
    // each lane reads back only its own words
    d[blk * 32] = high ? make_uint2(acs.dg, acs.df) : make_uint2(acs.df, acs.dg);
  }
  __syncwarp();  // the forward pass is done reading the slots

  // traceback from state 0, every lane on the same state
  uint8_t* out = bits + (int64_t)n * t_steps;
  int s = 0;
  uint2 w_next = d[(n_blk - 1) * 32];
  for (int blk = n_blk - 1; blk >= 0; --blk) {
    uint32_t* words = reinterpret_cast<uint32_t*>(ring[warp][blk & 1]);
    reinterpret_cast<uint2*>(words)[lane] = w_next;
    __syncwarp();
    if (blk > 0) w_next = d[(blk - 1) * 32];
    uint32_t mine = 0u;
    const int n_steps = min(32, t_steps - blk * 32);
    // step i's decision is bit n_steps - 1 - i; after the walk, bit i of
    // `mine` is step i's decoded bit
    if (n_steps == 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b) back_step(s, mine, words, b);
    } else {
      for (int b = 0; b < n_steps; ++b) back_step(s, mine, words, b);
    }
    if (lane < n_steps) out[blk * 32 + lane] = (uint8_t)((mine >> lane) & 1u);
  }
}

}  // namespace

// signs: [64, 4] float32; rx: [n_streams, t_steps, 2] float32 contiguous;
// dec: [n_streams, ceil(t_steps / 32), 32, 2] int32 scratch; bits:
// [n_streams, t_steps] uint8. Returns cudaGetLastError().
extern "C" int anet_viterbi(const void* signs, const void* rx, int n_streams, int t_steps,
                            void* dec, void* bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = (n_streams + WARPS - 1) / WARPS;
  viterbi_kernel<<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const float*>(signs), static_cast<const float2*>(rx), n_streams, t_steps,
      static_cast<uint2*>(dec), static_cast<uint8_t*>(bits));
  return (int)cudaGetLastError();
}
