// decide_frame_tm: the aligned receiver's full-fusion kernel for Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py decide_frame_tm
// (pallas_call at line 586, body _decide_frame_tm_kernel at line 335).
// Input: time-major whole frames x[T, B] (bfloat16, int8 or float32), the
// data section starting at row `row0` (the preamble offset, read in place:
// no copy of the data section is made). Per stream and symbol: the [sps, 2M]
// filterbank, I^2+Q^2, argmax (first index on ties), best and total; Gray
// decode; 8 symbols packed per int32 word, MSB-first; header and payload
// CRC-32 bit counts (exact; parity is taken by the caller); quality sums
// conf/best/total.
//
// What bounds it on the H100: the one read of the data rows (34,304 x B
// bf16 at the main path, 1.12 GB at B = 16384: 0.34 ms at 3.35 TB/s; int8
// halves it, 0.17 ms; float32 doubles it, 0.67 ms). The filterbank is 2 x
// 34,304 x 32 flops a stream: 0.04 ms on the tensor cores in bf16, 0.22 ms
// as float32's six bf16 products. Measured there (python -m
// anet_torch.kernels.time_search --kernels frame, H100 80GB HBM3, 700 W
// limit, device time of the kernel): bf16 0.40-0.43 ms, about 2.7 TB/s of
// the data rows; int8 0.26-0.28 ms, held by the per-symbol loop (0.21 ms
// with the copies taken out) more than by its bytes; float32 0.91 ms,
// 2.5 TB/s.
//
// Design (frame_tm_walk, one template for the three sample types; its
// kernels frame_tm_mma for bf16 and int8, frame_tm_mma_f32 for float32):
// - The product. Per symbol, IQ[b, n] = sum_k x[row0 + s sps + k, b] *
//   basis[k, n]: streams on the M axis of mma.sync m16n8k16 (bf16, float32
//   sums) or m16n8k32 (s8, exact int32 I/Q), the packed interleaved-(I, Q)
//   basis of demod_core.cuh (kernels._demod_mma_basis) as B fragments held
//   in registers for the whole launch (OneTerm). A lane's C registers are
//   one tone's I and Q for one stream, so I*I + Q*Q needs no shuffle.
//   float32 frames: demod_core.cuh's three-term split (SplitTerms). The
//   float32 basis is three bf16 terms that sum to it exactly
//   (kernels._demod_split_basis, the same fragment order; b0 in registers,
//   b1 and b2 in shared memory ahead of the ring), each sample is split into
//   three bf16 terms as it is read (a_split below), and the six products
//   a_i b_j with i + j <= 2 sum in two float32 accumulators, a0 b0 alone,
//   the rest smallest first, added before the energy: float32 sums to about
//   2^-24 (kernels.F32_SPLIT_RTOL, F32_SPLIT_ATOL).
// - The A operand from time-major rows. A block owns NB = 64 streams and
//   walks all of their symbols: each symbol's sps rows x 64 streams (128
//   bytes a row in bf16, 64 in int8, 256 in float32) are staged in shared
//   memory with 16-byte cp.async copies in a ring of STAGES symbols (about
//   40 KB; float32 two symbols, F32_RING, so more blocks fit an SM), so
//   every load of a warp covers whole row pieces. Shared rows are padded
//   by 16 bytes and their chunks swizzled (chunk q of row t at q ^ 2 bit 3
//   of t), so each 8-row ldmatrix phase below hits 8 distinct bank groups.
//   bf16: ldmatrix.x4.trans of (time 0-7 | 8-15) x (stream 0-7 | 8-15)
//   yields a0..a3 directly. int8: a stream pair is one 16-bit element;
//   ldmatrix.x4.trans of the rows at times {4i, 4i+1} and {4i+2, 4i+3}
//   (and + 16) and two __byte_perm give the 4 consecutive time bytes of
//   streams 2g and 2g+1: M row g is stream 2g, row g + 8 stream 2g + 1.
//   float32: 32-bit shared loads, conflict-free, then the split (a_split).
// - The epilogue: each lane's tones {i, 4+i, 8+i, 12+i} of its two
//   streams, then the quad with two xor shuffles of (energy, index), ties
//   to the first index; the quad's lanes all hold the decisions.
// - The CRC from the packed word, no FMAs: the counts are integers,
//   crc[c, b] = sum over tiles of popc(word[tile, b] & mask[tile][c]), with
//   mask[tile][c] bit nb-1-pos = P[tile nb + pos, c] (kernels
//   _frame_crc_masks). Lane i of a quad keeps columns 16i..16i+15 of both
//   its streams in registers, over every tile (a zero mask adds nothing).
// - The grid: a block per 64 streams and, while that leaves the card short
//   of the blocks it holds at once (B = 16,384 gives 256 blocks of 4 warps:
//   8 warps an SM, too few to cover the loop's latencies), a share of the
//   tiles per block (gridDim.y, up to one wave). words are written once;
//   each block adds its CRC counts and quality sums into zeroed outputs
//   with atomicAdd (the counts are integers, exact in any order; the sums
//   change their rounding order only). Streams past B read zeros (cp.async
//   source size 0) and write nothing.
// - Rows whose byte offset is not a multiple of 16 (B not a multiple of 8
//   for bf16, 16 for int8 or 4 for float32, or an unaligned base) cannot
//   take 16-byte copies: then the fetch loads bf16 and int8 element by
//   element into the same layout, and float32 with a 4-byte cp.async a
//   sample (loads in flight while the symbol before is computed).
// - decide_tones_tm (anet/kernels/__init__.py decide_tones_tm, pallas_call
//   at line 304), bfloat16 and float32 data, is this walk with another
//   epilogue (TONES): row0 0, every symbol's tone, best and total stored
//   by lanes 0 and 1 of each quad (M rows g and g + 8), no word, CRC
//   count or sum. Bound at the smoke run's oversized window (544 symbols
//   of 64 samples, B = 16384): bf16 1.25 GB read and written, 0.37 ms,
//   measured (time_search --kernels tones_tm, as above) 0.46-0.47 ms;
//   float32 2.39 GB, 0.71 ms, measured 0.87-0.89 ms.
//   This epilogue alone also takes sps 48 and 80 (3 and 5 k-steps of 16;
//   decide_frame_tm keeps one geometry for its three dtypes, and int8's
//   k-steps of 32 do not divide these) and 17-32 tones as 8 n-tiles,
//   every basis term then in shared memory (SharedTerms): the presets
//   mfsk8-audible (sps 48, 8 tones) and mfsk32-dense (sps 80, 32 tones).
//   Bound at their aligned paths (payload 256, B = 16384; 715 symbols of
//   48, 429 of 80), all bytes: bf16 0.378 / 0.361 ms, float32 0.713 /
//   0.697 ms; measured (time_search --kernels tones_tm, as above) bf16
//   0.47 / 0.46 ms, float32 0.86 / 1.20 ms. The last holds 2 blocks (8
//   warps) an SM: 229 registers, 74,240 bytes of shared memory.

#include <algorithm>

#include "demod_core.cuh"

namespace {

constexpr int SB = 8;  // symbols per packed word (TM_SYMBOL_TILE)

constexpr int NB = 64;              // streams a block
constexpr int WARPS = NB / 16;      // a warp takes 16 streams: one m16 tile
constexpr int THREADS = 32 * WARPS;
constexpr int RING_TARGET = 40960;  // bytes of a block's ring

template <typename T, int SPS>
struct Geo {
  static constexpr int CH = NB * (int)sizeof(T) / 16;  // 16-byte chunks of a staged row
  static constexpr int E = 16 / (int)sizeof(T);        // streams a chunk
  static constexpr int PITCH = 16 * (CH + 1);          // a staged row with its pad
  static constexpr int STAGE = SPS * PITCH;            // a ring stage: one symbol's rows
  // float32 stages are twice a bf16 one: a ring of F32_RING (2) stages,
  // as the other split walks (3 stages timed alike: 0.956-0.979 ms of
  // device time at sps 64 against 0.950-0.956, time_search --kernels
  // frame, H100 80GB HBM3, 700 W)
  static constexpr int STAGES =
      sizeof(T) == 4 ? anet::demod::F32_RING
      : RING_TARGET / STAGE < 3 ? 3 : RING_TARGET / STAGE > 16 ? 16 : RING_TARGET / STAGE;
  // k-steps: 16 times (bf16, and float32 split into bf16 terms) or 32 (int8)
  static constexpr int KS = SPS / (sizeof(T) == 1 ? 32 : 16);
  static_assert((SPS * CH) % THREADS == 0, "a stage's chunks split evenly over the block");
  static_assert((SPS * NB) % THREADS == 0, "a stage's samples split evenly over the block");
  static_assert(CH >= 4, "the swizzle flips bit 1 of the chunk index");
};

// The B operand of a T walk with NT n-tiles: the one-term basis in
// registers (bf16, int8) or the three-term split (float32: b0 in registers,
// b1 and b2 in the first P::SMEM bytes of shared memory, before the ring);
// at 8 n-tiles (decide_tones_tm, 17-32 tones) the same products with every
// term in those bytes (SharedTerms).
template <typename T, int SPS, int NT>
using Product =
    std::conditional_t<NT == 8, anet::demod::SharedTerms<T, SPS, NT, sizeof(T) == 4 ? 3 : 1>,
                       std::conditional_t<sizeof(T) == 4, anet::demod::SplitTerms<float, SPS, NT>,
                                          anet::demod::OneTerm<T, SPS, NT>>>;

// A block's shared memory: the product's, then the ring.
template <typename T, int SPS, int NT>
constexpr int smem_bytes() {
  return Product<T, SPS, NT>::SMEM + Geo<T, SPS>::STAGES * Geo<T, SPS>::STAGE;
}

// Byte offset of chunk q of staged row t.
template <typename T, int SPS>
__device__ __forceinline__ int chunk_at(int t, int q) {
  return t * Geo<T, SPS>::PITCH + 16 * (q ^ (((t >> 3) & 1) << 1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A 4-byte asynchronous copy: src_bytes (4 or 0) from src, zeros after.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

struct Frame {
  const unsigned char* x;
  int B, row0, n_symbols, n_tiles, bps;
  bool aligned;           // 16-byte copies: every row piece starts on a 16-byte boundary
  const uint32_t* basis;  // kernels._demod_mma_basis; float32: kernels._demod_split_basis
  const uint32_t* masks;  // [n_tiles, 64] kernels._frame_crc_masks
  int32_t* words;
  float* crc;
  float* qual;
  int32_t* tone;  // decide_tones_tm (TONES): [n_symbols, B] decisions, no words, counts or sums
  float* best;
  float* total;
};

// Stage symbol s of the block's streams (nothing from s_end on), then
// commit a group: every call commits one.
template <typename T, int SPS>
__device__ __forceinline__ void fetch(const Frame& f, int b0, int s, int s_end, unsigned char* stage) {
  using G = Geo<T, SPS>;
  if (s < s_end) {
    const int64_t r0 = f.row0 + (int64_t)s * SPS;
    if (f.aligned) {
#pragma unroll
      for (int k = 0; k < SPS * G::CH / THREADS; ++k) {
        const int c = threadIdx.x + k * THREADS;
        const int t = c / G::CH, q = c % G::CH;
        const int b = b0 + q * G::E;
        const int live = f.B - b;
        const int bytes = live >= G::E ? 16 : live > 0 ? live * (int)sizeof(T) : 0;
        const void* src = bytes ? static_cast<const void*>(f.x + ((r0 + t) * f.B + b) * (int64_t)sizeof(T))
                                : static_cast<const void*>(f.x);
        anet::demod::cp_async16(stage + chunk_at<T, SPS>(t, q), src, bytes);
      }
    } else if constexpr (sizeof(T) == 4) {
      // float32 rows lie on 4-byte boundaries: a 4-byte asynchronous copy a
      // sample, zeros past the last stream. Thread (t0, col) copies stream
      // column col of rows t0 + 2 k, so its source advances by two rows and
      // its destination by a constant but for the swizzle, which flips with
      // bit 3 of t0 + 2 k: bit 2 of k, as t0 < 2.
      static_assert(THREADS == 2 * NB, "a thread a stream column, two rows a step");
      const int col = threadIdx.x % NB, t0 = threadIdx.x / NB;
      const int bytes = b0 + col < f.B ? 4 : 0;
      const unsigned char* src = bytes ? f.x + ((r0 + t0) * f.B + b0 + col) * 4 : f.x;
      const int64_t step = bytes ? 8 * (int64_t)f.B : 0;
      unsigned char* dst = stage + t0 * G::PITCH + 4 * (col & 3);
      const int q0 = 16 * (col >> 2), q1 = 16 * ((col >> 2) ^ 2);  // chunk offsets, swizzle off and on
#pragma unroll 16
      for (int k = 0; k < SPS / 2; ++k)
        cp_async4(dst + 2 * k * G::PITCH + ((k >> 2) & 1 ? q1 : q0), src + k * step, bytes);
    } else {
      using R = std::conditional_t<sizeof(T) == 2, uint16_t, uint8_t>;  // the sample's bits
      const R* x = reinterpret_cast<const R*>(f.x);
#pragma unroll 8
      for (int k = 0; k < SPS * NB / THREADS; ++k) {
        const int e = threadIdx.x + k * THREADS;
        const int t = e / NB, col = e % NB;
        const int b = b0 + col;
        const int byte = col * (int)sizeof(T);
        const R v = b < f.B ? x[(r0 + t) * f.B + b] : R(0);
        *reinterpret_cast<R*>(stage + chunk_at<T, SPS>(t, byte / 16) + byte % 16) = v;
      }
    }
  }
  anet::demod::cp_async_commit();
}

// A fragments of k-step ks of the warp's 16 streams from a staged symbol.
template <typename T, int SPS>
__device__ __forceinline__ void a_frag(const unsigned char* stage, int ks, int warp, int lane,
                                       uint32_t (&a)[4]) {
  const int j = lane >> 3, rr = lane & 7;  // this lane's matrix and row of the x4 load
  static_assert(sizeof(T) <= 2, "float32 rows take a_split");
  if constexpr (sizeof(T) == 2) {
    // matrix j: times 16 ks + 8 (j >> 1) + rr, streams 8 (j & 1) .. + 7
    const int t = 16 * ks + 8 * (j >> 1) + rr;
    ldmatrix_x4_trans(a, stage + chunk_at<T, SPS>(t, 2 * warp + (j & 1)));
  } else {
    // matrix j: times 32 ks + 16 (j >> 1) + 2 (j & 1) + {0, 1, 4, 5, 8, 9, 12, 13}
    const int t = 32 * ks + 16 * (j >> 1) + 2 * (j & 1) + 4 * (rr >> 1) + (rr & 1);
    uint32_t r[4];
    ldmatrix_x4_trans(r, stage + chunk_at<T, SPS>(t, warp));
    a[0] = __byte_perm(r[0], r[1], 0x6420);  // stream 2g, times 4i .. 4i + 3
    a[1] = __byte_perm(r[0], r[1], 0x7531);  // stream 2g + 1
    a[2] = __byte_perm(r[2], r[3], 0x6420);  // the same at times 16 + 4i ..
    a[3] = __byte_perm(r[2], r[3], 0x7531);
  }
}

// float32: the A fragments of k-step ks of the warp's 16 streams, each
// sample split into three bf16 terms whose sum is it exactly
// (demod_core.cuh's bf16_pair): a0 = bf16(x), a1 = bf16(x - a0), a2 =
// bf16(x - a0 - a1). ldmatrix moves 16-bit elements only, so lane (g, i)
// loads its samples with 32-bit loads: M rows g and g + 8 (streams 16 warp
// + g, + 8, as bf16 maps them) at times 16 ks + 2 i, + 1 (registers 0, 1)
// and + 8, + 9 (2, 3). The eight times of one load lie in one half of the
// swizzle, so word (t, stream) of a load sits in bank 4 t + stream mod 32
// up to one shift of the warp: 32 distinct banks.
template <int SPS>
__device__ __forceinline__ void a_split(const unsigned char* stage, int ks, int warp, int lane,
                                        uint32_t (&a0)[4], uint32_t (&a1)[4], uint32_t (&a2)[4]) {
  const int g = lane >> 2, i = lane & 3;
#pragma unroll
  for (int hk = 0; hk < 2; ++hk) {
    const int t = 16 * ks + 8 * hk + 2 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * warp + 8 * h + g;  // the stream's column of the block
      const int at = 4 * (col & 3);
      float lo = *reinterpret_cast<const float*>(stage + chunk_at<float, SPS>(t, col >> 2) + at);
      float hi = *reinterpret_cast<const float*>(stage + chunk_at<float, SPS>(t + 1, col >> 2) + at);
      a0[2 * hk + h] = anet::demod::bf16_pair(lo, hi, lo, hi);
      a1[2 * hk + h] = anet::demod::bf16_pair(lo, hi, lo, hi);
      a2[2 * hk + h] = anet::demod::bf16_pair(lo, hi, lo, hi);
    }
  }
}

// The walk of a block. TONES: decide_tones_tm's epilogue, each symbol's
// tone, best and total stored; else decide_frame_tm's, the packed words,
// CRC counts and sums.
template <typename T, int SPS, int NT, bool TONES>
__device__ __forceinline__ void frame_tm_walk(const Frame& f) {
  using G = Geo<T, SPS>;
  using P = Product<T, SPS, NT>;
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(THREADS == anet::demod::THREADS, "SplitTerms stages b1 and b2 with the block");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + P::SMEM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i = lane & 3;
  const int b0 = blockIdx.x * NB;
  // M rows g and g + 8 of this warp's tile: bf16 and float32 streams g,
  // g + 8; int8 2g, 2g + 1
  int sb[2];
  sb[0] = b0 + 16 * warp + (sizeof(T) == 1 ? 2 * g : g);
  sb[1] = b0 + 16 * warp + (sizeof(T) == 1 ? 2 * g + 1 : g + 8);

  const P prod(f.basis, smem);  // the B operand (float32: behind the block's one __syncthreads)

  // this block's tiles: a share of the frame's, so that the card holds
  // enough warps
  const int t0 = (int)((int64_t)blockIdx.y * f.n_tiles / gridDim.y);
  const int t1 = (int)((int64_t)(blockIdx.y + 1) * f.n_tiles / gridDim.y);
  const int s_end = min(t1 * SB, f.n_symbols);
  int cnt[2][16];  // CRC columns 16i .. 16i + 15 of both streams
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 16; ++c) cnt[h][c] = 0;
  float conf = 0.0f, bsum = 0.0f, tsum = 0.0f;  // stream i & 1's quality sums

#pragma unroll
  for (int k = 0; k < G::STAGES - 1; ++k) fetch<T, SPS>(f, b0, t0 * SB + k, s_end, ring + k * G::STAGE);
  int slot = 0;  // the ring stage of symbol s

  for (int tile = t0; tile < t1; ++tile) {
    uint32_t word[2] = {0u, 0u};
#pragma unroll 1
    for (int s8 = 0; s8 < SB; ++s8) {
      const int s = tile * SB + s8;
      if (s >= s_end) break;  // padded symbols decide tone 0: data 0
      anet::demod::cp_async_wait<G::STAGES - 2>();
      __syncthreads();  // symbol s landed; every warp is done with symbol s - 1's stage
      const int next = slot == 0 ? G::STAGES - 1 : slot - 1;
      fetch<T, SPS>(f, b0, s + G::STAGES - 1, s_end, ring + next * G::STAGE);
      const unsigned char* stage = ring + slot * G::STAGE;
      slot = slot == G::STAGES - 1 ? 0 : slot + 1;
      // the product's sums (float32: acc holds a0 b0, small the rest, and
      // ef the energies of their sums)
      typename anet::demod::Acc<T>::type acc[NT][4];
      float small[F32 ? NT : 1][4], ef[F32 ? NT : 1][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
      if constexpr (F32) {
#pragma unroll
        for (int t = 0; t < NT; ++t) small[t][0] = small[t][1] = small[t][2] = small[t][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks) {
          uint32_t a0[4], a1[4], a2[4];
          a_split<SPS>(stage, ks, warp, lane, a0, a1, a2);
          prod.six_products(ks, lane, a0, a1, a2, acc, small);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ef[t][h] = anet::tone_energy(acc[t][2 * h] + small[t][2 * h], acc[t][2 * h + 1] + small[t][2 * h + 1]);
      } else {
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks) {
          uint32_t a[4];
          a_frag<T, SPS>(stage, ks, warp, lane, a);
          prod.products(ks, lane, a, acc);
        }
      }
      // the energy of tone 4 v + i of M row g + 8 h
      auto energy = [&](int v, int h) -> float {
        if constexpr (F32) return ef[v][h];
        else return anet::tone_energy((float)acc[v][2 * h], (float)acc[v][2 * h + 1]);
      };
      float best[2], total[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bq = energy(0, h);
        float tot = bq;
        int bt = i;
#pragma unroll
        for (int v = 1; v < NT; ++v) {
          const float e = energy(v, h);
          if (e > bq) {  // tones rise with v: a tie keeps the first
            bq = e;
            bt = 4 * v + i;
          }
          tot += e;
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float oq = __shfl_xor_sync(0xffffffffu, bq, off);
          const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
          tot += __shfl_xor_sync(0xffffffffu, tot, off);
          if (anet::better(oq, ot, bq, bt)) {
            bq = oq;
            bt = ot;
          }
        }
        if constexpr (TONES) {  // lanes 0 and 1 of a quad store M rows g and g + 8
          if (i == h && sb[h] < f.B) {
            const int64_t o = (int64_t)s * f.B + sb[h];
            f.tone[o] = bt;
            f.best[o] = bq;
            f.total[o] = tot;
          }
        } else {
          best[h] = bq;
          total[h] = tot;
          int data = bt;  // Gray -> binary
          for (int sh = 1; sh < f.bps; sh <<= 1) data ^= data >> sh;
          word[h] |= (uint32_t)data << ((SB - 1 - s8) * f.bps);
        }
      }
      if constexpr (!TONES) {
        // every lane of the quad holds both streams' sums: lane i sums
        // stream i & 1's, so each lane divides once
        const float bq = i & 1 ? best[1] : best[0], tot = i & 1 ? total[1] : total[0];
        conf += bq / fmaxf(tot, 1e-20f);
        bsum += bq;
        tsum += tot;
      }
    }
    if constexpr (TONES) continue;
    // lanes 0 and 1 of a quad store streams M rows g and g + 8: 16 words a warp
    const int mine = i == 0 ? sb[0] : sb[1];
    if (i < 2 && mine < f.B) f.words[(int64_t)tile * f.B + mine] = (int32_t)(i == 0 ? word[0] : word[1]);
    const uint4* mp = reinterpret_cast<const uint4*>(f.masks + (int64_t)tile * 64 + 16 * i);
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const uint4 m = __ldg(mp + c4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cnt[h][4 * c4 + 0] += __popc(word[h] & m.x);
        cnt[h][4 * c4 + 1] += __popc(word[h] & m.y);
        cnt[h][4 * c4 + 2] += __popc(word[h] & m.z);
        cnt[h][4 * c4 + 3] += __popc(word[h] & m.w);
      }
    }
  }
  anet::demod::cp_async_wait<0>();
  if constexpr (TONES) return;

  // the block's share of the sums, into zeroed outputs: integer counts add
  // exactly in any order, the quality sums change their rounding order only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (sb[h] >= f.B) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (cnt[h][c]) atomicAdd(f.crc + (int64_t)(16 * i + c) * f.B + sb[h], (float)cnt[h][c]);
    if (i == h) {
      atomicAdd(f.qual + sb[h], conf);
      atomicAdd(f.qual + (int64_t)f.B + sb[h], bsum);
      atomicAdd(f.qual + 2 * (int64_t)f.B + sb[h], tsum);
    }
  }
}

// bfloat16 and int8 frames.
template <typename T, int SPS, int NT, bool TONES>
__global__ void __launch_bounds__(THREADS) frame_tm_mma(Frame f) {
  frame_tm_walk<T, SPS, NT, TONES>(f);
}

// float32 frames, declared to fit 2 blocks an SM: every instantiation then
// keeps its values in registers (up to 238, no spill). With THREADS alone
// ptxas held some to 168 registers and spilled (16 bytes at sps 128), and
// the sps-64 frames took 0.99 ms of device time against 0.91
// (time_search --kernels frame, H100 80GB HBM3, 700 W).
template <int SPS, int NT, bool TONES>
__global__ void __launch_bounds__(THREADS, 2) frame_tm_mma_f32(Frame f) {
  frame_tm_walk<float, SPS, NT, TONES>(f);
}

// The grid: a block per NB streams (x) and, while that leaves the card
// short of its resident blocks, a share of the tiles (y).
template <typename T, int SPS, int NT, bool TONES>
cudaError_t launch_mma(const Frame& f, cudaStream_t st) {
  constexpr int smem = smem_bytes<T, SPS, NT>();
  static int resident = 0;  // blocks the card holds at once; 0 until the first call
  void (*kernel)(Frame);
  if constexpr (sizeof(T) == 4)
    kernel = frame_tm_mma_f32<SPS, NT, TONES>;
  else
    kernel = frame_tm_mma<T, SPS, NT, TONES>;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int gx = (f.B + NB - 1) / NB;
  const int gy = std::min(std::max(1, resident / gx), f.n_tiles);
  kernel<<<dim3(gx, gy), THREADS, smem, st>>>(f);
  return cudaGetLastError();
}

// n-tiles by the tone count: 4 tones an n8 tile; 8 tiles (17-32 tones)
// for decide_tones_tm only (decide_frame_tm takes at most 16).
template <typename T, int SPS, bool TONES>
cudaError_t dispatch_tones(int m, const Frame& f, cudaStream_t st) {
  if (m <= 4) return launch_mma<T, SPS, 1, TONES>(f, st);
  if (m <= 8) return launch_mma<T, SPS, 2, TONES>(f, st);
  if constexpr (TONES) {
    if (m > 16) return launch_mma<T, SPS, 8, TONES>(f, st);
  }
  return launch_mma<T, SPS, 4, TONES>(f, st);
}

// k-steps by sps: 32, 64 and 128 for both epilogues; 48 and 80 (3 and 5
// k-steps of 16) for decide_tones_tm only, as int8's k-steps of 32 do not
// divide them (kernels._tm_operands picks the route from the same sets).
template <typename T, bool TONES = false>
cudaError_t dispatch_sps(int sps, int m, const Frame& f, cudaStream_t st) {
  switch (sps) {
    case 32:
      return dispatch_tones<T, 32, TONES>(m, f, st);
    case 64:
      return dispatch_tones<T, 64, TONES>(m, f, st);
    case 128:
      return dispatch_tones<T, 128, TONES>(m, f, st);
  }
  if constexpr (TONES) {
    if (sps == 48) return dispatch_tones<T, 48, TONES>(m, f, st);
    if (sps == 80) return dispatch_tones<T, 80, TONES>(m, f, st);
  }
  return cudaErrorInvalidValue;
}

// The bytes of a sample of dtype code `dtype` (common.cuh): float32 4,
// bfloat16 2, int8 1; 0 for an unknown code.
int sample_bytes(int dtype) {
  return dtype == anet::DTYPE_F32 ? 4 : dtype == anet::DTYPE_BF16 ? 2 : dtype == anet::DTYPE_I8 ? 1 : 0;
}

}  // namespace

// float32 (dtype 0), bfloat16 (1) or int8 (2) x: [T, B] time-major, any
// base alignment; m <= 16 tones, sps 32, 64 or 128; basis: the B fragments
// of demod_core.cuh (kernels._demod_mma_basis for bfloat16 and int8,
// kernels._demod_split_basis's three terms for float32); masks: [n_tiles,
// 64] int32 (kernels._frame_crc_masks). words: [n_tiles, B] int32; crc:
// [64, B] and qual: [8, B] float32, zeroed by the caller. Returns
// cudaGetLastError().
extern "C" int anet_decide_frame_tm(const void* x, int dtype, int B, int row0, int sps, int m,
                                    int n_symbols, int n_tiles, int bps, const void* basis,
                                    const void* masks, void* words, void* crc, void* qual, void* stream) {
  const int elem = sample_bytes(dtype);
  if (elem == 0 || m < 1 || m > 16 || (bps != 1 && bps != 2 && bps != 4)) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_tiles == 0) return (int)cudaSuccess;
  Frame f{static_cast<const unsigned char*>(x), B, row0, n_symbols, n_tiles, bps,
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && ((int64_t)B * elem) % 16 == 0,
          static_cast<const uint32_t*>(basis), static_cast<const uint32_t*>(masks),
          static_cast<int32_t*>(words), static_cast<float*>(crc),
          static_cast<float*>(qual), nullptr, nullptr, nullptr};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_sps<__nv_bfloat16>(sps, m, f, st);
  if (dtype == anet::DTYPE_I8) return (int)dispatch_sps<int8_t>(sps, m, f, st);
  return (int)dispatch_sps<float>(sps, m, f, st);
}

// decide_tones_tm on the tensor cores. float32 (dtype 0) or bfloat16 (1) x:
// [>= n_symbols * sps, B] time-major, symbol-aligned at row 0, any base
// alignment; m <= 32 tones, sps 32, 48, 64, 80 or 128; basis as
// anet_decide_frame_tm takes it for the dtype (8 n-tiles past 16 tones).
// tone: [n_symbols, B] int32; best, total: [n_symbols, B] float32. Returns
// cudaGetLastError().
extern "C" int anet_decide_tones_tm_mma(const void* x, int dtype, int B, int sps, int m, int n_symbols,
                                        const void* basis, void* tone, void* best, void* total,
                                        void* stream) {
  if ((dtype != anet::DTYPE_F32 && dtype != anet::DTYPE_BF16) || m < 1 || m > 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  Frame f{static_cast<const unsigned char*>(x), B, 0, n_symbols, (n_symbols + SB - 1) / SB, 0,
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && ((int64_t)B * sample_bytes(dtype)) % 16 == 0,
          static_cast<const uint32_t*>(basis), nullptr, nullptr, nullptr, nullptr,
          static_cast<int32_t*>(tone), static_cast<float*>(best), static_cast<float*>(total)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_sps<__nv_bfloat16, true>(sps, m, f, st);
  return (int)dispatch_sps<float, true>(sps, m, f, st);
}
