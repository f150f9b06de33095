// frame_tm_any: the time-major pair (decide_tones_tm, decide_frame_tm) at
// every geometry off decide_frame_tm.cu's compile-time walk, on Hopper's
// tensor cores.
//
// Replaces, at those geometries, the TPU kernels anet/kernels/__init__.py
// decide_tones_tm (line 269, pallas_call at line 304) and decide_frame_tm
// (line 488, pallas_call at line 586), which take any samples_per_symbol
// and tone count. decide_frame_tm.cu's walk fixes sps at compile time (32,
// 64 or 128 and at most 16 tones for decide_frame_tm,
// kernels._tensor_core_geometry; also 48 and 80 and up to 32 tones for
// decide_tones_tm, kernels._filterbank_tensor_core_geometry): every MFSK
// preset. Custom configs off those (sps 15, 24, 40, 96, 160, 1,920, ...;
// more than 32 tones; decide_frame_tm at sps 48 or 80) come here
// (kernels._tm_operands: routes "tm_any" and "tm_any_split", counted under
// kernels.OFF_WALK_KEYS, frame_tm_any).
//
// Input: time-major x[T, B] (bfloat16 or float32; int8 too for the frame
// epilogue), symbol s in rows row0 + s sps .. row0 + (s + 1) sps - 1. Per
// stream and symbol: the [sps, 2M] filterbank, I*I + Q*Q of each tone
// (rounded after each operation, common.cuh's tone_energy), the argmax
// (the first tone on ties), best and total; then one of two epilogues:
// - TONES (decide_tones_tm): tone, best and total, [S, B] each;
// - frame (decide_frame_tm: bps 1, 2 or 4, at most 16 tones): Gray decode,
//   8 symbols packed into an int32 word MSB-first, the header and payload
//   CRC bit counts as popcounts of the words against
//   kernels._frame_crc_masks, the quality sums conf/best/total: the outputs
//   and layout of decide_frame_tm.cu.
//
// What bounds it on the H100: bytes. At sps 40 with 16 tones (payload
// 256's 536 symbols, B = 16,384) the read is 0.70 GB of bf16 (0.21 ms at
// 3.35 TB/s), 0.35 GB of int8, 1.41 GB of float32; the products (one bf16
// or int8 mma a k-step and n-tile, six for float32) take 0.01-0.05 ms at
// the tensor cores' peak.
//
// Design: decide_frame_tm.cu's walk with the geometry known at run time.
// - Streams on the M axis of mma.sync: m16n8k16 (bf16, float32 sums; float32
//   frames as demod_core.cuh's three-term split, each sample split into
//   three bf16 terms as it is read, six products) or m16n8k32 (int8, exact
//   int32 I and Q). A block owns NB = 64 streams, a warp 16 of them (int8:
//   stream pairs 2g, 2g + 1 on M rows g, g + 8).
// - A symbol is KS = ceil(sps / 16) k-steps (ceil(sps / 32) for int8). A
//   ring stage holds a byte target of rows x 64 streams (16-byte cp.async
//   copies, the rows padded by 16 bytes and their chunks swizzled as
//   decide_frame_tm.cu's), not a whole symbol: a symbol past it (sps 1,920:
//   120 k-steps) is walked in slabs of at most KSL k-steps with the
//   accumulators kept, so no sps is refused; a symbol within it shares its
//   stage with the next ones (up to 8 whole symbols a piece, one after
//   another, each swizzled from its own first row: 2 at sps 40 in bf16 and
//   int8, 6 at sps 15), so short symbols still fill the ring. The block's STAGES - 1
//   next pieces are in flight while one is read; one __syncthreads a piece.
//   Rows off 16 bytes (B not a multiple of 8 for bf16, 16 for int8, 4 for
//   float32) load element by element (float32: a 4-byte cp.async a
//   sample).
// - A fragments: ldmatrix.x4.trans of the staged rows (bf16; int8 with two
//   __byte_perm), or 32-bit shared loads split in registers (float32), as
//   decide_frame_tm.cu's. Samples past sps in a symbol's last k-step are
//   zeroed in the A registers: the next symbol's rows, or a stage's stale
//   bytes, never enter a sum.
// - B: kernels._filterbank_any_basis (int8: its x127 integers in k-steps of
//   32), packed once a config, dtype and device, in fragment order by
//   (group, k-step, n-tile, lane), zero rows past sps; copied into shared
//   memory once a block where it takes at most BASIS_SMEM bytes, else read
//   in place through the read-only cache.
// - Tones in groups of GROUP = 32 (8 n-tiles): past 32 tones the groups
//   follow in order over the same samples (a one-slab symbol: on the same
//   stage; else its slabs again) and fold into a running (best, tone,
//   total), strict > in tone order, so the first tone wins a tie.
// - The tensor cores truncate what they add to an accumulator: past one
//   slab (LONG) each slab's float32 sums are added into a float32 sum on the
//   CUDA cores, which rounds to nearest, and start again from zero, as
//   filterbank_any.cu's sums at sps 1,920 needed. int8 sums are exact.
// - The grid: a block per 64 streams (x) and, while that leaves the card
//   short of the blocks it holds at once, a share of the 8-symbol tiles (y);
//   each block adds its CRC counts and quality sums into zeroed outputs with
//   atomicAdd (integer counts exact in any order; the sums change their
//   rounding order only).
// The TPU kernels' 8 x 128 tiles and their zero padding are not carried
// over: a stream past B reads zeros and writes nothing, a symbol past
// n_symbols has no slab.
#include <algorithm>

#include "demod_core.cuh"

namespace {

using anet::demod::bf16_pair;
using anet::demod::cp_async16;
using anet::demod::cp_async_commit;
using anet::demod::cp_async_wait;
using anet::demod::mma;

constexpr int SB = 8;                  // symbols per packed word (kernels.TM_SYMBOL_TILE)
constexpr int NB = 64;                 // streams a block
constexpr int WARPS = NB / 16;         // a warp takes 16 streams: one m16 tile
constexpr int THREADS = 32 * WARPS;
constexpr int GROUP = 32;              // tones a group: 8 n8 tiles of 4 tones' (I, Q)
constexpr int BASIS_SMEM = 49152;      // the most basis bytes a block copies into shared memory
constexpr int MAX_SMEM = 232448;

// The staged rows of a sample type: 64 streams a row, 16 bytes of pad.
template <typename T>
struct Rows {
  static constexpr int CH = NB * (int)sizeof(T) / 16;  // 16-byte chunks of a staged row
  static constexpr int E = 16 / (int)sizeof(T);        // streams a chunk
  static constexpr int PITCH = 16 * (CH + 1);
  static constexpr int KROWS = sizeof(T) == 1 ? 32 : 16;  // time rows a k-step
  // the ring: stages of at most 13.5 KB in bf16 (a symbol of 96 samples, or
  // two of 40), 10 KB in int8 (two of 40; 13.5 KB took sps 1,920 from 0.24
  // to 0.31-0.33 ms) and 13 KB in float32 (48 rows); 4 of them, 3 for
  // float32 (4 leave 3 blocks an SM and ran 1.2-1.4x slower at sps 40 and
  // 80; time_search --kernels frame_tm_any, H100 80GB HBM3, 700 W)
  static constexpr int STAGES = sizeof(T) == 4 ? 3 : 4;
  static constexpr int STAGE_TARGET = sizeof(T) == 4 ? 13056 : sizeof(T) == 1 ? 10240 : 13824;
  static_assert(CH >= 4, "the swizzle flips bit 1 of the chunk index");
};

// Byte offset of chunk q of staged row t.
template <typename T>
__device__ __forceinline__ int chunk_at(int t, int q) {
  return t * Rows<T>::PITCH + 16 * (q ^ (((t >> 3) & 1) << 1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

// The kept bits of a register of 32 / w samples of w bytes whose first lies
// `left` samples before the symbol's end: all, the first `left`, or none.
template <int W>
__device__ __forceinline__ uint32_t keep_mask(int left) {
  constexpr int N = 4 / W;
  return left >= N ? 0xffffffffu : left <= 0 ? 0u : (1u << (8 * W * left)) - 1u;
}

// The launch's geometry, all set on the host.
struct Geo {
  const unsigned char* x;
  int B, row0, sps, m, n_symbols, n_tiles, bps;
  bool aligned;      // 16-byte copies: every row piece starts on a 16-byte boundary
  int ng;            // tone groups, ceil(m / GROUP)
  int ks;            // k-steps a symbol
  int ksl, nsl;      // k-steps a slab, slabs a symbol
  int ppi;           // ring pieces a symbol past one slab: ng * nsl
  int spp, slot;     // one slab a symbol: symbols a piece, and the staged rows from one to the next
  int stage;         // bytes of a ring stage
  int basis_smem;    // bytes of the basis copied into shared memory, or 0: read in place
  const uint2* b0;   // [ng, ks, nt, 32] b0 words
  const uint4* b12;  // [ng, ks, nt, 32] b1 and b2 words (float32)
  const uint32_t* masks;  // [n_tiles, 64] kernels._frame_crc_masks (frame)
  int32_t* words;         // [n_tiles, B] (frame)
  float* crc;             // [64, B] (frame)
  float* qual;            // [8, B] (frame)
  int32_t* tone;          // [n_symbols, B] (TONES)
  float* best;
  float* total;
};

// Piece q of a block whose symbols start at s_begin: one slab a symbol,
// up to spp whole symbols, every group on them; past one slab, one slab of
// one symbol for one group (q % ppi: the group's slabs in order).
struct Piece {
  int s0, n_syms, sl, grp_lo, grp_hi;
};

__device__ __forceinline__ Piece piece(const Geo& g, int s_begin, int s_end, int q) {
  Piece p;
  if (g.nsl == 1) {
    p.s0 = s_begin + q * g.spp;
    p.n_syms = min(g.spp, s_end - p.s0);
    p.sl = p.grp_lo = 0;
    p.grp_hi = g.ng;
  } else {
    const int rem = q % g.ppi;
    p.s0 = s_begin + q / g.ppi;
    p.n_syms = 1;
    p.sl = rem % g.nsl;
    p.grp_lo = rem / g.nsl;
    p.grp_hi = p.grp_lo + 1;
  }
  return p;
}

// Stage piece q's rows (symbol s0 + j's slab at staged rows j slot ..),
// nothing from np on, then commit a group: every call commits one.
template <typename T>
__device__ __forceinline__ void fetch(const Geo& g, int b0, int s_begin, int s_end, int q, int np,
                                      unsigned char* stage) {
  using R = Rows<T>;
  if (q < np) {
    const Piece p = piece(g, s_begin, s_end, q);
    const int lo = p.sl * g.ksl * R::KROWS;  // the slab's first row of a symbol
    const int n_rows = min(g.ksl * R::KROWS, g.sps - lo);
    const int64_t r0 = g.row0 + (int64_t)p.s0 * g.sps + lo;
#pragma unroll 1
    for (int j = 0; j < p.n_syms; ++j) {  // symbol s0 + j's rows at staged rows j slot ..
      const int64_t rj = r0 + (int64_t)j * g.sps;
      unsigned char* sj = stage + j * g.slot * R::PITCH;  // rows swizzled from the symbol's first
      if (g.aligned) {
        for (int c = threadIdx.x; c < n_rows * R::CH; c += THREADS) {
          const int t = c / R::CH, qc = c % R::CH;
          const int b = b0 + qc * R::E;
          const int live = g.B - b;
          const int bytes = live >= R::E ? 16 : live > 0 ? live * (int)sizeof(T) : 0;
          const void* src = bytes ? static_cast<const void*>(g.x + ((rj + t) * g.B + b) * (int64_t)sizeof(T))
                                  : static_cast<const void*>(g.x);
          cp_async16(sj + chunk_at<T>(t, qc), src, bytes);
        }
      } else if constexpr (sizeof(T) == 4) {
        // float32 rows on 4-byte boundaries: a 4-byte asynchronous copy a
        // sample, zeros past the last stream; thread (t0, col) copies
        // stream column col of rows t0, t0 + 2, ...
        const int col = threadIdx.x % NB, t0 = threadIdx.x / NB;
        const int bytes = b0 + col < g.B ? 4 : 0;
        for (int t = t0; t < n_rows; t += THREADS / NB) {
          const unsigned char* src = bytes ? g.x + ((rj + t) * g.B + b0 + col) * 4 : g.x;
          cp_async4(sj + chunk_at<T>(t, col >> 2) + 4 * (col & 3), src, bytes);
        }
      } else {
        using W = std::conditional_t<sizeof(T) == 2, uint16_t, uint8_t>;  // the sample's bits
        const W* xw = reinterpret_cast<const W*>(g.x);
        for (int e = threadIdx.x; e < n_rows * NB; e += THREADS) {
          const int t = e / NB, col = e % NB;
          const int b = b0 + col;
          const int byte = col * (int)sizeof(T);
          const W v = b < g.B ? xw[(rj + t) * g.B + b] : W(0);
          *reinterpret_cast<W*>(sj + chunk_at<T>(t, byte / 16) + byte % 16) = v;
        }
      }
    }
  }
  cp_async_commit();
}

// The A fragments of k-step kk of a symbol's staged slab for the warp's 16
// streams (bf16, int8), the samples at or past `left` (the symbol's samples
// left from the k-step's first) zeroed.
template <typename T>
__device__ __forceinline__ void a_frag(const unsigned char* stage, int kk, int left, int warp, int lane,
                                       uint32_t (&a)[4]) {
  const int j = lane >> 3, rr = lane & 7;  // this lane's matrix and row of the x4 load
  const int i = lane & 3;
  if constexpr (sizeof(T) == 2) {
    // matrix j: times 16 kk + 8 (j >> 1) + rr, streams 8 (j & 1) .. + 7
    ldmatrix_x4_trans(a, stage + chunk_at<T>(16 * kk + 8 * (j >> 1) + rr, 2 * warp + (j & 1)));
    if (left < 16) {  // a0, a1: times 2i, 2i + 1; a2, a3: 8 later
      const uint32_t m0 = keep_mask<2>(left - 2 * i), m1 = keep_mask<2>(left - 8 - 2 * i);
      a[0] &= m0;
      a[1] &= m0;
      a[2] &= m1;
      a[3] &= m1;
    }
  } else {
    // matrix j: times 32 kk + 16 (j >> 1) + 2 (j & 1) + {0, 1, 4, 5, 8, 9, 12, 13}
    const int t = 32 * kk + 16 * (j >> 1) + 2 * (j & 1) + 4 * (rr >> 1) + (rr & 1);
    uint32_t r[4];
    ldmatrix_x4_trans(r, stage + chunk_at<T>(t, warp));
    a[0] = __byte_perm(r[0], r[1], 0x6420);  // stream 2g, times 4i .. 4i + 3
    a[1] = __byte_perm(r[0], r[1], 0x7531);  // stream 2g + 1
    a[2] = __byte_perm(r[2], r[3], 0x6420);  // the same at times 16 + 4i ..
    a[3] = __byte_perm(r[2], r[3], 0x7531);
    if (left < 32) {
      const uint32_t m0 = keep_mask<1>(left - 4 * i), m1 = keep_mask<1>(left - 16 - 4 * i);
      a[0] &= m0;
      a[1] &= m0;
      a[2] &= m1;
      a[3] &= m1;
    }
  }
}

// float32: the A fragments of k-step kk split into three bf16 terms
// (decide_frame_tm.cu's a_split), samples at or past `left` zeroed.
__device__ __forceinline__ void a_split(const unsigned char* stage, int kk, int left, int warp, int lane,
                                        uint32_t (&a0)[4], uint32_t (&a1)[4], uint32_t (&a2)[4]) {
  const int g = lane >> 2, i = lane & 3;
#pragma unroll
  for (int hk = 0; hk < 2; ++hk) {
    const int t = 16 * kk + 8 * hk + 2 * i;
    const int l = left - 8 * hk - 2 * i;  // samples of the symbol from time t on
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * warp + 8 * h + g;  // the stream's column of the block
      const int at = 4 * (col & 3);
      float lo = *reinterpret_cast<const float*>(stage + chunk_at<float>(t, col >> 2) + at);
      float hi = *reinterpret_cast<const float*>(stage + chunk_at<float>(t + 1, col >> 2) + at);
      lo = l >= 1 ? lo : 0.0f;
      hi = l >= 2 ? hi : 0.0f;
      a0[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
      a1[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
      a2[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
    }
  }
}

// T the frames' samples; NT n-tiles a group; TONES: decide_tones_tm's
// epilogue, else decide_frame_tm's; LONG (past one slab): each slab's
// float32 sums added into a float32 sum on the CUDA cores.
//
// 4 blocks an SM (at most 128 registers): the walk's time follows the warps
// an SM more than its bytes in flight (8 stages, one symbol each, ran
// up to 1.5x slower at 3 blocks an SM than 4 stages at 4).
template <typename T, int NT, bool TONES, bool LONG>
__global__ void __launch_bounds__(THREADS, 4) frame_tm_any_kernel(const Geo g) {
  using R = Rows<T>;
  using A = typename anet::demod::Acc<T>::type;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int RING = R::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, i = lane & 3;
  const int b0 = blockIdx.x * NB;
  // M rows gq and gq + 8 of this warp's tile: bf16 and float32 streams gq,
  // gq + 8; int8 2 gq, 2 gq + 1
  int sb[2];
  sb[0] = b0 + 16 * warp + (sizeof(T) == 1 ? 2 * gq : gq);
  sb[1] = b0 + 16 * warp + (sizeof(T) == 1 ? 2 * gq + 1 : gq + 8);

  // the basis: copied into shared memory once a block where it fits
  const uint2* bw0 = g.b0;
  const uint4* bw12 = g.b12;
  unsigned char* ring = smem + g.basis_smem;
  if (g.basis_smem) {
    const int n0 = g.ng * g.ks * NT * 32;
    uint2* s0 = reinterpret_cast<uint2*>(smem);
    for (int j = threadIdx.x; j < n0; j += THREADS) s0[j] = __ldg(g.b0 + j);
    if constexpr (F32) {
      uint4* s12 = reinterpret_cast<uint4*>(smem + (size_t)n0 * 8);
      for (int j = threadIdx.x; j < n0; j += THREADS) s12[j] = __ldg(g.b12 + j);
      bw12 = s12;
    }
    bw0 = s0;
  }  // the first slab's __syncthreads covers the copy

  // this block's tiles: a share of the frame's, so that the card holds
  // enough warps
  const int t0 = (int)((int64_t)blockIdx.y * g.n_tiles / gridDim.y);
  const int t1 = (int)((int64_t)(blockIdx.y + 1) * g.n_tiles / gridDim.y);
  const int s_begin = t0 * SB;
  const int s_end = min(t1 * SB, g.n_symbols);
  const int np = g.nsl == 1 ? (s_end - s_begin + g.spp - 1) / g.spp : (s_end - s_begin) * g.ppi;

  int cnt[TONES ? 1 : 2][16];  // CRC columns 16i .. 16i + 15 of both streams
  if constexpr (!TONES) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 16; ++c) cnt[h][c] = 0;
  }
  float conf = 0.0f, bsum = 0.0f, tsum = 0.0f;  // stream i & 1's quality sums
  uint32_t word[2] = {0u, 0u};

#pragma unroll
  for (int k = 0; k < RING - 1; ++k) fetch<T>(g, b0, s_begin, s_end, k, np, ring + k * g.stage);

  A acc[NT][4];
  float small[F32 ? NT : 1][4];
  float sum[LONG ? NT : 1][4];  // LONG: the slabs before this one
  float fb[2], fs[2];           // the symbol's running best and total
  int ft[2];                    // and tone
  for (int q = 0; q < np; ++q) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // piece q landed; every warp is done with piece q - 1's stage
    fetch<T>(g, b0, s_begin, s_end, q + RING - 1, np, ring + ((q + RING - 1) % RING) * g.stage);
    const Piece p = piece(g, s_begin, s_end, q);
    const int sl = p.sl;
    const int nk = min(g.ksl, g.ks - sl * g.ksl);
#pragma unroll 1
    for (int j = 0; j < p.n_syms; ++j) {
      const int s = p.s0 + j;
      const unsigned char* stage = ring + (q % RING) * g.stage + j * g.slot * R::PITCH;  // the symbol's rows
      for (int grp = p.grp_lo; grp < p.grp_hi; ++grp) {
        if (sl == 0) {  // a group's first slab (LONG: the fold zeroes acc and small after each)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[t][v] = 0;
              if constexpr (F32) small[t][v] = 0.0f;
              if constexpr (LONG) sum[t][v] = 0.0f;
            }
        }
        for (int kk = 0; kk < nk; ++kk) {
          const int ks = sl * g.ksl + kk;
          const int left = g.sps - ks * R::KROWS;  // the symbol's samples from the k-step's first on
          const size_t bi = ((size_t)(grp * g.ks + ks) * NT) * 32 + lane;
          if constexpr (F32) {
            uint32_t a0[4], a1[4], a2[4];
            a_split(stage, kk, left, warp, lane, a0, a1, a2);
#pragma unroll
            for (int t = 0; t < NT; ++t) {  // SplitTerms' six products, smallest first
              const uint2 u = bw0[bi + 32 * t];
              const uint4 v = bw12[bi + 32 * t];
              mma(small[t], a2, u.x, u.y);
              mma(small[t], a1, v.x, v.y);
              mma(small[t], a0, v.z, v.w);
              mma(small[t], a1, u.x, u.y);
              mma(small[t], a0, v.x, v.y);
              mma(acc[t], a0, u.x, u.y);
            }
          } else {
            uint32_t a[4];
            a_frag<T>(stage, kk, left, warp, lane, a);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              const uint2 u = bw0[bi + 32 * t];
              mma(acc[t], a, u.x, u.y);
            }
          }
        }
        if constexpr (LONG) {  // the slab's sums into the float32 sum, rounded to nearest
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              if constexpr (F32) {
                sum[t][v] += acc[t][v] + small[t][v];
                small[t][v] = 0.0f;
              } else {
                sum[t][v] += acc[t][v];
              }
              acc[t][v] = 0;
            }
        }
        if (sl != g.nsl - 1) continue;
        // the group's sums are whole: tone 4 u + i of M row gq + 8 h
        float e[NT][2];
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (LONG)
              e[u][h] = anet::tone_energy(sum[u][2 * h], sum[u][2 * h + 1]);
            else if constexpr (F32)
              e[u][h] = anet::tone_energy(acc[u][2 * h] + small[u][2 * h], acc[u][2 * h + 1] + small[u][2 * h + 1]);
            else
              e[u][h] = anet::tone_energy((float)acc[u][2 * h], (float)acc[u][2 * h + 1]);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the group's argmax, best and total, folded into the symbol's
          float bq = e[0][h], tot = e[0][h];
          int bt = i;
#pragma unroll
          for (int u = 1; u < NT; ++u) {
            if (e[u][h] > bq) {  // tones rise with u: a tie keeps the first
              bq = e[u][h];
              bt = 4 * u + i;
            }
            tot += e[u][h];
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
          if (grp == 0) {
            fb[h] = bq;
            ft[h] = bt;
            fs[h] = tot;
          } else {
            if (bq > fb[h]) {  // groups rise in tone: a tie keeps the earlier
              fb[h] = bq;
              ft[h] = grp * GROUP + bt;
            }
            fs[h] += tot;
          }
        }
        if (grp != g.ng - 1) continue;
        // the symbol is decided: its epilogue
        if constexpr (TONES) {  // lanes 0 and 1 of a quad store M rows gq and gq + 8
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (i == h && sb[h] < g.B) {
              const int64_t o = (int64_t)s * g.B + sb[h];
              g.tone[o] = ft[h];
              g.best[o] = fb[h];
              g.total[o] = fs[h];
            }
        } else {
          const int s8 = s % SB;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int data = ft[h];  // Gray -> binary
            for (int shift = 1; shift < g.bps; shift <<= 1) data ^= data >> shift;
            word[h] |= (uint32_t)data << ((SB - 1 - s8) * g.bps);
          }
          // every lane of the quad holds both streams' sums: lane i sums
          // stream i & 1's, so each lane divides once
          const float bq = i & 1 ? fb[1] : fb[0], tot = i & 1 ? fs[1] : fs[0];
          conf += bq / fmaxf(tot, 1e-20f);
          bsum += bq;
          tsum += tot;
          if (s8 == SB - 1 || s == s_end - 1) {  // the tile's word is whole (padded symbols are data 0)
            const int tile = s / SB;
            const int mine = i == 0 ? sb[0] : sb[1];
            if (i < 2 && mine < g.B) g.words[(int64_t)tile * g.B + mine] = (int32_t)(i == 0 ? word[0] : word[1]);
            const uint4* mp = reinterpret_cast<const uint4*>(g.masks + (int64_t)tile * 64 + 16 * i);
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4) {
              const uint4 mk = __ldg(mp + c4);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                cnt[h][4 * c4 + 0] += __popc(word[h] & mk.x);
                cnt[h][4 * c4 + 1] += __popc(word[h] & mk.y);
                cnt[h][4 * c4 + 2] += __popc(word[h] & mk.z);
                cnt[h][4 * c4 + 3] += __popc(word[h] & mk.w);
              }
            }
            word[0] = word[1] = 0u;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (TONES) return;

  // the block's share of the sums, into zeroed outputs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (sb[h] >= g.B) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (cnt[h][c]) atomicAdd(g.crc + (int64_t)(16 * i + c) * g.B + sb[h], (float)cnt[h][c]);
    if (i == h) {
      atomicAdd(g.qual + sb[h], conf);
      atomicAdd(g.qual + (int64_t)g.B + sb[h], bsum);
      atomicAdd(g.qual + 2 * (int64_t)g.B + sb[h], tsum);
    }
  }
}

// Launch the instantiation with the geometry set: a block per NB streams
// (x) and, while that leaves the card short of its resident blocks, a share
// of the tiles (y).
template <typename T, int NT, bool TONES, bool LONG>
cudaError_t run(const Geo& g, cudaStream_t st) {
  auto kernel = frame_tm_any_kernel<T, NT, TONES, LONG>;
  static int sms = 0;  // one per instantiation, set on its first launch
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  const int smem = g.basis_smem + Rows<T>::STAGES * g.stage;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int gx = (g.B + NB - 1) / NB;
  const int gy = std::min(std::max(1, sms * per_sm / gx), g.n_tiles);
  kernel<<<dim3(gx, gy), THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

// Set the slabs, then launch the instantiation that takes the geometry.
template <typename T, int NT, bool TONES>
cudaError_t launch(Geo g, cudaStream_t st) {
  using R = Rows<T>;
  int ksl = std::max(1, R::STAGE_TARGET / (R::KROWS * R::PITCH));
  ksl = std::min(ksl, g.ks);
  g.nsl = (g.ks + ksl - 1) / ksl;
  g.ksl = (g.ks + g.nsl - 1) / g.nsl;  // the slabs evened out
  g.ppi = g.ng * g.nsl;
  if (g.nsl == 1) {  // whole symbols a stage, one after another
    g.slot = g.sps;
    const int extra = R::KROWS * g.ks - g.slot;  // the last symbol's k-steps read past its rows
    g.spp = std::max(1, std::min(SB, (R::STAGE_TARGET / R::PITCH - extra) / g.slot));
    g.stage = (g.spp * g.slot + std::max(extra, 0)) * R::PITCH;
  } else {
    g.spp = 1;
    g.slot = 0;
    g.stage = R::KROWS * g.ksl * R::PITCH;
  }
  const long long basis = (long long)g.ng * g.ks * NT * 32 * (sizeof(T) == 4 ? 24 : 8);
  g.basis_smem = basis <= BASIS_SMEM ? (int)basis : 0;
  if ((long long)(g.n_tiles * SB) * g.ppi >= (1LL << 31)) return cudaErrorInvalidValue;  // pieces count in int
  if constexpr (sizeof(T) == 1) {
    return run<T, NT, TONES, false>(g, st);  // int8 sums are exact
  } else {
    if (g.nsl > 1) return run<T, NT, TONES, true>(g, st);
    return run<T, NT, TONES, false>(g, st);
  }
}

// n-tiles of a group: 4 tones an n8 tile, at most 8 (GROUP tones).
template <typename T, bool TONES>
cudaError_t dispatch_tiles(int gm, const Geo& g, cudaStream_t st) {
  if (gm <= 4) return launch<T, 1, TONES>(g, st);
  if (gm <= 8) return launch<T, 2, TONES>(g, st);
  if constexpr (TONES) {
    if (gm > 16) return launch<T, 8, TONES>(g, st);
  }
  return launch<T, 4, TONES>(g, st);
}

int sample_bytes(int dtype) {
  return dtype == anet::DTYPE_F32 ? 4 : dtype == anet::DTYPE_BF16 ? 2 : dtype == anet::DTYPE_I8 ? 1 : 0;
}

// The common geometry of both entries; false for one the kernels do not take.
bool make_geo(Geo& g, const void* x, int dtype, int B, int row0, int sps, int m, int n_symbols, int n_tiles,
              int bps, const void* basis) {
  const int elem = sample_bytes(dtype);
  const int gm = m < GROUP ? m : GROUP;
  if (elem == 0 || sps < 1 || m < 1 || m % gm) return false;  // whole groups: m <= 32, or a multiple of 32
  g.x = static_cast<const unsigned char*>(x);
  g.B = B;
  g.row0 = row0;
  g.sps = sps;
  g.m = m;
  g.n_symbols = n_symbols;
  g.n_tiles = n_tiles;
  g.bps = bps;
  g.aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ((int64_t)B * elem) % 16 == 0;
  g.ng = m / gm;
  g.ks = (sps + (elem == 1 ? 31 : 15)) / (elem == 1 ? 32 : 16);
  const int nt = gm <= 4 ? 1 : gm <= 8 ? 2 : gm <= 16 ? 4 : 8;
  g.b0 = static_cast<const uint2*>(basis);
  g.b12 = reinterpret_cast<const uint4*>(g.b0 + (size_t)g.ng * g.ks * nt * 32);
  return true;
}

}  // namespace

// decide_frame_tm at any sps. float32 (dtype 0), bfloat16 (1) or int8 (2)
// x: [T, B] time-major, any base alignment; m 2, 4, 8 or 16 tones, bps 1, 2
// or 4; basis: kernels._filterbank_any_basis for the samples' dtype (int8:
// the x127 integers in k-steps of 32); masks: [n_tiles, 64] int32
// (kernels._frame_crc_masks). words: [n_tiles, B] int32; crc: [64, B] and
// qual: [8, B] float32, zeroed by the caller. The arguments of
// anet_decide_frame_tm. Returns cudaGetLastError().
extern "C" int anet_decide_frame_tm_any(const void* x, int dtype, int B, int row0, int sps, int m,
                                        int n_symbols, int n_tiles, int bps, const void* basis,
                                        const void* masks, void* words, void* crc, void* qual, void* stream) {
  if (m < 2 || m > 16 || (bps != 1 && bps != 2 && bps != 4)) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_tiles == 0) return (int)cudaSuccess;
  Geo g{};
  if (!make_geo(g, x, dtype, B, row0, sps, m, n_symbols, n_tiles, bps, basis)) return (int)cudaErrorInvalidValue;
  g.masks = static_cast<const uint32_t*>(masks);
  g.words = static_cast<int32_t*>(words);
  g.crc = static_cast<float*>(crc);
  g.qual = static_cast<float*>(qual);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_tiles<__nv_bfloat16, false>(m, g, st);
  if (dtype == anet::DTYPE_I8) return (int)dispatch_tiles<int8_t, false>(m, g, st);
  return (int)dispatch_tiles<float, false>(m, g, st);
}

// decide_tones_tm at any sps and tone count. float32 (dtype 0) or bfloat16
// (1) x: [>= n_symbols * sps, B] time-major, symbol-aligned at row 0; m at
// most 32 or a multiple of 32; basis as anet_decide_frame_tm_any takes it.
// tone: [n_symbols, B] int32; best, total: [n_symbols, B] float32. The
// arguments of anet_decide_tones_tm_mma. Returns cudaGetLastError().
extern "C" int anet_decide_tones_tm_any(const void* x, int dtype, int B, int sps, int m, int n_symbols,
                                        const void* basis, void* tone, void* best, void* total, void* stream) {
  if (dtype != anet::DTYPE_F32 && dtype != anet::DTYPE_BF16) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  Geo g{};
  if (!make_geo(g, x, dtype, B, 0, sps, m, n_symbols, (n_symbols + SB - 1) / SB, 0, basis))
    return (int)cudaErrorInvalidValue;
  g.tone = static_cast<int32_t*>(tone);
  g.best = static_cast<float*>(best);
  g.total = static_cast<float*>(total);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gm = m < GROUP ? m : GROUP;
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_tiles<__nv_bfloat16, true>(gm, g, st);
  return (int)dispatch_tiles<float, true>(gm, g, st);
}
