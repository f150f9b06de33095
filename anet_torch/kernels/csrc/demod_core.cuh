// The align+demod filterbank on the tensor cores, shared by demod_at.cu
// and demod_at_energies.cu (bfloat16 and int8 buffers, and float32 ones
// through SplitTerms) and tone_energies.cu (every start at 0: bfloat16
// compute, and float32 compute on bfloat16 or float32 rows).
// decide_frame_tm.cu walks time-major rows with an A read of its own and
// takes from here the mma and cp.async wrappers and the B operand and
// products of OneTerm, SplitTerms and (decide_tones_tm past 16 tones)
// SharedTerms.
//
// For stream b the data section starts at sample d0 = start[b] + pre of its
// buffer row, rows len samples apart (a PitchedSpan's `pitch` apart, pitch
// >= len: strided rows are read up to their own end, never into the gap
// after them); symbol s is the sps samples from d0 + s * sps, zero outside
// [0, len). Per symbol the kernels need I and Q of every tone:
//   IQ[s, n] = sum_k A[s, k] * B[k, n],   A[s, k] = row[d0 + s * sps + k]
// an [S, sps] x [sps, 8 n_tiles] product whose columns interleave the tones'
// (I, Q): column 2c is the cos of tone c, 2c + 1 its sin, zero columns past
// num_tones. A lane's two accumulators of an m16n8 C fragment are then one
// tone's I and Q for one symbol, and I*I + Q*Q needs no shuffle.
//
// - mma.sync: m16n8k16 bf16 x bf16 -> float32 (bf16 products are exact in
//   float32, the sum is taken in another order than the plain version's) or
//   m16n8k32 s8 x s8 -> s32 (the x127 integer basis: exact int32 I/Q, equal
//   to the reference's sums, below 2^24, so exact as floats too). The A
//   tile is 16 symbols x 16 (bf16, float32) or 32 (int8) samples a k-step.
//   n_tiles is a template argument: 1 for M <= 4 tones, 2 for M <= 8, 4 for
//   M <= 16, and 8 for M <= 32 (the batch-major filterbank and
//   decide_tones_tm, through SharedTerms).
// - B, in one of three forms, packed by the wrapper once a config and
//   device in fragment order (word [ks][t][r][lane]), the product type of
//   the walk (walk_with's P):
//   - OneTerm: the bf16 or the x127 int8 basis (kernels._demod_mma_basis);
//     every lane keeps its k-steps x n_tiles x 2 registers for the whole
//     launch.
//   - SharedTerms (8 n-tiles): OneTerm's or SplitTerms' products, every
//     term staged once a block in shared memory.
//   - SplitTerms (float32 compute, and the float32 buffers of demod_at.cu
//     and demod_at_energies.cu): the float32 basis as three bf16 terms,
//     b = b0 + b1 + b2 exactly (kernels._demod_split_basis, [3, ks, n, 2,
//     32]); b0 in registers, b1
//     and b2 in shared memory, one copy a block.
//     bf16 samples meet all three (3 products a k-step and n-tile). float32
//     samples, staged as float32, are split in registers into a0 + a1 + a2
//     the same way (a_split) and keep the six products a_i b_j with
//     i + j <= 2: the float32 sums to about 2^-24. The tensor cores align a
//     sum's addends to the largest and truncate the rest, so a0 b0 sums in
//     one accumulator and the smaller products in another, smallest first,
//     added in float32 before the energy.
// - The span read: each warp walks (stream, tile) items, a tile SYMS
//   symbols (about 2 KB of samples), and keeps RING - 1 tiles' loads in
//   flight in its own ring of RING stages of shared memory (STAGES, 4;
//   F32_RING, 2, in the float32 buffers' kernels, whose stages are twice
//   as large and whose warps an SM, not their bytes in flight, bound
//   them): 16-byte cp.async copies of the tile's span aligned down to 16
//   bytes of the FLAT buffer, so any row pitch and any start take
//   full-width loads. cp.async's source size
//   stops the copy at the row's end (len) and zero-fills the rest of the
//   chunk, and a chunk wholly outside the row reads nothing; bytes before
//   the row's start (a negative position) are zeroed after the copy
//   lands.
// - Shared memory: the product's (SplitTerms: b1 and b2), then each
//   warp's ring: the span's 16-byte chunks in rows of one symbol's bytes
//   plus 16 of pad, so the 8 symbols of an A fragment lie in 8 distinct
//   bank groups. The span starts rb bytes into its first chunk; a lane's
//   bf16 or int8 A register is 4 bytes at byte rb + 4 i (+ 16 for a2/a3) of
//   its symbol's k-step, built from the two aligned words around it with
//   one __funnelshift_r by 8 (rb mod 4) bits: no per-sample staging pass;
//   a float32 one is the two samples at rb + 8 i, rb being a multiple of 4.
//
// The warps of a block share nothing but SplitTerms' b1 and b2, staged before
// the walk behind the one __syncthreads; each warp then syncs with
// __syncwarp only.
#pragma once

#include "common.cuh"

namespace anet {
namespace demod {

constexpr int WARPS = 4;              // warps of a block
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;             // a warp's ring by default: 3 tiles in flight, one read
// The ring of the float32 walks (demod_at.cu's and demod_at_energies.cu's
// float32 buffers; decide_frame_tm.cu's float32 frames take it too). A float32 stage is twice a bf16 one (4,368 bytes at sps
// 64), and the default 4 stages left 2 blocks (8 warps) an SM at sps 64
// with 3 tiles in flight a warp, more than the card needs; 2 stages give 5
// blocks (20 warps) and took demod_at.cu's device time from 0.62 to 0.50 ms
// (H100 SXM, time_search --kernels demod, B = 8,192).
constexpr int F32_RING = 2;
constexpr int STAGE_TARGET = 2048;    // bytes of samples a tile aims at

// Tile geometry of a sample type and samples per symbol, in bytes.
template <typename T, int SPS>
struct Shape {
  static constexpr int SB = SPS * (int)sizeof(T);  // a symbol's samples
  static constexpr int CPS = SB / 16;              // 16-byte chunks a symbol
  static constexpr int WPS = SB / 4;               // 32-bit words a symbol
  static constexpr int ROW = SB + 16;              // a symbol row in shared memory, with its pad
  static constexpr int KS = SB / 32;               // k-steps: 16 bf16 or 32 int8 samples each
  static constexpr int MT = 16 * SB >= STAGE_TARGET ? 1 : STAGE_TARGET / (16 * SB);  // m16 tiles
  static constexpr int SYMS = 16 * MT;             // symbols a tile
  static constexpr int CHUNKS = SYMS * CPS + 1;    // + the chunk an offset span runs into
  static constexpr int STAGE = SYMS * ROW + 16;    // bytes of one ring stage
  static_assert(SB % 32 == 0, "a symbol must be whole k-steps");
};

template <typename T>
struct Acc;
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int32_t;
};
template <>
struct Acc<float> {  // float32 samples split into bf16 terms (decide_frame_tm.cu)
  using type = float;
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The launch: a contiguous [B, len] buffer of T, per-stream preamble
// starts, and n_symbols symbols a stream in tiles of SYMS.
struct Span {
  const unsigned char* buf;
  int64_t len;
  const int32_t* start;
  int pre;
  int n_symbols;
  int tiles;  // tiles a stream
  int items;  // B * tiles
};

// Strided rows: B rows `pitch` samples apart, of which the first len are
// read. A type of its own, so that the contiguous kernels' code stays as it
// is; `pitch` gives either's row stride.
struct PitchedSpan : Span {
  int64_t pitch;  // >= len
};

__device__ __forceinline__ int64_t pitch(const Span& sp) { return sp.len; }
__device__ __forceinline__ int64_t pitch(const PitchedSpan& sp) { return sp.pitch; }

// Item j: stream b, first symbol s0 and live symbols n of its tile, the
// tile's first sample's row position pos, and its 16-byte-aligned chunk
// in the flat buffer with the span's byte offset rb into it.
struct Tile {
  int b, s0, n, rb;
  int64_t pos;
  uintptr_t chunk0;
};

template <typename T, int SPS, typename SP>
__device__ __forceinline__ Tile locate(const SP& sp, int j) {
  using S = Shape<T, SPS>;
  Tile t;
  t.b = j / sp.tiles;
  t.s0 = (j - t.b * sp.tiles) * S::SYMS;
  t.n = min(S::SYMS, sp.n_symbols - t.s0);
  t.pos = (int64_t)sp.start[t.b] + sp.pre + (int64_t)t.s0 * SPS;
  const uintptr_t at = reinterpret_cast<uintptr_t>(sp.buf) +
                       (uintptr_t)(((int64_t)t.b * pitch(sp) + t.pos) * (int64_t)sizeof(T));
  t.rb = (int)(at & 15);
  t.chunk0 = at - t.rb;
  return t;
}

// Start the copies of item j's span into a ring stage, then commit a group
// (an empty one past the last item, so every iteration commits one).
template <typename T, int SPS, typename SP>
__device__ __forceinline__ void fetch(const SP& sp, int j, unsigned char* stage, int lane) {
  using S = Shape<T, SPS>;
  constexpr int E = 16 / (int)sizeof(T);  // samples a chunk
  if (j < sp.items) {
    const Tile t = locate<T, SPS>(sp, j);
    const int need = (t.rb + t.n * S::SB + 15) / 16;
    const int64_t p0 = t.pos - t.rb / (int)sizeof(T);  // row position of chunk 0's first sample
#pragma unroll
    for (int k = 0; k < (S::CHUNKS + 31) / 32; ++k) {
      const int c = lane + 32 * k;
      if (c < S::CHUNKS) {
        const int64_t p = p0 + (int64_t)c * E;
        const int64_t left = sp.len - p;  // samples of the row from the chunk's first on
        const int bytes =
            (c < need && p + E > 0 && left > 0) ? (int)(left < E ? left : E) * (int)sizeof(T) : 0;
        const void* src = bytes ? reinterpret_cast<const void*>(t.chunk0 + 16 * (uintptr_t)c)
                                : static_cast<const void*>(sp.buf);
        cp_async16(stage + (c / S::CPS) * S::ROW + (c % S::CPS) * 16, src, bytes);
      }
    }
  }
  cp_async_commit();
}

// A fragment of k-step ks for the m16 tile whose row 0 is `rows` (symbol g
// of the tile at rows + g * ROW), from a span of bf16 or int8 samples: word
// x0 = (rb >> 2) + lane % 4 of the symbol's span, shifted right by sh bits.
template <typename T, int SPS>
__device__ __forceinline__ void a_frag(const unsigned char* rows, int x0, int sh, int ks,
                                       uint32_t (&a)[4]) {
  using S = Shape<T, SPS>;
#pragma unroll
  for (int hk = 0; hk < 2; ++hk) {
    // word x of the symbol's span (x >= WPS: the next row, past its pad)
    const int x = x0 + 8 * ks + 4 * hk;
    const int o0 = 4 * x + (x >= S::WPS ? 16 : 0);
    const int o1 = 4 * (x + 1) + (x + 1 >= S::WPS ? 16 : 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const unsigned char* r = rows + h * 8 * S::ROW;
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(r + o0);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(r + o1);
      a[2 * hk + h] = __funnelshift_r(lo, hi, sh);
    }
  }
}

// The B operand and the product of a walk, one term: the basis of bf16 or
// int8 samples (kernels._demod_mma_basis) held in registers for the whole
// launch. energies() gives e[t][h], the energy of tone 4 t + (lane % 4) of
// tile row lane / 4 + 8 h, from the m16 tile whose row 0 is `rows`; x0 =
// (rb >> 2) + lane % 4 and sh = 8 (rb % 4) place the span in its first
// chunk.
template <typename T, int SPS, int NT_>
struct OneTerm {
  using S = Shape<T, SPS>;
  static constexpr int NT = NT_;
  static constexpr int SMEM = 0;  // shared memory it takes before the warps' rings
  uint32_t bf[S::KS][NT][2];

  __device__ __forceinline__ OneTerm(const uint32_t* __restrict__ basis, unsigned char*) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) bf[ks][t][r] = basis[((ks * NT + t) * 2 + r) * 32 + lane];
  }

  // The products of k-step ks with A fragments `a` that a walk read its own
  // way (decide_frame_tm.cu's time-major rows), into acc.
  __device__ __forceinline__ void products(int ks, int, const uint32_t (&a)[4],
                                           typename Acc<T>::type (&acc)[NT][4]) const {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma(acc[t], a, bf[ks][t][0], bf[ks][t][1]);
  }

  __device__ __forceinline__ void energies(const unsigned char* rows, int x0, int sh, int,
                                           float (&e)[NT][2]) const {
    typename Acc<T>::type acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) {
      uint32_t a[4];
      a_frag<T, SPS>(rows, x0, sh, ks, a);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma(acc[t], a, bf[ks][t][0], bf[ks][t][1]);
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      e[u][0] = tone_energy((float)acc[u][0], (float)acc[u][1]);
      e[u][1] = tone_energy((float)acc[u][2], (float)acc[u][3]);
    }
  }
};

// The bf16 pair (lo, hi) rounded to nearest in one word, lo in the low half,
// and what the rounding left of each, exact in float32.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi, float& rlo, float& rhi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  const float2 q = __bfloat1622float2(p);
  rlo = lo - q.x;
  rhi = hi - q.y;
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The A fragments of k-step ks from a span of float32 samples, split into
// three bf16 terms whose sum is each sample exactly: a0 = bf16(x), a1 =
// bf16(x - a0), a2 = bf16(x - a0 - a1). x0 = (rb >> 2) + 2 (lane % 4): the
// two samples of a lane's register are two words.
template <int SPS>
__device__ __forceinline__ void a_split(const unsigned char* rows, int x0, int ks, uint32_t (&a0)[4],
                                        uint32_t (&a1)[4], uint32_t (&a2)[4]) {
  using S = Shape<float, SPS>;
#pragma unroll
  for (int hk = 0; hk < 2; ++hk) {
    // samples x and x + 1 of the symbol's span (x >= WPS: the next row)
    const int x = x0 + 16 * ks + 8 * hk;
    const int o0 = 4 * x + (x >= S::WPS ? 16 : 0);
    const int o1 = 4 * (x + 1) + (x + 1 >= S::WPS ? 16 : 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const unsigned char* r = rows + h * 8 * S::ROW;
      float lo = *reinterpret_cast<const float*>(r + o0);
      float hi = *reinterpret_cast<const float*>(r + o1);
      a0[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
      a1[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
      a2[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
    }
  }
}

// The B operand and the product of a walk for float32 compute (and, through
// its constructor and six_products, of decide_frame_tm.cu's float32 frames):
// the float32 basis as three bf16 terms, b = b0 + b1 + b2 exactly
// (kernels._demod_split_basis: int32 [3, ks, n, 2, 32], each term in
// OneTerm's fragment order). b0 stays in registers; b1 and b2 are staged
// once a block in shared memory, a lane's four words of a (k-step, n-tile)
// one 16-byte vector. T is the staged sample type: bf16 rows are exact in
// bf16 and meet all three terms (3 products a k-step and n-tile); float32
// rows are split in registers (a_split) and keep the six products
// a_i b_j with i + j <= 2 (the three dropped are below 2^-24 |a| |b|).
// Every product is exact in float32. The tensor cores align a sum's
// addends to its largest and truncate the rest, so a0 b0 sums in an
// accumulator of its own and the smaller products in a second one,
// smallest first; the two add on the CUDA cores before the energy. (Adding
// each k-step's a0 b0 from zero into a float32 sum on the CUDA cores
// instead left the errors against the plain version of the same size on
// the H100, whose own float32 rounding is as large, and was slower.)
template <typename T, int SPS, int NT_>
struct SplitTerms {
  static_assert(std::is_same<T, __nv_bfloat16>::value || std::is_same<T, float>::value,
                "the split route takes bf16 or float32 samples");
  using S = Shape<T, SPS>;
  static constexpr int NT = NT_;
  static constexpr int KS = SPS / 16;                 // m16n8k16 k-steps a symbol
  static constexpr int SMEM = KS * NT * 32 * 16;      // b1 and b2
  uint32_t b0[KS][NT][2];
  const uint4* b12;

  __device__ __forceinline__ SplitTerms(const uint32_t* __restrict__ basis, unsigned char* smem) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) b0[ks][t][r] = basis[((ks * NT + t) * 2 + r) * 32 + lane];
    uint4* s = reinterpret_cast<uint4*>(smem);
    const uint32_t* t1 = basis + KS * NT * 64;
    const uint32_t* t2 = t1 + KS * NT * 64;
    for (int j = threadIdx.x; j < KS * NT * 32; j += THREADS) {
      const int w = (j >> 5) * 64 + (j & 31);  // (k-step, n-tile) j / 32, lane j % 32, register 0
      s[j] = make_uint4(t1[w], t1[w + 32], t2[w], t2[w + 32]);
    }
    __syncthreads();  // the only block-wide sync: before any warp's walk
    b12 = s;
  }

  __device__ __forceinline__ void energies(const unsigned char* rows, int x0, int sh, int lane,
                                           float (&e)[NT][2]) const {
    float big[NT][4], small[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) big[t][c] = small[t][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (std::is_same<T, float>::value) {
        uint32_t a0[4], a1[4], a2[4];
        a_split<SPS>(rows, x0 + (lane & 3), ks, a0, a1, a2);
        six_products(ks, lane, a0, a1, a2, big, small);
      } else {
        uint32_t a[4];
        a_frag<T, SPS>(rows, x0, sh, ks, a);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint4 v = b12[(ks * NT + t) * 32 + lane];
          mma(small[t], a, v.z, v.w);  // a b2, about 2^-16 |a| |b|
          mma(small[t], a, v.x, v.y);  // a b1, about 2^-8
          mma(big[t], a, b0[ks][t][0], b0[ks][t][1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      e[u][0] = tone_energy(big[u][0] + small[u][0], big[u][1] + small[u][1]);
      e[u][1] = tone_energy(big[u][2] + small[u][2], big[u][3] + small[u][3]);
    }
  }

  // The six products of k-step ks of float32 samples split into a0 + a1 +
  // a2, whichever walk read them (a_split's span rows here, the time-major
  // rows of decide_frame_tm.cu): a0 b0 into big, the rest into small,
  // smallest first.
  __device__ __forceinline__ void six_products(int ks, int lane, const uint32_t (&a0)[4],
                                               const uint32_t (&a1)[4], const uint32_t (&a2)[4],
                                               float (&big)[NT][4], float (&small)[NT][4]) const {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint4 v = b12[(ks * NT + t) * 32 + lane];
      mma(small[t], a2, b0[ks][t][0], b0[ks][t][1]);  // about 2^-16 |a| |b| each
      mma(small[t], a1, v.x, v.y);
      mma(small[t], a0, v.z, v.w);
      mma(small[t], a1, b0[ks][t][0], b0[ks][t][1]);  // about 2^-8
      mma(small[t], a0, v.x, v.y);
      mma(big[t], a0, b0[ks][t][0], b0[ks][t][1]);
    }
  }
};

// The B operand and the product at 8 n-tiles (17 to 32 tones: the
// batch-major filterbank and decide_frame_tm.cu's decide_tones_tm; the
// align+demod kernels and decide_frame_tm refuse more than 16): OneTerm's
// product (TERMS 1: bf16 samples, the bf16 basis of
// kernels._demod_mma_basis) or SplitTerms' (TERMS 3: the float32 basis as
// three bf16 terms, kernels._demod_split_basis, on bf16 or float32
// samples), their products in the same order, so the same sums. Every term
// is staged once a block in shared memory: held in registers, b0 alone
// would take 2 x KS x 8 words a lane (80 at sps 80, 128 at sps 128) beside
// 32 accumulators (one term) or 64 (the split). A lane's words of a
// (k-step, n-tile) are one 8-byte vector of b0 and, split, one 16-byte
// vector of b1 and b2, which it reads once a k-step for the 16 rows of
// its m16 tile. products and six_products take the A fragments of a walk
// that reads them its own way, as OneTerm's and SplitTerms' do.
template <typename T, int SPS, int NT_, int TERMS>
struct SharedTerms {
  static_assert(TERMS == 1 || TERMS == 3, "one term, or the three-term split");
  static_assert(std::is_same<T, __nv_bfloat16>::value || (TERMS == 3 && std::is_same<T, float>::value),
                "bf16 samples, or float32 samples under the split");
  static constexpr int NT = NT_;
  static constexpr int KS = SPS / 16;                  // m16n8k16 k-steps a symbol
  static constexpr int B0_BYTES = KS * NT * 32 * 8;    // b0
  static constexpr int SMEM = B0_BYTES + (TERMS == 3 ? KS * NT * 32 * 16 : 0);  // + b1 and b2
  const uint2* b0;
  const uint4* b12;

  __device__ __forceinline__ SharedTerms(const uint32_t* __restrict__ basis, unsigned char* smem) {
    uint2* s0 = reinterpret_cast<uint2*>(smem);
    uint4* s12 = reinterpret_cast<uint4*>(smem + B0_BYTES);
    const uint32_t* t1 = basis + KS * NT * 64;
    const uint32_t* t2 = t1 + KS * NT * 64;
    for (int j = threadIdx.x; j < KS * NT * 32; j += THREADS) {
      const int w = (j >> 5) * 64 + (j & 31);  // (k-step, n-tile) j / 32, lane j % 32, register 0
      s0[j] = make_uint2(basis[w], basis[w + 32]);
      if constexpr (TERMS == 3) s12[j] = make_uint4(t1[w], t1[w + 32], t2[w], t2[w + 32]);
    }
    __syncthreads();  // the only block-wide sync: before any warp's walk
    b0 = s0;
    b12 = s12;
  }

  // TERMS 1: OneTerm's products of k-step ks of bf16 samples, into big.
  __device__ __forceinline__ void products(int ks, int lane, const uint32_t (&a)[4],
                                           float (&big)[NT][4]) const {
    static_assert(TERMS == 1, "the one-term basis");
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint2 u = b0[(ks * NT + t) * 32 + lane];
      mma(big[t], a, u.x, u.y);
    }
  }

  // TERMS 3: SplitTerms' six products of k-step ks of float32 samples split
  // into a0 + a1 + a2: a0 b0 into big, the rest into small, smallest first.
  __device__ __forceinline__ void six_products(int ks, int lane, const uint32_t (&a0)[4],
                                               const uint32_t (&a1)[4], const uint32_t (&a2)[4],
                                               float (&big)[NT][4], float (&small)[NT][4]) const {
    static_assert(TERMS == 3, "the three-term split");
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint2 u = b0[(ks * NT + t) * 32 + lane];
      const uint4 v = b12[(ks * NT + t) * 32 + lane];
      mma(small[t], a2, u.x, u.y);  // about 2^-16 |a| |b| each
      mma(small[t], a1, v.x, v.y);
      mma(small[t], a0, v.z, v.w);
      mma(small[t], a1, u.x, u.y);  // about 2^-8
      mma(small[t], a0, v.x, v.y);
      mma(big[t], a0, u.x, u.y);
    }
  }

  __device__ __forceinline__ void energies(const unsigned char* rows, int x0, int sh, int lane,
                                           float (&e)[NT][2]) const {
    float big[NT][4], small[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) big[t][c] = small[t][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (std::is_same<T, float>::value) {
        uint32_t a0[4], a1[4], a2[4];
        a_split<SPS>(rows, x0 + (lane & 3), ks, a0, a1, a2);
        six_products(ks, lane, a0, a1, a2, big, small);
      } else {
        uint32_t a[4];
        a_frag<T, SPS>(rows, x0, sh, ks, a);
        if constexpr (TERMS == 3) {  // SplitTerms' three products of bf16 samples
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint2 u = b0[(ks * NT + t) * 32 + lane];
            const uint4 v = b12[(ks * NT + t) * 32 + lane];
            mma(small[t], a, v.z, v.w);  // a b2, about 2^-16 |a| |b|
            mma(small[t], a, v.x, v.y);  // a b1, about 2^-8
            mma(big[t], a, u.x, u.y);
          }
        } else {
          products(ks, lane, a, big);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      if constexpr (TERMS == 1) {  // OneTerm's energies of its one accumulator
        e[u][0] = tone_energy(big[u][0], big[u][1]);
        e[u][1] = tone_energy(big[u][2], big[u][3]);
      } else {
        e[u][0] = tone_energy(big[u][0] + small[u][0], big[u][1] + small[u][1]);
        e[u][1] = tone_energy(big[u][2] + small[u][2], big[u][3] + small[u][3]);
      }
    }
  }
};

// Every warp of the grid walks items blockIdx.x * WARPS + warp, + the
// grid's warp count, ...; for each m16 tile of an item with live symbols
// it calls epi(b, s, e): e[t][h] is the energy of tone 4 t + (lane % 4) of
// symbol s + lane / 4 + 8 h of stream b (s + ... may pass n_symbols: the
// epilogue masks). P is the B operand and product (OneTerm, SplitTerms)
// over the staged samples of type T; its shared memory comes first, then
// each warp's ring of RING stages.
template <typename T, int SPS, typename P, int RING = STAGES, typename SP, typename Epilogue>
__device__ __forceinline__ void walk_with(const SP& sp, const uint32_t* __restrict__ basis,
                                          Epilogue&& epi) {
  using S = Shape<T, SPS>;
  static_assert(RING >= 2, "a ring holds the tile read and one in flight");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i = lane & 3;
  unsigned char* ring = smem + P::SMEM + warp * (RING * S::STAGE);
  const P prod(basis, smem);

  const int step = gridDim.x * WARPS;
  int j = blockIdx.x * WARPS + warp;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) fetch<T, SPS>(sp, j + s * step, ring + s * S::STAGE, lane);
  for (int it = 0; j < sp.items; j += step, ++it) {
    fetch<T, SPS>(sp, j + (RING - 1) * step, ring + ((it + RING - 1) % RING) * S::STAGE, lane);
    cp_async_wait<RING - 1>();
    __syncwarp();
    unsigned char* stage = ring + (it % RING) * S::STAGE;
    const Tile t = locate<T, SPS>(sp, j);
    if (t.pos < 0) {  // zero the span's bytes before the row's start
      const int64_t before = t.rb - t.pos * (int64_t)sizeof(T);
      const int z = before < S::CHUNKS * 16 ? (int)before : S::CHUNKS * 16;
      for (int y = lane; y < z; y += 32) stage[(y / S::SB) * S::ROW + y % S::SB] = 0;
      __syncwarp();
    }
    const int x0 = (t.rb >> 2) + i;
    const int sh = 8 * (t.rb & 3);
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) {
      if (16 * mt < t.n) {
        float e[P::NT][2];
        prod.energies(stage + (16 * mt + g) * S::ROW, x0, sh, lane, e);
        epi(t.b, t.s0 + 16 * mt, e);
      }
    }
    __syncwarp();  // the stage is read: the next iteration's copies may land in it
  }
  cp_async_wait<0>();
}

// walk_with the one-term product: bf16 or int8 samples, the basis of
// kernels._demod_mma_basis.
template <typename T, int SPS, int NT, typename SP, typename Epilogue>
__device__ __forceinline__ void walk(const SP& sp, const uint32_t* __restrict__ basis,
                                     Epilogue&& epi) {
  walk_with<T, SPS, OneTerm<T, SPS, NT>>(sp, basis, epi);
}

// walk's two epilogues, shared by every kernel that runs it.
//
// store_decisions: (tone, best, total) of each symbol, [B, n_symbols] each.
// Each lane takes the argmax (first index on ties), best and sum of its
// tones over its n-tiles, then the quad's with two xor shuffles; lanes 0
// and 1 of each quad store symbols g and g + 8, so each store of a warp
// covers 16 consecutive symbols.
template <int NT>
__device__ __forceinline__ void store_decisions(int b, int s, const float (&e)[NT][2],
                                                int n_symbols, int32_t* tone, float* best,
                                                float* total) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, i = lane & 3;
  float bq[2], tot[2];
  int bt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bq[h] = e[0][h];
    bt[h] = i;
    tot[h] = e[0][h];
#pragma unroll
    for (int u = 1; u < NT; ++u) {
      if (e[u][h] > bq[h]) {  // tones rise with u: a tie keeps the first
        bq[h] = e[u][h];
        bt[h] = 4 * u + i;
      }
      tot[h] += e[u][h];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float oq = __shfl_xor_sync(0xffffffffu, bq[h], off);
      const int ot = __shfl_xor_sync(0xffffffffu, bt[h], off);
      tot[h] += __shfl_xor_sync(0xffffffffu, tot[h], off);
      if (better(oq, ot, bq[h], bt[h])) {
        bq[h] = oq;
        bt[h] = ot;
      }
    }
  }
  const int sym = s + g + 8 * i;  // lane i < 2 of the quad stores its row i
  if (i < 2 && sym < n_symbols) {
    const int64_t o = (int64_t)b * n_symbols + sym;
    tone[o] = i ? bt[1] : bt[0];
    best[o] = i ? bq[1] : bq[0];
    total[o] = i ? tot[1] : tot[0];
  }
}

// store_energies: every tone's energy, [B, n_symbols, m]. Lane i of a quad
// stores tone 4 t + i of n-tile t; the 8 rows of a fragment half are
// consecutive symbols, so at m = 4 a warp's store is 128 contiguous bytes.
template <int NT>
__device__ __forceinline__ void store_energies(int b, int s, const float (&e)[NT][2],
                                               int n_symbols, int m, float* energies) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, i = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sym = s + g + 8 * h;
    if (sym < n_symbols) {
      float* o = energies + ((int64_t)b * n_symbols + sym) * m;
#pragma unroll
      for (int u = 0; u < NT; ++u)
        if (4 * u + i < m) o[4 * u + i] = e[u][h];
    }
  }
}

// The span and grid of a launch: the stream's tiles and items, one block
// per WARPS items at most and no more blocks than fit the card at once
// (the warps walk the rest). `resident` is the caller's cache of that
// count, one per kernel: 0 on the first call, which also sets the kernel's
// dynamic shared memory limit. SMEM: the kernel's shared memory.
template <typename T, int SPS, int SMEM, typename Kernel>
inline cudaError_t plan(Kernel kernel, int& resident, const void* buf, int B, long long len,
                        const void* start, int pre, int n_symbols, Span& sp, int& grid) {
  using S = Shape<T, SPS>;
  const int tiles = (n_symbols + S::SYMS - 1) / S::SYMS;
  const long long items = (long long)B * tiles;
  if (items > (1LL << 30)) return cudaErrorInvalidValue;  // the walk counts items in int
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  sp = Span{static_cast<const unsigned char*>(buf), len, static_cast<const int32_t*>(start), pre,
            n_symbols, tiles, (int)items};
  const int blocks = (int)((items + WARPS - 1) / WARPS);
  grid = blocks < resident ? blocks : resident;
  return cudaSuccess;
}

// plan, then launch `kernel` (whose first argument is the Span, or the
// PitchedSpan of rows `pitch` samples apart) with `args` on stream st.
// `resident` as plan takes it: a static of the caller's, one per kernel
// instantiation; EXTRA the shared memory of its product before the rings,
// RING the walk's ring depth (walk_with's).
template <typename T, int SPS, int EXTRA = 0, int RING = STAGES, typename SP, typename... KArgs,
          typename... Args>
inline cudaError_t launch(void (*kernel)(SP, KArgs...), int& resident, const void* buf, int B,
                          long long pitch, long long len, const void* start, int pre,
                          int n_symbols, cudaStream_t st, Args... args) {
  SP sp;
  int grid = 0;
  constexpr int smem = WARPS * RING * Shape<T, SPS>::STAGE + EXTRA;
  const cudaError_t err =
      plan<T, SPS, smem>(kernel, resident, buf, B, len, start, pre, n_symbols, sp, grid);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<SP, PitchedSpan>::value) {
    if (pitch < len) return cudaErrorInvalidValue;
    sp.pitch = pitch;
  } else if (pitch != len) {
    return cudaErrorInvalidValue;  // a Span's rows are back to back
  }
  kernel<<<grid, THREADS, smem, st>>>(sp, args...);
  return cudaGetLastError();
}

}  // namespace demod
}  // namespace anet
