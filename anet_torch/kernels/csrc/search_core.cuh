// The acquisition search's product on the tensor cores, shared by
// sync_search.cu and search_blockmax.cu so that both compute every
// |corr| * scale bit for bit alike (the block maxima's maximum is the
// search's best), and by correlate.cu, which writes corr out (store_rows)
// and stages no energies.
//
// For lag l = 128 m + n of a stream's segment seg (the row m, the column n):
//   corr[128 m + n] = sum_p A[m, p] * T[p, n],   A[m, p] = seg[128 m + p],
//                                               T[p, n] = t[p - n] (0 <= p - n < k)
// an [M, K] x [K, 128] product with K = k + 127 (padded to 16), A a Hankel
// view of the segment (rows 128 samples apart) and T the banded Toeplitz
// template of anet.dsp.sync.banded_template. The window energy, and so the
// quality scale, is one value per row: rows are the 128-lag blocks of
// blockwise_match_quality.
//
// A block takes mt rows of one stream (a multiple of 16; at most 128, or 96
// where an operand is float32: see max_regs); warp w the 16 rows 16w ..
// 16w + 15, all 128 columns (16 n8 tiles). Per step of 16 along p, a warp
// issues one ldmatrix.x4 for its A fragment and 16 mma.sync.m16n8k16 (bf16
// in, float32 accumulators).
//
// - A: the block stages its span of the segment once as bf16, 128 samples
//   to a row of ROW_PITCH = 136 (8 of pad): every A row starts on a 16-byte
//   boundary, and the 8 rows an ldmatrix phase reads lie 272 bytes apart,
//   in 8 distinct bank groups. Samples load one at a time (zero past
//   seg_len), so a segment that starts at any sample and rows at any stride
//   need no aligned copy. The block energies come from the same loads.
// - B: the B fragment of n8 tile j at step s is (H(16s - 8j), H(16s - 8j +
//   8)), where H(e) is this lane's pair (t[e + 2i - g], t[e + 2i + 1 - g])
//   (g = lane / 4, i = lane % 4). So the 16 tiles of a step read 17 pairs,
//   and the next step reuses 15 of them: a lane keeps 17 registers and
//   loads 2 words a step. The pairs come from two copies of the zero-padded
//   template in shared memory, the second shifted by one sample, so every
//   pair is one aligned 32-bit word (the wrapper builds them once a
//   template: kernels._search_template_words). The copies lie W words apart,
//   W = 16 mod 32: the 32 lanes' words fall in distinct banks or coincide.
// - float32 operands split into bf16 hi + lo, lo = bf16(x - hi); the
//   products hi*hi, hi*lo and lo*hi accumulate in the same registers: one
//   mma per tile and step for bf16 x bf16, two for bf16 x float32, three
//   for float32 x float32. There is no CUDA-core product.
//
// A template too long for the one-shot stage (make_geometry false: the two
// copies and the whole span pass the shared memory a block holds; about
// 14,400 samples for float32 x float32, 33,000 for bf16 x bf16) takes the
// slab route (make_slab_geometry, slab_rows): the band's k-steps in slabs
// of ksl (a multiple of 8, so a slab's span starts on a staged row), sized
// so that two blocks share a multiprocessor (SLAB_SMEM each; one block
// takes all of it only where two cannot fit). A slab warp walks 16 rows x
// 64 lags (half a row of n8 tiles; two warps a row group, 64 rows and 8
// warps a block), so that its accumulators and their float32 sum take 32
// registers each: the tensor cores truncate what they add to an
// accumulator, which over thousands of k-steps (3,848 at 61,440 samples)
// drifts by about 2^-23 of the sum a step, so the route adds its
// accumulators into the float32 sum on the CUDA cores every FOLD k-steps
// (counted from the walk's start) and starts them again from zero. A lane
// then holds at most 128 registers, and two blocks of 8 warps fit a
// multiprocessor. The span rows live in a ring of rr slots that covers a
// slab and the next one: each slab stages only the ksl / 8 rows it adds,
// and the next slab's rows (float32 samples by cp.async, split into hi and
// lo at the slab's end) and its window of the template words (8 ksl + 72
// of each copy, cp.async, zero past the band) are staged while this slab's
// products run, under one __syncthreads a slab. The lane's B ring runs on
// across slabs. Within a k-step a warp issues its 8 tiles' hi*hi, then
// hi*lo, then lo*hi products: each accumulator keeps its order, with 8
// independent products between two that depend on each other. The 128-
// sample block energies are computed once, before the first slab, from the
// same loads and in the same order as the one-shot stage, so the window
// sums and scales are its bits. After the walk the warps gather their sums
// in shared memory, and the first mt / 16 warps take whole rows through the
// one-shot route's epilogues.
#pragma once

#include "common.cuh"

namespace anet {
namespace search {

constexpr int ROW = 128;            // lags per row = samples per energy block
constexpr int ROW_PITCH = ROW + 8;  // a staged row in shared memory, in samples
constexpr int WARP_ROWS = 16;       // rows of one warp: one m16 tile
constexpr int MAX_WARPS = 8;
// Registers: a multiprocessor's four sub-partitions hold 16,384 each, and a
// warp takes all its registers from one. At <= 128 a thread, 4 warps fit a
// sub-partition, so two blocks of up to 8 warps share a multiprocessor; at
// <= 168 (the float32 halves' extra fragments), 3: two blocks of up to 6.
template <bool A_LO, bool B_LO>
constexpr int max_regs() { return A_LO || B_LO ? 168 : 128; }
constexpr int max_warps(bool a_lo, bool b_lo) { return a_lo || b_lo ? 6 : MAX_WARPS; }
constexpr int NT = ROW / 8;         // n8 tiles across a row
constexpr int TPL_OFF = 128;        // template sample j lies at copy position j + TPL_OFF
constexpr int MAX_SMEM = 232448;    // bytes of shared memory a block can have on sm_90

struct Geometry {
  int64_t row_stride;  // elements between rows of seg
  int seg_len;
  int out_len;
  int n_rows;   // rows of a stream: ceil(out_len / 128)
  int k;
  int nks;      // steps of 16 along p: ceil((k + 127) / 16)
  int kb;       // energy blocks of a window: ceil(k / 128) + 1
  int mt;       // rows of a block
  int n_tiles;  // blocks of a stream
  int nb;       // 128-sample blocks a block stages
  int w;        // words of a template copy
  float te;     // template energy, where te_ptr is null
  const float* te_ptr;  // the template energy on the card, or null
};

// The geometry of a launch, or false where the kernel does not take it (a
// template word count the wrapper did not build for this k, or a template
// too long for shared memory). Rows are split evenly over the fewest blocks
// of at most max_warps * 16 rows, rounded up to whole warps.
inline bool make_geometry(Geometry& g, int64_t row_stride, int seg_len, int out_len, int k, int w,
                          float te, bool a_lo, bool b_lo, size_t& smem) {
  if (k < 1 || out_len < 1) return false;
  g.row_stride = row_stride;
  g.seg_len = seg_len;
  g.out_len = out_len;
  g.k = k;
  g.te = te;
  g.te_ptr = nullptr;
  g.n_rows = (out_len + ROW - 1) / ROW;
  const int max_rows = max_warps(a_lo, b_lo) * WARP_ROWS;
  g.n_tiles = (g.n_rows + max_rows - 1) / max_rows;
  const int per = (g.n_rows + g.n_tiles - 1) / g.n_tiles;
  g.mt = (per + WARP_ROWS - 1) / WARP_ROWS * WARP_ROWS;
  g.nks = (k + ROW - 1 + 15) / 16;
  g.kb = (k + ROW - 1) / ROW + 1;
  const int nb_a = g.mt - 1 + (16 * g.nks + ROW - 1) / ROW;  // the A rows' samples
  const int nb_e = g.mt + g.kb - 1;                          // the rows' energy windows
  g.nb = nb_a > nb_e ? nb_a : nb_e;
  g.w = w;
  if (w < 8 * g.nks + 72 || w % 32 != 16) return false;
  smem = (size_t)(b_lo ? 2 : 1) * 2 * w * 4 + (size_t)(a_lo ? 2 : 1) * g.nb * ROW_PITCH * 2 +
         (size_t)(g.nb + g.mt) * 4;
  return smem <= (size_t)MAX_SMEM;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of a block: the template words, the staged span (hi, then
// lo for float32 samples), the block energies, one scale a row.
struct Smem {
  uint32_t* tpl;
  __nv_bfloat16* hi;
  __nv_bfloat16* lo;
  float* blk;
  float* scale;
};

template <bool A_LO, bool B_LO>
__device__ __forceinline__ Smem carve(unsigned char* base, const Geometry& g) {
  Smem s;
  s.tpl = reinterpret_cast<uint32_t*>(base);
  s.hi = reinterpret_cast<__nv_bfloat16*>(s.tpl + (B_LO ? 2 : 1) * 2 * g.w);
  s.lo = s.hi + g.nb * ROW_PITCH;
  s.blk = reinterpret_cast<float*>(s.hi + (A_LO ? 2 : 1) * g.nb * ROW_PITCH);
  s.scale = s.blk + g.nb;
  return s;
}

// Stage the template words and the tile's span, then (ENERGY) one scale a
// row:
//   scale[r] = rsqrt(te * max(win[r], 1e-4 te)),
//   win[r] = sum of the energies of blocks r .. r + kb - 1
// (blocks relative to the segment's start, zero past its end), as
// blockwise_match_quality's superset window, te read through g.te_ptr
// where it is not null (the wrapper passes a tensor's address: no host
// read), else g.te. Ends with __syncthreads().
template <typename T, bool B_LO, bool ENERGY = true>
__device__ __forceinline__ void stage(const T* __restrict__ seg, const uint32_t* __restrict__ tpl,
                                      const Geometry& g, int b, int tile, const Smem& s) {
  constexpr bool A_LO = std::is_same<T, float>::value;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n_vec = (B_LO ? 2 : 1) * 2 * g.w / 4;
  for (int i = tid; i < n_vec; i += nthreads)
    reinterpret_cast<uint4*>(s.tpl)[i] = reinterpret_cast<const uint4*>(tpl)[i];

  const T* row = seg + (int64_t)b * g.row_stride;
  const int64_t base = (int64_t)tile * g.mt * ROW;
  const int n_chunks = g.nb * (ROW / 8);  // 8 samples a chunk, 16 a block
  for (int c0 = 0; c0 < n_chunks; c0 += nthreads) {
    const int c = c0 + tid;
    const bool live = c < n_chunks;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = live ? load_or_zero(row, base + 8 * c + j, g.seg_len) : 0.0f;
    float e = 0.0f;
    if (ENERGY) {
#pragma unroll
      for (int j = 0; j < 8; ++j) e = fmaf(v[j], v[j], e);
      // the 16 chunks of a block lie in 16 lanes of one warp (c0 and the
      // block size are multiples of 32)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off, 16);
    }
    if (live) {
      const int at = (c >> 4) * ROW_PITCH + 8 * (c & 15);
      uint4 hi, lo;
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
        if (A_LO) {
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&h[j]);
          l[j] = pack_bf16(v[2 * j] - __low2float(hv), v[2 * j + 1] - __high2float(hv));
        }
      }
      *reinterpret_cast<uint4*>(s.hi + at) = hi;
      if (A_LO) *reinterpret_cast<uint4*>(s.lo + at) = lo;
      if (ENERGY && (c & 15) == 0) s.blk[c >> 4] = e;
    }
  }
  __syncthreads();
  if (ENERGY) {
    const float te = g.te_ptr ? __ldg(g.te_ptr) : g.te;
    for (int r = tid; r < g.mt; r += nthreads) {
      float win = 0.0f;
      for (int q = 0; q < g.kb; ++q) win += s.blk[r + q];
      s.scale[r] = rsqrtf(te * fmaxf(win, 1e-4f * te));
    }
    __syncthreads();
  }
}

// This warp's 16 rows times the band: acc[j] is n8 tile j's accumulator
// fragment (rows lane/4 and lane/4 + 8, columns 8j + 2 (lane%4) + {0, 1}).
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void product(const Geometry& g, const Smem& s, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, gi = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // ldmatrix: lane supplies row (lane & 7) + 8 (bit 3 of lane) of the m16
  // tile at p offset 8 (bit 4 of lane): a0..a3 in mma's order
  const int a_row = warp * WARP_ROWS + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 8;
  const uint32_t a_hi = smem_addr(s.hi + a_row * ROW_PITCH);
  const uint32_t a_lo = smem_addr(s.lo + a_row * ROW_PITCH);
  // H(e) of this lane is word tb[e / 2] (copy gq & 1)
  const uint32_t* tb = s.tpl + (gq & 1) * g.w + TPL_OFF / 2 + gi - (gq >> 1);
  const uint32_t* tl = tb + 2 * g.w;
  uint32_t rh[NT + 1], rl[NT + 1];  // rh[u] = H(16 s + 8 - 8 u)
#pragma unroll
  for (int u = 0; u <= NT; ++u) {
    rh[u] = tb[4 - 4 * u];
    if (B_LO) rl[u] = tl[4 - 4 * u];
  }
  for (int st = 0; st < g.nks; ++st) {
    const int pk = 16 * st + a_k;
    const uint32_t off = 2u * (uint32_t)(pk + 8 * (pk >> 7));  // bytes: 8 samples of pad a row
    uint32_t ah[4], al[4];
    ldmatrix_x4(ah, a_hi + off);
    if (A_LO) ldmatrix_x4(al, a_lo + off);
    const uint32_t nh0 = tb[8 * st + 12], nh1 = tb[8 * st + 8];  // the next step's two words
    uint32_t nl0 = 0, nl1 = 0;
    if (B_LO) {
      nl0 = tl[8 * st + 12];
      nl1 = tl[8 * st + 8];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_bf16(acc[j], ah, rh[j + 1], rh[j]);
      if (B_LO) mma_bf16(acc[j], ah, rl[j + 1], rl[j]);
      if (A_LO) mma_bf16(acc[j], al, rh[j + 1], rh[j]);
    }
#pragma unroll
    for (int u = NT; u >= 2; --u) {
      rh[u] = rh[u - 2];
      if (B_LO) rl[u] = rl[u - 2];
    }
    rh[0] = nh0;
    rh[1] = nh1;
    if (B_LO) {
      rl[0] = nl0;
      rl[1] = nl1;
    }
  }
}

// The quality |corr| * scale of each lag of this lane's two rows (h = 0:
// row lane/4 of the warp, h = 1: row lane/4 + 8), and each row's maximum
// with its first column, the same in the row's 4 lanes. Lags at or past
// out_len (rows past the stream's end) read -1 at column 128.
__device__ __forceinline__ void row_best(const Geometry& g, const Smem& s, int tile,
                                         const float (&acc)[NT][4], float (&bq)[2],
                                         int (&bc)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, gi = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * WARP_ROWS + gq + 8 * h;
    const int m = tile * g.mt + r;
    const int n_cols = min(max(g.out_len - m * ROW, 0), ROW);
    const float sc = s.scale[r];
    float q_best = -1.0f;
    int c_best = ROW;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * gi + e;
        const float q = fabsf(acc[j][2 * h + e]) * sc;
        if (col < n_cols && q > q_best) {
          q_best = q;
          c_best = col;
        }
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float oq = __shfl_xor_sync(0xffffffffu, q_best, off);
      const int oc = __shfl_xor_sync(0xffffffffu, c_best, off);
      if (better(oq, oc, q_best, c_best)) {
        q_best = oq;
        c_best = oc;
      }
    }
    bq[h] = q_best;
    bc[h] = c_best;
  }
}

// The accumulators of this warp's 16 rows as they are: lag 128 m + n of
// stream b at out[b * out_len + 128 m + n], masked at out_len. A lane's
// fragment is two floats of rows lane/4 and lane/4 + 8, so the 4 lanes of a
// quad fill one 32-byte sector (one float2 store each where the stream's
// row of out starts on an even float).
__device__ __forceinline__ void store_rows(const Geometry& g, int b, int tile,
                                           const float (&acc)[NT][4], float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, gi = lane & 3;
  const int64_t row0 = (int64_t)b * g.out_len;
  const bool pairs = (row0 & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = tile * g.mt + warp * WARP_ROWS + gq + 8 * h;
    const int n_cols = min(max(g.out_len - m * ROW, 0), ROW);
    float* o = out + row0 + (int64_t)m * ROW;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * gi;
      if (pairs && col + 1 < n_cols) {
        *reinterpret_cast<float2*>(o + col) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        if (col < n_cols) o[col] = acc[j][2 * h];
        if (col + 1 < n_cols) o[col + 1] = acc[j][2 * h + 1];
      }
    }
  }
}

// One block's rows of stream b: each of this lane's two rows' maximum
// quality and its first column (see row_best).
template <typename T, bool B_LO>
__device__ __forceinline__ void tile_rows(const T* __restrict__ seg,
                                          const uint32_t* __restrict__ tpl, const Geometry& g,
                                          int b, int tile, unsigned char* smem, float (&bq)[2],
                                          int (&bc)[2]) {
  constexpr bool A_LO = std::is_same<T, float>::value;
  const Smem s = carve<A_LO, B_LO>(smem, g);
  stage<T, B_LO>(seg, tpl, g, b, tile, s);
  float acc[NT][4];
  product<A_LO, B_LO>(g, s, acc);
  row_best(g, s, tile, acc, bq, bc);
}

// --- the slab route: templates past the one-shot stage ------------------------

constexpr int FOLD = 32;        // k-steps between the slab route's folds into its float32 sum
constexpr int SLAB_NTW = NT / 2;  // n8 tiles a slab warp walks: half a row, 64 lags
constexpr int SLAB_WARPS = MAX_WARPS;  // two a row group of 16: 64 rows a block
// A block's dynamic shared memory where two blocks share a multiprocessor:
// its 233,472 bytes less the 1,024 the card reserves for each block,
// halved, less the search's static block_best arrays (2 MAX_WARPS words).
constexpr int SLAB_SMEM = (233472 - 2 * 1024) / 2 - 2 * MAX_WARPS * 4;

// The slab route's geometry: the one-shot fields (with its own row split),
// and the slab's.
struct SlabGeometry : Geometry {
  int warps;    // warps of a block: two a row group
  int n_steps;  // k-steps walked: nks rounded up to 8 (the staged words past the band are zero)
  int ksl;      // k-steps of a slab, a multiple of 8, at most 16 a warp (a chunk a thread a slab)
  int ws;       // words of a staged template copy: 8 ksl + 80, 16 mod 32
  int rr;       // slots of the span ring: mt - 1 + ksl / 4 rounded up to 8
  int nbe;      // the block energies of a block's rows: mt + kb - 1
};

inline int block_threads(const Geometry& g) { return g.mt / WARP_ROWS * 32; }
inline int block_threads(const SlabGeometry& g) { return g.warps * 32; }

// The ring's slots: a slab's mt - 1 + ksl / 8 rows and the next slab's
// ksl / 8, rounded up to 8 so that the 8 rows an ldmatrix phase reads fall
// in distinct bank groups across the wrap.
inline int slab_ring_rows(int mt, int ksl) { return (mt - 1 + ksl / 4 + 7) / 8 * 8; }

// A slab block's shared memory: two template windows, the ring (hi, then
// lo for float32 samples), float32 samples on their way to the ring (the
// next slab's ksl / 8 rows), then, over all of these once the walk is
// done, the float32 sums of the rows (mt x 128); the block energies, one
// scale a row.
inline size_t slab_smem(const SlabGeometry& g, int ksl, bool a_lo, bool b_lo) {
  const size_t sums = (size_t)g.mt * ROW * 4;
  const size_t walk = (size_t)2 * (b_lo ? 4 : 2) * (8 * ksl + 80) * 4 +
                      (size_t)(a_lo ? 2 : 1) * slab_ring_rows(g.mt, ksl) * ROW_PITCH * 2 +
                      (a_lo ? (size_t)ksl / 8 * ROW * 4 : 0);
  return (sums > walk ? sums : walk) + (size_t)(g.nbe + g.mt) * 4;
}

// The slab route's geometry of a launch whose template make_geometry does
// not stage whole, or false where the kernel does not take it (a template
// word count the wrapper did not build for this k). A block takes up to 64
// rows (4 row groups, two warps each); a slab is the most k-steps (at most
// 16 a warp) that keep the block within SLAB_SMEM, so that two blocks share
// a multiprocessor, then the slabs are evened out. Where no slab fits
// that, one block takes MAX_SMEM, with fewer rows where it must.
inline bool make_slab_geometry(SlabGeometry& g, int64_t row_stride, int seg_len, int out_len, int k,
                               int w, float te, bool a_lo, bool b_lo, size_t& smem) {
  if (k < 1 || out_len < 1) return false;
  make_geometry(g, row_stride, seg_len, out_len, k, w, te, a_lo, b_lo, smem);
  if (w < 8 * g.nks + 72 || w % 32 != 16) return false;
  g.n_steps = (g.nks + 7) / 8 * 8;
  const int rows0 = SLAB_WARPS / 2 * WARP_ROWS;
  const int budgets[2] = {SLAB_SMEM, MAX_SMEM};
  for (const int budget : budgets) {
    for (int max_rows = rows0; max_rows >= WARP_ROWS; max_rows -= WARP_ROWS) {
      if (budget == SLAB_SMEM && max_rows < rows0) break;
      g.n_tiles = (g.n_rows + max_rows - 1) / max_rows;
      const int per = (g.n_rows + g.n_tiles - 1) / g.n_tiles;
      g.mt = (per + WARP_ROWS - 1) / WARP_ROWS * WARP_ROWS;
      g.nbe = g.mt + g.kb - 1;
      g.warps = g.mt / WARP_ROWS * 2;
      int ksl = g.n_steps < 16 * g.warps ? g.n_steps : 16 * g.warps;
      while (ksl > 8 && slab_smem(g, ksl, a_lo, b_lo) > (size_t)budget) ksl -= 8;
      if (slab_smem(g, ksl, a_lo, b_lo) > (size_t)budget) continue;
      const int n_slabs = (g.n_steps + ksl - 1) / ksl;
      g.ksl = ((g.n_steps + n_slabs - 1) / n_slabs + 7) / 8 * 8;
      g.ws = 8 * g.ksl + 80;
      g.rr = slab_ring_rows(g.mt, g.ksl);
      smem = slab_smem(g, g.ksl, a_lo, b_lo);
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

struct SlabSmem : Smem {
  float* raw;   // float32 samples of the next slab's new rows, 8 a thread
  float4* sum;  // [mt / 16][NT][32]: lane l's fragment of n8 tile j of row group r at (r NT + j) 32 + l
};

template <bool A_LO, bool B_LO>
__device__ __forceinline__ SlabSmem carve_slab(unsigned char* base, const SlabGeometry& g) {
  SlabSmem s;
  s.tpl = reinterpret_cast<uint32_t*>(base);
  s.hi = reinterpret_cast<__nv_bfloat16*>(s.tpl + 2 * (B_LO ? 4 : 2) * g.ws);
  s.lo = s.hi + g.rr * ROW_PITCH;
  s.raw = reinterpret_cast<float*>(s.hi + (A_LO ? 2 : 1) * g.rr * ROW_PITCH);
  s.sum = reinterpret_cast<float4*>(base);
  unsigned char* end = reinterpret_cast<unsigned char*>(s.raw + (A_LO ? g.ksl / 8 * ROW : 0));
  if (end < base + g.mt * ROW * 4) end = base + g.mt * ROW * 4;
  s.blk = reinterpret_cast<float*>(end);
  s.scale = s.blk + g.nbe;
  return s;
}

// The block energies of the tile's rows (blocks 0 .. nbe - 1 from the
// tile's first sample, zero past seg_len), summed as stage sums them, then
// one scale a row, as stage's. Ends with __syncthreads().
template <typename T>
__device__ __forceinline__ void slab_energies(const T* __restrict__ seg, const SlabGeometry& g, int b,
                                              int tile, const Smem& s) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const T* row = seg + (int64_t)b * g.row_stride;
  const int64_t base = (int64_t)tile * g.mt * ROW;
  const int n_chunks = g.nbe * (ROW / 8);
  for (int c0 = 0; c0 < n_chunks; c0 += nthreads) {
    const int c = c0 + tid;
    const bool live = c < n_chunks;
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = live ? load_or_zero(row, base + 8 * c + j, g.seg_len) : 0.0f;
      e = fmaf(v, v, e);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off, 16);
    if (live && (c & 15) == 0) s.blk[c >> 4] = e;
  }
  __syncthreads();
  const float te = g.te_ptr ? __ldg(g.te_ptr) : g.te;
  for (int r = tid; r < g.mt; r += nthreads) {
    float win = 0.0f;
    for (int q = 0; q < g.kb; ++q) win += s.blk[r + q];
    s.scale[r] = rsqrtf(te * fmaxf(win, 1e-4f * te));
  }
  __syncthreads();
}

// 8 samples of the segment on their way to the ring: float32 whole (split
// into hi and lo at the store), bf16 as its 4 words of bit pairs (bf16 ->
// float32 -> bf16 gives back the same bits).
template <typename T>
struct Chunk {
  float v[8];
};
template <>
struct Chunk<__nv_bfloat16> {
  uint32_t w[4];
};

// Samples i .. i + 7 of a row (zero past seg_len).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int64_t i, int seg_len, Chunk<T>& c) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c.v[j] = load_or_zero(row, i + j, seg_len);
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t a = i + 2 * j;
      const uint32_t lo = a >= 0 && a < seg_len ? r[a] : 0u;
      const uint32_t hi = a + 1 >= 0 && a + 1 < seg_len ? r[a + 1] : 0u;
      c.w[j] = lo | hi << 16;
    }
  }
}

// A chunk as bf16 at sample `at` of the ring: hi, then lo = bf16(x - hi)
// for float32 samples, as stage splits them.
template <typename T>
__device__ __forceinline__ void store_chunk(const Smem& s, int at, const Chunk<T>& c) {
  if constexpr (std::is_same<T, float>::value) {
    uint4 hi, lo;
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = pack_bf16(c.v[2 * j], c.v[2 * j + 1]);
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&h[j]);
      l[j] = pack_bf16(c.v[2 * j] - __low2float(hv), c.v[2 * j + 1] - __high2float(hv));
    }
    *reinterpret_cast<uint4*>(s.hi + at) = hi;
    *reinterpret_cast<uint4*>(s.lo + at) = lo;
  } else {
    *reinterpret_cast<uint4*>(s.hi + at) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  }
}

// The slab from k-step st0, nk steps: words 8 st0 .. 8 (st0 + nk) + 71 of
// each template copy into dst (copy c at c ws), zero past the copy's w
// words, by cp.async (issued, not waited for).
template <bool B_LO>
__device__ __forceinline__ void stage_window(const uint32_t* __restrict__ tpl, const SlabGeometry& g,
                                             int st0, int nk, uint32_t* dst) {
  const int per_copy = 2 * nk + 18;  // 16-byte vectors of a copy's window
  for (int i = threadIdx.x; i < (B_LO ? 4 : 2) * per_copy; i += blockDim.x) {
    const int cp = i / per_copy, v = i - cp * per_copy;
    const int word = 8 * st0 + 4 * v;
    const bool in = word < g.w;
    cp_async16(dst + cp * g.ws + 4 * v, tpl + (int64_t)cp * g.w + (in ? word : 0), in ? 16 : 0);
  }
}

// Span rows r0 .. r0 + n - 1 (128 samples each from the tile's first
// sample) into their ring slots.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* row, int64_t base, const SlabGeometry& g, int r0, int n,
                                           const Smem& s) {
  for (int c = threadIdx.x; c < n * (ROW / 8); c += blockDim.x) {
    const int r = r0 + (c >> 4);
    Chunk<T> v;
    load_chunk(row, base + (int64_t)ROW * r + 8 * (c & 15), g.seg_len, v);
    store_chunk(s, (r % g.rr) * ROW_PITCH + 8 * (c & 15), v);
  }
}

// 8 k-steps of a warp's walk over its 16 rows and SLAB_NTW n8 tiles
// (product's step, the A row read through the ring): a the lane's ldmatrix
// address at the group's first step (its ring slot and k offset in),
// lo_off the lo rows' offset; tb, tl the lane's hi and lo template words at
// that step. The next step's hi A fragment loads before this step's
// products (at the step for float32 x float32, whose registers are
// fullest); the lo one, which the last products take, at the step.
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void walk_group(uint32_t a, uint32_t lo_off, const uint32_t* tb,
                                           const uint32_t* tl, float (&acc)[SLAB_NTW][4],
                                           uint32_t (&rh)[SLAB_NTW + 1], uint32_t (&rl)[SLAB_NTW + 1]) {
  constexpr bool AHEAD = !(A_LO && B_LO);
  uint32_t ah[2][4], al[4];
  if (AHEAD) ldmatrix_x4(ah[0], a);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = AHEAD ? i & 1 : 0;
    if (!AHEAD) ldmatrix_x4(ah[0], a + 32 * i);
    if (AHEAD && i < 7) ldmatrix_x4(ah[c ^ 1], a + 32 * (i + 1));
    if (A_LO) ldmatrix_x4(al, a + lo_off + 32 * i);
    const uint32_t nh0 = tb[8 * i + 12], nh1 = tb[8 * i + 8];  // the next step's two words
    uint32_t nl0 = 0, nl1 = 0;
    if (B_LO) {
      nl0 = tl[8 * i + 12];
      nl1 = tl[8 * i + 8];
    }
#pragma unroll
    for (int j = 0; j < SLAB_NTW; ++j) mma_bf16(acc[j], ah[c], rh[j + 1], rh[j]);
    if (B_LO) {
#pragma unroll
      for (int j = 0; j < SLAB_NTW; ++j) mma_bf16(acc[j], ah[c], rl[j + 1], rl[j]);
    }
    if (A_LO) {
#pragma unroll
      for (int j = 0; j < SLAB_NTW; ++j) mma_bf16(acc[j], al, rh[j + 1], rh[j]);
    }
#pragma unroll
    for (int u = SLAB_NTW; u >= 2; --u) {
      rh[u] = rh[u - 2];
      if (B_LO) rl[u] = rl[u - 2];
    }
    rh[0] = nh0;
    rh[1] = nh1;
    if (B_LO) {
      rl[0] = nl0;
      rl[1] = nl1;
    }
  }
}

// Whether this warp holds rows for the epilogue (the first mt / 16 warps).
__device__ __forceinline__ bool holds_rows(const SlabGeometry& g) {
  return (int)(threadIdx.x >> 5) < g.mt / WARP_ROWS;
}

// One block's rows of stream b on the slab route: for the warps that hold
// rows (holds_rows), sum holds each lag's correlation as product's acc does
// on the one-shot route (the warp's 16 rows, all 128 columns). ENERGY: the
// scales first (the searches; correlate stages none).
template <typename T, bool B_LO, bool ENERGY>
__device__ __forceinline__ SlabSmem slab_rows(const T* __restrict__ seg, const uint32_t* __restrict__ tpl,
                                              const SlabGeometry& g, int b, int tile, unsigned char* smem,
                                              float (&sum)[NT][4]) {
  constexpr bool A_LO = std::is_same<T, float>::value;
  constexpr int COPIES = B_LO ? 4 : 2;
  const SlabSmem s = carve_slab<A_LO, B_LO>(smem, g);
  if (ENERGY) slab_energies<T>(seg, g, b, tile, s);
  const T* row = seg + (int64_t)b * g.row_stride;
  const int64_t base = (int64_t)tile * g.mt * ROW;
  const int nk0 = min(g.ksl, g.n_steps);
  stage_window<B_LO>(tpl, g, 0, nk0, s.tpl);
  stage_rows<T>(row, base, g, 0, g.mt - 1 + nk0 / 8, s);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, gi = lane & 3;
  const int rg = warp >> 1, half = warp & 1;  // row group, column half
  // ldmatrix: lane supplies row (lane & 7) + 8 (bit 3 of lane) of the m16
  // tile at p offset 8 (bit 4 of lane); the row's ring slot is added a group
  const uint32_t a_base = smem_addr(s.hi) + 2u * ((lane >> 4) * 8);
  const uint32_t lo_off = 2u * g.rr * ROW_PITCH;
  // H(e) of this lane is word tb[e / 2] (copy gq & 1); the second half's
  // columns lie 64 samples on
  const int h_off = (gq & 1) * g.ws + TPL_OFF / 2 + gi - (gq >> 1) - 4 * SLAB_NTW * half;
  uint32_t rh[SLAB_NTW + 1], rl[SLAB_NTW + 1];  // rh[u] = H(16 s + 8 - 8 u) of the half's first tile
#pragma unroll
  for (int u = 0; u <= SLAB_NTW; ++u) {
    rh[u] = s.tpl[h_off + 4 - 4 * u];
    if (B_LO) rl[u] = s.tpl[h_off + 2 * g.ws + 4 - 4 * u];
  }
  float acc[SLAB_NTW][4], total[SLAB_NTW][4];
#pragma unroll
  for (int j = 0; j < SLAB_NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = total[j][e] = 0.0f;
  int slot = rg * WARP_ROWS + (lane & 7) + ((lane >> 3) & 1) * 8;  // the lane's A row, in the ring
  const int c = threadIdx.x;  // the next slab's chunk this thread stages, where c < 2 nk1
  for (int sl = 0, st0 = 0; st0 < g.n_steps; ++sl, st0 += g.ksl) {
    const int nk = min(g.ksl, g.n_steps - st0);
    const int nk1 = min(g.ksl, g.n_steps - st0 - g.ksl);  // the next slab's, <= 0 past the last
    const uint32_t* tb = s.tpl + (sl & 1) * COPIES * g.ws + h_off;
    // the next slab's template words and new rows (one chunk a thread at
    // most), staged under this slab's products: float32 samples by
    // cp.async into raw, bf16 ones in 4 registers
    Chunk<__nv_bfloat16> v;
    if (nk1 > 0) stage_window<B_LO>(tpl, g, st0 + g.ksl, nk1, s.tpl + ((sl + 1) & 1) * COPIES * g.ws);
    if (c < 2 * nk1) {
      const int64_t at = base + (int64_t)ROW * ((st0 + g.ksl) / 8 + g.mt - 1 + (c >> 4)) + 8 * (c & 15);
      if constexpr (A_LO) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in = at + j >= 0 && at + j < g.seg_len;
          cp_async4(s.raw + 8 * c + j, row + (in ? at + j : 0), in ? 4 : 0);
        }
      } else {
        load_chunk(row, at, g.seg_len, v);
      }
    }
    for (int q = 0; q < nk / 8; ++q) {
      walk_group<A_LO, B_LO>(a_base + (uint32_t)slot * (2 * ROW_PITCH), lo_off, tb + 64 * q,
                             tb + 64 * q + 2 * g.ws, acc, rh, rl);
      slot = slot + 1 == g.rr ? 0 : slot + 1;
      if ((st0 / 8 + q) % (FOLD / 8) == FOLD / 8 - 1) {  // fold into the float32 sum
#pragma unroll
        for (int j = 0; j < SLAB_NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[j][e] += acc[j][e];
            acc[j][e] = 0.0f;
          }
      }
    }
    cp_async_wait_all();
    if (c < 2 * nk1) {
      const int r = (st0 + g.ksl) / 8 + g.mt - 1 + (c >> 4);
      const int slot_at = (r % g.rr) * ROW_PITCH + 8 * (c & 15);
      if constexpr (A_LO) {
        Chunk<float> f;
#pragma unroll
        for (int j = 0; j < 8; ++j) f.v[j] = s.raw[8 * c + j];
        store_chunk(s, slot_at, f);
      } else {
        store_chunk(s, slot_at, v);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < SLAB_NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) total[j][e] += acc[j][e];
  // the sums as the epilogue takes them, a warp's 16 rows and all 128
  // columns, gathered over the ring, which the last barrier freed
  float4* my_sum = s.sum + (rg * NT + SLAB_NTW * half) * 32 + lane;
#pragma unroll
  for (int j = 0; j < SLAB_NTW; ++j) my_sum[32 * j] = make_float4(total[j][0], total[j][1], total[j][2], total[j][3]);
  __syncthreads();
  if (holds_rows(g)) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 t = s.sum[(warp * NT + j) * 32 + lane];
      sum[j][0] = t.x;
      sum[j][1] = t.y;
      sum[j][2] = t.z;
      sum[j][3] = t.w;
    }
  }
  return s;
}

// tile_rows on the slab route; a warp that holds no rows gives -1 at
// column 128, as a row past the stream's end does.
template <typename T, bool B_LO>
__device__ __forceinline__ void tile_rows_slab(const T* __restrict__ seg,
                                               const uint32_t* __restrict__ tpl, const SlabGeometry& g,
                                               int b, int tile, unsigned char* smem, float (&bq)[2],
                                               int (&bc)[2]) {
  float sum[NT][4];
  const SlabSmem s = slab_rows<T, B_LO, true>(seg, tpl, g, b, tile, smem, sum);
  bq[0] = bq[1] = -1.0f;
  bc[0] = bc[1] = ROW;
  if (holds_rows(g)) row_best(g, s, tile, sum, bq, bc);
}

// The blocks a multiprocessor holds of a slab kernel at geometry g, and
// what sets them: out = {blocks an SM, threads a block, shared memory
// bytes, k-steps a slab, slabs, registers a thread, local (spilled) bytes
// a thread, rows a block}.
template <typename K>
cudaError_t slab_occupancy(K kernel, const SlabGeometry& g, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block_threads(g), smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int values[8] = {blocks, block_threads(g), (int)smem, g.ksl, (g.n_steps + g.ksl - 1) / g.ksl,
                         fa.numRegs, (int)fa.localSizeBytes, g.mt};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return cudaSuccess;
}

}  // namespace search
}  // namespace anet
