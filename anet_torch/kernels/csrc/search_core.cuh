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
// of ksl (a multiple of 8, so a slab's span starts on a staged row). Each
// slab stages its window of the same template words (8 ksl + 72 of each
// copy, no new operand) and the span rows its Hankel rows read (mt - 1 +
// ksl / 8), and the lane reloads its 17-pair B ring at the slab's start.
// The 128-sample block energies are computed once, before the first slab,
// from the same loads and in the same order as the one-shot stage, so the
// window sums and scales are its bits. The tensor cores truncate what they
// add to an accumulator, which over thousands of k-steps (3,848 at 61,440
// samples) drifts by about 2^-23 of the sum a step: the slab route adds its
// accumulators into a float32 sum on the CUDA cores every FOLD k-steps and
// starts them again from zero. That sum takes 64 more registers a lane, so
// a slab block runs alone on its multiprocessor, with the shared memory of
// one block.
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

constexpr int FOLD = 32;  // k-steps between the slab route's folds into its float32 sum

// The slab route's geometry: the one-shot fields, and the slab's.
struct SlabGeometry : Geometry {
  int ksl;  // k-steps of a slab, a multiple of 8
  int ws;   // words of a staged template copy: 8 ksl + 80, 16 mod 32
  int nbe;  // the block energies of a block's rows: mt + kb - 1
};

inline size_t slab_smem(const SlabGeometry& g, int ksl, bool a_lo, bool b_lo) {
  const int ws = 8 * ksl + 80;
  const int nbs = g.mt - 1 + ksl / 8;
  return (size_t)(b_lo ? 2 : 1) * 2 * ws * 4 + (size_t)(a_lo ? 2 : 1) * nbs * ROW_PITCH * 2 +
         (size_t)(g.nbe + g.mt) * 4;
}

// The slab route's geometry of a launch whose template make_geometry does
// not stage whole, or false where the kernel does not take it (a template
// word count the wrapper did not build for this k). The rows are split as
// make_geometry splits them; a slab is the most k-steps that keep the
// block's shared memory within MAX_SMEM, then the slabs are evened out.
inline bool make_slab_geometry(SlabGeometry& g, int64_t row_stride, int seg_len, int out_len, int k,
                               int w, float te, bool a_lo, bool b_lo, size_t& smem) {
  if (k < 1 || out_len < 1) return false;
  make_geometry(g, row_stride, seg_len, out_len, k, w, te, a_lo, b_lo, smem);
  if (w < 8 * g.nks + 72 || w % 32 != 16) return false;
  g.nbe = g.mt + g.kb - 1;
  int ksl = (g.nks + 7) / 8 * 8;
  while (ksl > 8 && slab_smem(g, ksl, a_lo, b_lo) > (size_t)MAX_SMEM) ksl -= 8;
  const int n_slabs = (g.nks + ksl - 1) / ksl;
  g.ksl = ((g.nks + n_slabs - 1) / n_slabs + 7) / 8 * 8;
  g.ws = 8 * g.ksl + 80;
  smem = slab_smem(g, g.ksl, a_lo, b_lo);
  return smem <= (size_t)MAX_SMEM;
}

template <bool A_LO, bool B_LO>
__device__ __forceinline__ Smem carve_slab(unsigned char* base, const SlabGeometry& g) {
  const int nbs = g.mt - 1 + g.ksl / 8;
  Smem s;
  s.tpl = reinterpret_cast<uint32_t*>(base);
  s.hi = reinterpret_cast<__nv_bfloat16*>(s.tpl + (B_LO ? 2 : 1) * 2 * g.ws);
  s.lo = s.hi + nbs * ROW_PITCH;
  s.blk = reinterpret_cast<float*>(s.hi + (A_LO ? 2 : 1) * nbs * ROW_PITCH);
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

// Stage slab st0 .. st0 + nk - 1: words 8 st0 .. 8 (st0 + nk) + 71 of each
// template copy, and the span's blocks st0 / 8 .. st0 / 8 + mt - 2 + ceil(nk
// / 8) as bf16 rows (hi, then lo for float32 samples), as stage stages
// them. Ends with __syncthreads().
template <typename T, bool B_LO>
__device__ __forceinline__ void stage_slab(const T* __restrict__ seg, const uint32_t* __restrict__ tpl,
                                           const SlabGeometry& g, int b, int tile, int st0, int nk,
                                           const Smem& s) {
  constexpr bool A_LO = std::is_same<T, float>::value;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int per_copy = (8 * nk + 72) / 4;  // 16-byte vectors of a copy's window
#pragma unroll
  for (int cp = 0; cp < (B_LO ? 4 : 2); ++cp) {
    const uint4* src = reinterpret_cast<const uint4*>(tpl + (int64_t)cp * g.w + 8 * st0);
    uint4* dst = reinterpret_cast<uint4*>(s.tpl + cp * g.ws);
    for (int i = tid; i < per_copy; i += nthreads) dst[i] = src[i];
  }
  const T* row = seg + (int64_t)b * g.row_stride;
  const int64_t base = (int64_t)tile * g.mt * ROW + 16 * (int64_t)st0;
  const int n_chunks = (g.mt - 1 + (nk + 7) / 8) * (ROW / 8);
  for (int c = tid; c < n_chunks; c += nthreads) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = load_or_zero(row, base + 8 * c + j, g.seg_len);
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
  }
  __syncthreads();
}

// product's walk over a staged slab of nk k-steps, its accumulators added
// into sum every FOLD k-steps and at the slab's end.
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void product_slab(const SlabGeometry& g, const Smem& s, int nk,
                                             float (&sum)[NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, gi = lane & 3;
  const int a_row = warp * WARP_ROWS + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 8;
  const uint32_t a_hi = smem_addr(s.hi + a_row * ROW_PITCH);
  const uint32_t a_lo = smem_addr(s.lo + a_row * ROW_PITCH);
  const uint32_t* tb = s.tpl + (gq & 1) * g.ws + TPL_OFF / 2 + gi - (gq >> 1);
  const uint32_t* tl = tb + 2 * g.ws;
  uint32_t rh[NT + 1], rl[NT + 1];
#pragma unroll
  for (int u = 0; u <= NT; ++u) {
    rh[u] = tb[4 - 4 * u];
    if (B_LO) rl[u] = tl[4 - 4 * u];
  }
  for (int f0 = 0; f0 < nk; f0 += FOLD) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const int f1 = min(f0 + FOLD, nk);
    for (int st = f0; st < f1; ++st) {
      const int pk = 16 * st + a_k;
      const uint32_t off = 2u * (uint32_t)(pk + 8 * (pk >> 7));
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, a_hi + off);
      if (A_LO) ldmatrix_x4(al, a_lo + off);
      const uint32_t nh0 = tb[8 * st + 12], nh1 = tb[8 * st + 8];
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
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) sum[j][v] += acc[j][v];
  }
}

// One block's rows of stream b on the slab route: sum holds each lag's
// correlation, as product's acc does on the one-shot route. ENERGY: the
// scales first (the searches; correlate stages none).
template <typename T, bool B_LO, bool ENERGY>
__device__ __forceinline__ Smem slab_rows(const T* __restrict__ seg, const uint32_t* __restrict__ tpl,
                                          const SlabGeometry& g, int b, int tile, unsigned char* smem,
                                          float (&sum)[NT][4]) {
  constexpr bool A_LO = std::is_same<T, float>::value;
  const Smem s = carve_slab<A_LO, B_LO>(smem, g);
  if (ENERGY) slab_energies<T>(seg, g, b, tile, s);
#pragma unroll
  for (int j = 0; j < NT; ++j) sum[j][0] = sum[j][1] = sum[j][2] = sum[j][3] = 0.0f;
  for (int st0 = 0; st0 < g.nks; st0 += g.ksl) {
    const int nk = min(g.ksl, g.nks - st0);
    if (st0) __syncthreads();  // every warp is done with the slab before
    stage_slab<T, B_LO>(seg, tpl, g, b, tile, st0, nk, s);
    product_slab<A_LO, B_LO>(g, s, nk, sum);
  }
  return s;
}

// tile_rows on the slab route.
template <typename T, bool B_LO>
__device__ __forceinline__ void tile_rows_slab(const T* __restrict__ seg,
                                               const uint32_t* __restrict__ tpl, const SlabGeometry& g,
                                               int b, int tile, unsigned char* smem, float (&bq)[2],
                                               int (&bc)[2]) {
  float sum[NT][4];
  const Smem s = slab_rows<T, B_LO, true>(seg, tpl, g, b, tile, smem, sum);
  row_best(g, s, tile, sum, bq, bc);
}

}  // namespace search
}  // namespace anet
