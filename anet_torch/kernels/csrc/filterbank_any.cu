// filterbank_any: the batch-major filterbank (tone_energies_fused,
// decide_tones_fused) at every geometry off tone_energies.cu's compile-time
// walks, on the tensor cores, Hopper.
//
// Replaces, at those geometries, the TPU kernels anet/kernels/__init__.py
// tone_energies_fused (pallas_call at line 117, body _energy_kernel at line
// 76) and decide_tones_fused (pallas_call at line 200, body _decide_kernel
// at line 152), which take any samples_per_symbol and any tone count.
// tone_energies.cu's walk fixes sps at compile time (32, 48, 64, 80, 128)
// and takes at most 32 tones (kernels._filterbank_tensor_core_geometry);
// custom configs off it (sps 15, 24, 40, 100, 160, 1,920, ..., or more than
// 32 tones) come here (kernels._filterbank_operands: routes "any" and
// "any_split"; launches counted under kernels.OFF_WALK_KEYS["any"],
// filterbank_any).
//
// Input: R batch-major rows, row r at x + r * row_stride elements, S whole
// symbols of sps samples each, bfloat16 (either compute dtype) or float32
// (float32 compute), a row starting at any multiple of its element size.
// Per symbol the [sps, 2M] filterbank gives I and Q in float32, then
//   energies:  I*I + Q*Q of every tone, float32 [R, S, M];
//   decisions: (argmax tone, the first on ties; best; total), [R, S] each.
//
// What bounds it on the H100: bytes. At sps 40 with 8 tones, 715 symbols a
// row and R = 4,096 the read is 0.23 GB of bf16 and the energies 0.09 GB
// (0.098 ms at 3.35 TB/s; float32 rows 0.168 ms); the products (one bf16
// product under bfloat16 compute, three or six under float32 compute) take
// 0.002-0.01 ms at the tensor cores' peak. At 256 tones the six products of
// float32 rows pass the bytes.
//
// Design: demod_core.cuh's product with the geometry known only at run time.
// - A warp walks pieces: a (row, tile of SYMS = 16 MT symbols) item, MT = 2
//   m16 tiles up to 16 tones a group and 1 at 17-32 (8 n-tiles, whose
//   accumulators take the registers), in slabs of KSL k-steps. A symbol is
//   KS = ceil(sps / 16) k-steps of 16 samples; KSL is the most that keep a
//   ring stage (SYMS rows of ROW bytes) within stage_target, so a long
//   symbol (sps 1,920: 120 k-steps) is walked slab by slab with the
//   accumulators kept across them: no ceiling on sps. Each warp keeps
//   ring_depth - 1 pieces' copies in flight in its own ring and syncs with
//   __syncwarp only.
// - Each symbol's slab is copied into a shared row of its own: 16-byte
//   cp.async chunks of the flat row aligned down from its first sample (its
//   byte residue rb in the first chunk), the copy's source size stopping it
//   at the row's last whole symbol, so no read passes into the gap after a
//   row or past the allocation. ROW / 16 is odd, so the 8 rows of an A
//   fragment's loads lie in 8 distinct bank groups. Rows g, g + 8, g + 16
//   and g + 24 of a tile share one residue (8 symbols are a multiple of 16
//   bytes), so a lane builds all its A registers with one funnel shift of
//   the two aligned words around them (bf16 rows, as demod_core.cuh's
//   a_frag) or reads its two float32 samples (float32 rows, split in
//   registers into three bf16 terms, as a_split).
// - Samples past sps in a symbol's last k-step are zeroed in the A
//   registers, not multiplied by a zero basis row: a neighbour's sample, or
//   the stale bytes of a stage, never enter a sum.
// - B: kernels._filterbank_any_basis, packed once a config, compute dtype
//   and device, zero rows past sps: by (group, k-step, n-tile) in fragment
//   order, a lane's two words of b0 one 8-byte vector and, split, its words
//   of b1 and b2 one 16-byte vector after all of b0. Read through the
//   read-only cache each k-step, once for the MT m16 tiles.
// - Products, demod_core.cuh's in its order: bfloat16 compute, one (the
//   bf16 basis, OneTerm); float32 compute, the three-term split of the
//   float32 basis (SplitTerms): bf16 rows meet b2, b1, b0; float32 rows the
//   six a_i b_j with i + j <= 2, smallest first, a0 b0 in an accumulator of
//   its own. The tensor cores truncate what they add to an accumulator, so
//   over a long symbol (sps 1,920: 120 k-steps) the float32 sums drift by
//   about 2^-23 of their size a k-step: past one slab (LONG) each slab's
//   accumulators are added into a float32 sum on the CUDA cores, which
//   rounds to nearest, and start again from zero (the split's tolerance,
//   and the one product's 1e-5 of the largest energy, held at sps 1,920
//   only so).
// - Tones: GROUP = 32 a group (8 n-tiles); past 32, groups follow in order
//   over the same samples (a one-slab symbol: on the same stage; else its
//   slabs again). The energies epilogue stores each group's tones; the
//   decisions epilogue folds the groups into a running (best, tone, total)
//   of float32 best and total, strict > across groups in ascending tone
//   order, so the first index wins a tie, as store_decisions within one.
// The TPU kernels' flattened [T, sps] windows and their zero padding to
// 512-symbol tiles are not carried over.
#include "demod_core.cuh"

namespace {

using anet::demod::bf16_pair;
using anet::demod::cp_async16;
using anet::demod::cp_async_commit;
using anet::demod::cp_async_wait;
using anet::demod::mma;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int GROUP = 32;            // tones a group: 8 n8 tiles of 4 tones' (I, Q)

// A warp's ring: 3 stages (2 pieces in flight, one read), but 2 for float32
// rows of one slab, whose stages are twice as large: there the warps an SM,
// not the bytes in flight, set the pace (as demod_core.cuh's F32_RING).
template <typename T, bool LONG>
__host__ __device__ constexpr int ring_depth() {
  return std::is_same<T, float>::value && !LONG ? 2 : 3;
}

// Bytes a ring stage holds at most: 4 KB for the one-term product (sps
// 1,920: 0.35 ms against 0.54 at 8 KB, more blocks an SM), 8 KB for the
// split (4 KB cut its symbols into more slabs and ran slower at sps 160,
// and at sps 1,920 on float32 rows; H100, time_search --kernels
// filterbank_any).
template <bool SPLIT>
__host__ __device__ constexpr int stage_target() {
  return SPLIT ? 8192 : 4096;
}
constexpr int MAX_SMEM = WARPS * 3 * 8192;

// The launch's geometry, all set on the host.
struct Geo {
  const unsigned char* x;  // row 0's first sample
  long long pitch;         // bytes from a row to the next
  long long row_bytes;     // a row's whole symbols: the bound of every copy
  int R, n_symbols, sps, m;
  int gm;                  // tones a group, min(m, GROUP)
  int ng;                  // groups, m / gm
  int ks;                  // k-steps a symbol, ceil(sps / 16)
  int ksl, nsl;            // k-steps a slab, slabs a symbol
  int tiles;               // tiles of SYMS symbols a row
  int items;               // R * tiles
  int ppi;                 // pieces an item: 1 (one slab, every group on it) or ng * nsl
  int row;                 // bytes of a staged symbol row (ROW)
  int stage;               // bytes of a ring stage, SYMS * row
  int cpr;                 // 16-byte chunks a staged row takes at most
  int rpp;                 // rows a pass of the copy: 32 / cpr
  const uint2* b0;         // [ng, ks, NT, 32] b0 words
  const uint4* b12;        // [ng, ks, NT, 32] b1 and b2 words (float32 compute)
  void* out0;              // energies [R, S, m], or tone [R, S]
  float* out1;             // best [R, S]
  float* out2;             // total [R, S]
};

template <int NT>
struct Tile {
  static constexpr int MT = NT <= 4 ? 2 : 1;  // m16 tiles an item
  static constexpr int SYMS = 16 * MT;
};

// Start the copies of piece q of the warp (if it has one) into a ring
// stage, then commit a group, so every iteration commits one. Lane (r_off,
// c) copies chunk c of rows r_off, r_off + rpp, ...; `active` is false for
// the lanes past rpp * cpr.
template <typename T, int SYMS>
__device__ __forceinline__ void fetch(const Geo& g, int q, int np, int j0, int step, unsigned char* stage,
                                      int r_off, int c, bool active) {
  if (q < np && active) {
    const int n = q / g.ppi;
    const int sl = (q - n * g.ppi) % g.nsl;
    const int j = j0 + n * step;
    const int b = j / g.tiles;
    const int s0 = (j - b * g.tiles) * SYMS;
    const int live = min(SYMS, g.n_symbols - s0);
    const int lo = sl * g.ksl * 16;  // the slab's first sample of a symbol
    const int bytes = min(g.ksl * 16, g.sps - lo) * (int)sizeof(T);
    const uintptr_t row0 = reinterpret_cast<uintptr_t>(g.x) + (uintptr_t)((long long)b * g.pitch);
    const uintptr_t end = row0 + (uintptr_t)g.row_bytes;
    for (int r = r_off; r < live; r += g.rpp) {
      const uintptr_t a = row0 + (uintptr_t)(((long long)(s0 + r) * g.sps + lo) * (long long)sizeof(T));
      const int rb = (int)(a & 15);
      if (16 * c < rb + bytes) {  // the chunk holds some of the slab's bytes, so src < end
        const uintptr_t src = a - rb + 16 * (uintptr_t)c;
        const int n_bytes = end - src < 16 ? (int)(end - src) : 16;
        cp_async16(stage + r * g.row + 16 * c, reinterpret_cast<const void*>(src), n_bytes);
      }
    }
  }
  cp_async_commit();
}

// The kept bits of a bf16 pair whose first sample lies `left` samples
// before the symbol's end: both, the first (the low half) or none.
__device__ __forceinline__ uint32_t pair_mask(int left) {
  return left >= 2 ? 0xffffffffu : left == 1 ? 0x0000ffffu : 0u;
}

// T the rows' samples (bf16, or float32 under the split); SPLIT false:
// bfloat16 compute, one product; true: float32 compute, the three-term
// split. NT n-tiles a group; DECIDE: the decisions epilogue, else the
// energies; LONG (past one slab): each slab's sums added into a float32
// sum on the CUDA cores.
template <typename T, bool SPLIT, int NT, bool DECIDE, bool LONG>
__global__ void __launch_bounds__(THREADS) filterbank_any_kernel(const Geo g) {
  constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(!F32 || SPLIT, "float32 rows take float32 compute");
  constexpr int MT = Tile<NT>::MT;
  constexpr int SYMS = Tile<NT>::SYMS;
  constexpr int NS = SPLIT ? MT : 1;  // the smaller products' accumulators
  constexpr int RING = ring_depth<T, LONG>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, i = lane & 3;
  unsigned char* ring = smem + warp * RING * g.stage;
  const int step = gridDim.x * WARPS;
  const int j0 = blockIdx.x * WARPS + warp;
  const int nw = j0 < g.items ? (g.items - 1 - j0) / step + 1 : 0;
  const int np = nw * g.ppi;  // launch keeps it below 2^31
  const int c = lane % g.cpr, r_off = lane / g.cpr;
  const bool active = r_off < g.rpp;

#pragma unroll
  for (int s = 0; s < RING - 1; ++s)
    fetch<T, SYMS>(g, s, np, j0, step, ring + s * g.stage, r_off, c, active);

  float big[MT][NT][4], small[NS][NT][4];
  float sum[LONG ? MT : 1][NT][4];  // LONG: the slabs before this one
  float fb[MT][2], fs[MT][2];  // the decisions' running best and total
  int ft[MT][2];               // and tone
  for (int q = 0; q < np; ++q) {
    fetch<T, SYMS>(g, q + RING - 1, np, j0, step, ring + ((q + RING - 1) % RING) * g.stage, r_off, c, active);
    cp_async_wait<RING - 1>();
    __syncwarp();
    const unsigned char* stage = ring + (q % RING) * g.stage;
    const int n = q / g.ppi;
    const int rem = q - n * g.ppi;
    const int sl = rem % g.nsl;
    const int j = j0 + n * step;
    const int b = j / g.tiles;
    const int s0 = (j - b * g.tiles) * SYMS;
    const int nk = min(g.ksl, g.ks - sl * g.ksl);
    // the byte residue of this lane's rows g, g + 8, ... in their first chunk
    const uintptr_t a = reinterpret_cast<uintptr_t>(g.x) +
                        (uintptr_t)((long long)b * g.pitch +
                                    ((long long)(s0 + gq) * g.sps + sl * g.ksl * 16) * (long long)sizeof(T));
    const int rb = (int)(a & 15);
    const int sh = 8 * (rb & 3);
    const int x0 = (rb >> 2) + (F32 ? 2 * i : i);  // the lane's first word of a k-step
    const unsigned char* rows = stage + gq * g.row;
    const int grp_lo = g.nsl == 1 ? 0 : rem / g.nsl;
    const int grp_hi = g.nsl == 1 ? g.ng : grp_lo + 1;
    for (int grp = grp_lo; grp < grp_hi; ++grp) {
      if (sl == 0) {  // a group's first slab (LONG: the fold zeroes big and small after each)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              big[mt][t][v] = 0.0f;
              if constexpr (LONG) sum[mt][t][v] = 0.0f;
            }
#pragma unroll
        for (int mt = 0; mt < NS; ++mt)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v) small[mt][t][v] = 0.0f;
      }
      for (int kk = 0; kk < nk; ++kk) {
        const int ks = sl * g.ksl + kk;
        const int left = g.sps - 16 * ks - 2 * i;  // samples from the lane's first of the k-step on
        const bool last = ks == g.ks - 1;           // warp-uniform
        const size_t bi = ((size_t)(grp * g.ks + ks) * NT) * 32 + lane;
        if constexpr (F32) {
          uint32_t a0[MT][4], a1[MT][4], a2[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hk = 0; hk < 2; ++hk) {
              const int x = x0 + 16 * kk + 8 * hk;  // samples x and x + 1 of the row
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* r = reinterpret_cast<const float*>(rows + (16 * mt + 8 * h) * g.row);
                float lo = r[x], hi = r[x + 1];
                if (last) {
                  lo = left - 8 * hk >= 1 ? lo : 0.0f;
                  hi = left - 8 * hk >= 2 ? hi : 0.0f;
                }
                a0[mt][2 * hk + h] = bf16_pair(lo, hi, lo, hi);
                a1[mt][2 * hk + h] = bf16_pair(lo, hi, lo, hi);
                a2[mt][2 * hk + h] = bf16_pair(lo, hi, lo, hi);
              }
            }
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint2 u = __ldg(g.b0 + bi + 32 * t);
            const uint4 v = __ldg(g.b12 + bi + 32 * t);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {  // SplitTerms' six products, smallest first
              mma(small[mt][t], a2[mt], u.x, u.y);
              mma(small[mt][t], a1[mt], v.x, v.y);
              mma(small[mt][t], a0[mt], v.z, v.w);
              mma(small[mt][t], a1[mt], u.x, u.y);
              mma(small[mt][t], a0[mt], v.x, v.y);
              mma(big[mt][t], a0[mt], u.x, u.y);
            }
          }
        } else {
          uint32_t af[MT][4];
          const uint32_t m0 = last ? pair_mask(left) : 0xffffffffu;
          const uint32_t m1 = last ? pair_mask(left - 8) : 0xffffffffu;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hk = 0; hk < 2; ++hk) {
              const int x = x0 + 8 * kk + 4 * hk;  // word x of the row and the next
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t* r = reinterpret_cast<const uint32_t*>(rows + (16 * mt + 8 * h) * g.row);
                af[mt][2 * hk + h] = __funnelshift_r(r[x], r[x + 1], sh) & (hk ? m1 : m0);
              }
            }
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint2 u = __ldg(g.b0 + bi + 32 * t);
            if constexpr (SPLIT) {
              const uint4 v = __ldg(g.b12 + bi + 32 * t);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {  // SplitTerms' three products of bf16 samples
                mma(small[mt][t], af[mt], v.z, v.w);
                mma(small[mt][t], af[mt], v.x, v.y);
                mma(big[mt][t], af[mt], u.x, u.y);
              }
            } else {
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma(big[mt][t], af[mt], u.x, u.y);
            }
          }
        }
      }
      if constexpr (LONG) {  // the slab's sums into the float32 sum, rounded to nearest
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              if constexpr (SPLIT) {
                sum[mt][t][v] += big[mt][t][v] + small[mt][t][v];
                small[mt][t][v] = 0.0f;
              } else {
                sum[mt][t][v] += big[mt][t][v];
              }
              big[mt][t][v] = 0.0f;
            }
      }
      if (sl == g.nsl - 1) {  // the group's sums are whole: its epilogue
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float e[NT][2];
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            if constexpr (LONG) {
              e[u][0] = anet::tone_energy(sum[mt][u][0], sum[mt][u][1]);
              e[u][1] = anet::tone_energy(sum[mt][u][2], sum[mt][u][3]);
            } else if constexpr (SPLIT) {
              e[u][0] = anet::tone_energy(big[mt][u][0] + small[mt][u][0], big[mt][u][1] + small[mt][u][1]);
              e[u][1] = anet::tone_energy(big[mt][u][2] + small[mt][u][2], big[mt][u][3] + small[mt][u][3]);
            } else {
              e[u][0] = anet::tone_energy(big[mt][u][0], big[mt][u][1]);
              e[u][1] = anet::tone_energy(big[mt][u][2], big[mt][u][3]);
            }
          }
          const int sym0 = s0 + 16 * mt + gq;  // this lane's symbol of row h = 0; h = 1 is + 8
          if constexpr (DECIDE) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // the group's argmax, best and total: store_decisions' fold
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
                fb[mt][h] = bq;
                ft[mt][h] = bt;
                fs[mt][h] = tot;
              } else {
                if (bq > fb[mt][h]) {  // groups rise in tone: a tie keeps the earlier
                  fb[mt][h] = bq;
                  ft[mt][h] = grp * GROUP + bt;
                }
                fs[mt][h] += tot;
              }
            }
            const int sym = sym0 + 8 * i;  // lane i < 2 of the quad stores its row i
            if (grp == g.ng - 1 && i < 2 && sym < g.n_symbols) {
              const long long o = (long long)b * g.n_symbols + sym;
              static_cast<int32_t*>(g.out0)[o] = i ? ft[mt][1] : ft[mt][0];
              g.out1[o] = i ? fb[mt][1] : fb[mt][0];
              g.out2[o] = i ? fs[mt][1] : fs[mt][0];
            }
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int sym = sym0 + 8 * h;
              if (sym < g.n_symbols) {
                float* o = static_cast<float*>(g.out0) + ((long long)b * g.n_symbols + sym) * g.m + grp * GROUP;
#pragma unroll
                for (int u = 0; u < NT; ++u)
                  if (4 * u + i < g.gm) o[4 * u + i] = e[u][h];
              }
            }
          }
        }
      }
    }
    __syncwarp();  // the stage is read: a later iteration's copies may land in it
  }
  cp_async_wait<0>();
}

// The bytes of a staged symbol row of ksl k-steps of T: what the A reads of
// a slab reach (its 16 ksl samples from a residue below 16, and the word
// after them), an odd count of 16-byte chunks.
template <typename T>
int row_bytes(int ksl) {
  const int p = 16 * (int)sizeof(T) * ksl + 16;
  return (p / 16) % 2 ? p : p + 16;
}

// Launch the instantiation with the geometry set, on stream st.
template <typename T, bool SPLIT, int NT, bool DECIDE, bool LONG>
cudaError_t run(Geo g, cudaStream_t st) {
  auto kernel = filterbank_any_kernel<T, SPLIT, NT, DECIDE, LONG>;
  static int sms = 0;  // one per instantiation, set on its first launch
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  const int smem = WARPS * ring_depth<T, LONG>() * g.stage;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)g.R * g.tiles;
  const long long blocks = (items + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm);
  const long long per_warp = (items + (long long)grid * WARPS - 1) / ((long long)grid * WARPS) * g.ppi;
  if (items > (1LL << 30) || per_warp >= (1LL << 31)) return cudaErrorInvalidValue;  // the walk counts in int
  g.items = (int)items;
  kernel<<<grid, THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

// Set the geometry, then launch the instantiation that takes it.
template <typename T, bool SPLIT, int NT, bool DECIDE>
cudaError_t launch(Geo g, cudaStream_t st) {
  constexpr int SYMS = Tile<NT>::SYMS;
  int ksl = g.ks;
  while (ksl > 1 && SYMS * row_bytes<T>(ksl) > stage_target<SPLIT>()) --ksl;
  g.nsl = (g.ks + ksl - 1) / ksl;
  g.ksl = (g.ks + g.nsl - 1) / g.nsl;  // the slabs evened out
  g.row = row_bytes<T>(g.ksl);
  g.stage = SYMS * g.row;
  g.cpr = (15 + (16 * g.ksl < g.sps ? 16 * g.ksl : g.sps) * (int)sizeof(T) + 15) / 16;
  g.rpp = 32 / g.cpr;
  g.tiles = (g.n_symbols + SYMS - 1) / SYMS;
  g.ppi = g.nsl == 1 ? 1 : g.ng * g.nsl;
  if (g.rpp < 1) return cudaErrorInvalidConfiguration;
  if (g.nsl > 1) return run<T, SPLIT, NT, DECIDE, true>(g, st);
  return run<T, SPLIT, NT, DECIDE, false>(g, st);
}

template <typename T, bool SPLIT, bool DECIDE>
cudaError_t dispatch_tiles(const Geo& g, cudaStream_t st) {
  if (g.gm <= 4) return launch<T, SPLIT, 1, DECIDE>(g, st);
  if (g.gm <= 8) return launch<T, SPLIT, 2, DECIDE>(g, st);
  if (g.gm <= 16) return launch<T, SPLIT, 4, DECIDE>(g, st);
  return launch<T, SPLIT, 8, DECIDE>(g, st);
}

int dispatch(const void* x, int dtype, int R, long long row_stride, int n_symbols, int sps, int m,
             bool split, bool decide, const void* basis, void* out0, void* out1, void* out2,
             void* stream) {
  if (R < 1 || n_symbols < 1 || sps < 1 || m < 1 || row_stride < 0) return (int)cudaErrorInvalidValue;
  const int gm = m < GROUP ? m : GROUP;
  if (m % gm) return (int)cudaErrorInvalidValue;  // whole groups: m <= 32, or a multiple of 32
  const bool f32 = dtype == anet::DTYPE_F32;
  if (!(dtype == anet::DTYPE_BF16 || (f32 && split))) return (int)cudaErrorInvalidValue;
  const int esize = f32 ? 4 : 2;
  const int nt = gm <= 4 ? 1 : gm <= 8 ? 2 : gm <= 16 ? 4 : 8;
  Geo g{};
  g.x = static_cast<const unsigned char*>(x);
  g.pitch = row_stride * esize;
  g.row_bytes = (long long)n_symbols * sps * esize;
  g.n_symbols = n_symbols;
  g.sps = sps;
  g.m = m;
  g.gm = gm;
  g.ng = m / gm;
  g.ks = (sps + 15) / 16;
  g.R = R;
  g.b0 = static_cast<const uint2*>(basis);
  g.b12 = reinterpret_cast<const uint4*>(g.b0 + (size_t)g.ng * g.ks * nt * 32);
  g.out0 = out0;
  g.out1 = static_cast<float*>(out1);
  g.out2 = static_cast<float*>(out2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (f32) {
    return decide ? (int)dispatch_tiles<float, true, true>(g, st) : (int)dispatch_tiles<float, true, false>(g, st);
  }
  if (split)
    return decide ? (int)dispatch_tiles<__nv_bfloat16, true, true>(g, st)
                  : (int)dispatch_tiles<__nv_bfloat16, true, false>(g, st);
  return decide ? (int)dispatch_tiles<__nv_bfloat16, false, true>(g, st)
                : (int)dispatch_tiles<__nv_bfloat16, false, false>(g, st);
}

}  // namespace

// bfloat16 compute. x: R rows of >= n_symbols * sps bfloat16 samples (dtype
// 1), `row_stride` elements apart, contiguous within a row, any 2-byte
// alignment; any sps >= 1; m tones, at most 32 or a multiple of 32; basis:
// kernels._filterbank_any_basis for bfloat16; energies: [R, n_symbols, m]
// float32. Returns cudaGetLastError().
extern "C" int anet_tone_energies_any(const void* x, int dtype, int R, long long row_stride,
                                      int n_symbols, int sps, int m, const void* basis,
                                      void* energies, void* stream) {
  return dispatch(x, dtype, R, row_stride, n_symbols, sps, m, false, false, basis, energies, nullptr,
                  nullptr, stream);
}

// The same rows and basis; tone: [R, n_symbols] int32; best, total: [R,
// n_symbols] float32. Returns cudaGetLastError().
extern "C" int anet_decide_tones_any(const void* x, int dtype, int R, long long row_stride,
                                     int n_symbols, int sps, int m, const void* basis, void* tone,
                                     void* best, void* total, void* stream) {
  return dispatch(x, dtype, R, row_stride, n_symbols, sps, m, false, true, basis, tone, best, total,
                  stream);
}

// float32 compute, the three-term split: the rows bfloat16 (dtype 1, exact
// in bf16) or float32 (dtype 0, any 4-byte alignment, split into three bf16
// terms on load); basis: kernels._filterbank_any_basis for float32 (b0,
// then b1 and b2); the outputs as above. Returns cudaGetLastError().
extern "C" int anet_tone_energies_any_f32(const void* x, int dtype, int R, long long row_stride,
                                          int n_symbols, int sps, int m, const void* basis,
                                          void* energies, void* stream) {
  return dispatch(x, dtype, R, row_stride, n_symbols, sps, m, true, false, basis, energies, nullptr,
                  nullptr, stream);
}

extern "C" int anet_decide_tones_any_f32(const void* x, int dtype, int R, long long row_stride,
                                         int n_symbols, int sps, int m, const void* basis, void* tone,
                                         void* best, void* total, void* stream) {
  return dispatch(x, dtype, R, row_stride, n_symbols, sps, m, true, true, basis, tone, best, total,
                  stream);
}
