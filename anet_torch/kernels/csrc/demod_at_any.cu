// demod_at_any: the align+demod kernels (demod_at_fused,
// demod_at_energies_fused, and demod_probe_fused's demod) at every geometry
// the reference takes off demod_at.cu's compile-time walk, on Hopper's
// tensor cores.
//
// Replaces, at those geometries, the TPU kernels anet/kernels/__init__.py
// demod_at_fused (line 1992, pallas_call at line 2063, body _demod_at_kernel
// at line 1727), demod_at_energies_fused (line 1918, pallas_call at line
// 1971) and demod_probe_fused's demod (line 2307, pallas_call at line
// 2415). Their setup, _demod_at_setup (line 1840), needs only 128 % sps ==
// 0, at any tone count. demod_at.cu's walk fixes sps at compile time (32,
// 64 or 128, at most 16 tones: kernels._tensor_core_geometry); the rest of
// that set (sps 4, 8 and 16, and 32 or 64 tones at sps 64 and 128) comes
// here (kernels._demod_at_operands: route "at_any", counted under
// kernels.OFF_WALK_KEYS, demod_at_any).
//
// For stream b the data section starts at sample d0 = start[b] + pre of its
// row of a contiguous [B, len] buffer (bfloat16, int8 or float32, any
// alignment); symbol s is the sps samples from d0 + s * sps, zero outside
// [0, len). Per symbol the [sps, 2M] basis gives I and Q (int8: the x127
// integer basis, exact int32 sums), I*I + Q*Q of each tone rounded after
// each operation (common.cuh's tone_energy), then one of two epilogues:
// - decisions: tone (the first on ties), best and total, [B, n_symbols];
// - energies: every tone's energy, float32 [B, n_symbols, M].
//
// What bounds it on the H100: bytes. At sps 16 with 4 tones (payload 256's
// 1,072 symbols, B = 8,192) a stream's span is 17,152 samples: 0.14 GB of
// int8 (0.042 ms at 3.35 TB/s), 0.28 GB of bf16, 0.56 GB of float32; at sps
// 128 with 32 tones (429 symbols) 0.45 GB of int8 (0.134 ms). The products
// (64 columns of sps at 32 tones) take 0.02-0.05 ms in bf16 at the tensor
// cores' peak, about 0.35 ms as float32's six split products at 32 tones.
//
// Design: demod_core.cuh's walk (demod_at.cu's) with the geometry known at
// run time, in the reference's own layout (_demod_at_setup lines
// 1895-1906: r_syms = 128 / sps symbols a 128-sample row, a basis block a
// slot).
// - An A row is L = max(sps, E) consecutive samples of the span, E the
//   samples of an mma k-step (16 bf16 or float32, 32 int8): r = L / sps
//   whole symbols. A short symbol (sps 4, 8, 16 below E) shares its row with
//   the next r - 1, and the basis is block-diagonal: slot u's 2M columns
//   meet rows u sps .. (u + 1) sps - 1 only. 2M <= sps (the top tone below
//   Nyquist), so a row's r 2M columns are at most one k-step's: a row is
//   full, a symbol's samples are read once, no mask is needed, and the
//   symbols of a row come out as column groups. A row of sps >= E is one
//   symbol of sps / E k-steps.
// - The span read is demod_core.cuh's: each warp walks (stream, tile)
//   items, a tile 16 MT rows (MT m16 tiles, about 2 KB of samples), with
//   RING - 1 tiles' 16-byte cp.async copies in flight in its own ring
//   (STAGES; F32_RING for float32), copies aligned down to 16 bytes of the
//   flat buffer, the source size zero-filling past len, chunks wholly
//   outside the row reading nothing, bytes before the row's start zeroed
//   after the copy lands; a tile whose span lies within the row (all but a
//   stream's edges) copies whole chunks with no per-chunk bounds. Staged
//   rows are RB + 16 bytes (RB a row's bytes), so the 8 rows of an A
//   fragment lie in 8 distinct bank groups; a lane's bf16 or int8 A
//   register is the two aligned words around it joined by one
//   __funnelshift_r (a_frag's read), a float32 one two words split in
//   registers into three bf16 terms (a_split's). Every row of a tile has
//   the span's byte offset, so a lane's word offsets are set once a tile
//   (word_offsets): only a row's last k-step can reach past its pad.
// - Products, demod_core.cuh's in its order: bf16 samples one m16n8k16
//   (OneTerm's), int8 one m16n8k32 into int32 (the x127 integer basis,
//   exact), float32 the three-term split's six products, smallest first,
//   a0 b0 in an accumulator of its own (SplitTerms' and SharedTerms'
//   six_products).
// - B: kernels._demod_at_any_basis, packed once a config, dtype and device:
//   per group of tones, by (k-step, n-tile, lane), a lane's two words of b0
//   one 8-byte vector and, float32, its words of b1 and b2 one 16-byte
//   vector after all of b0. b0 is staged once a block in shared memory
//   before the rings (SharedTerms' staging; at most 32 KB, 64 tones at sps
//   128), behind the kernel's one __syncthreads: read through the read-only
//   cache each k-step instead, sps 128 with 32 tones took 0.65 ms for 0.59
//   (bf16, device, H100). float32's b1 and b2 (twice b0) stay in device
//   memory, read through the read-only cache.
// - Tones: past 32 (sps 128 with 64 tones) in groups of GROUP = 32, 8
//   n-tiles, over the same staged rows, folded in order into a running
//   (best, tone, total) with strict >, so the first tone wins a tie.
// - Epilogues: lane i of a quad holds the (I, Q) pair p = 4 t + i of
//   n-tile t: slot p / G, tone p % G (G the tones of a group). A slot's
//   tones span G / 4 n-tiles of all four lanes (G >= 4) or half an n-tile,
//   two lanes (G = 2): the decisions take each lane's argmax, best and sum
//   over its n-tiles of the slot (tones rise with t: strict > keeps the
//   first), then the slot's lanes' with xor shuffles (store_decisions'
//   fold); one lane of the slot stores it.
// The TPU kernel's 8-row-aligned span DMAs, sub-row selects and one-hot
// lane shifts existed only for the TPU's (8, 128) layout and are not
// carried over.
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
constexpr int STAGE_TARGET = 2048;   // bytes of samples a tile aims at, as demod_core.cuh's
constexpr int MAX_ROW = 512;         // a row's bytes at most: 128 float32 samples

// A warp's ring: 3 stages (2 tiles in flight, one read) for bf16 and int8
// buffers, F32_RING for float32 ones (their stages are twice as large), as
// demod_core.cuh's walks: with b0 beside the rings in shared memory,
// demod_core.cuh's 4 stages left 2 blocks an SM at sps 128 (32 tones, bf16:
// 0.59 ms against 0.48 at 3 stages, device, H100, time_search --kernels
// demod_at_any).
template <typename T>
__host__ __device__ constexpr int ring_depth() {
  return std::is_same<T, float>::value ? anet::demod::F32_RING : 3;
}

constexpr int MAX_BASIS = 2 * 8 * 8 * 32 * 8;  // b0 of 64 tones at 8 k-steps: 2 groups of 8 n-tiles
constexpr int MAX_SMEM = MAX_BASIS + WARPS * anet::demod::STAGES * (16 * (MAX_ROW + 16) + 16);

// The launch's geometry, all set on the host.
struct Geo {
  const unsigned char* buf;
  long long len;           // samples a row of the buffer
  const int32_t* start;    // [B] preamble starts
  int pre, n_symbols, m;
  int r;                   // symbols an A row
  int lsamp;               // samples an A row, r sps
  int rows;                // A rows a stream, ceil(n_symbols / r)
  int ks;                  // k-steps an A row
  int rb;                  // bytes of an A row (RB)
  int row;                 // bytes of a staged row, RB + 16
  int cps_shift;           // log2 of the 16-byte chunks a row, RB / 16
  int wps;                 // 32-bit words a row, RB / 4
  int mt;                  // m16 tiles a tile
  int chunks;              // chunks a tile: 16 mt rows of RB / 16, + the one an offset span runs into
  int stage;               // bytes of a ring stage, 16 mt row + 16
  int tiles;               // tiles a stream
  int items;               // B * tiles
  int gm, ng;              // tones a group, groups
  int gm_shift;            // log2(gm)
  const uint2* b0;         // [ng, ks, NT, 32] b0 words
  int b0_words;            // their count, staged in shared memory before the rings
  const uint4* b12;        // [ng, ks, NT, 32] b1 and b2 words (float32 buffers)
  void* out0;              // tone [B, S] int32, or energies [B, S, m]
  float* out1;             // best [B, S]
  float* out2;             // total [B, S]
};

// Item j: stream b, first A row r0 and live rows n of its tile, the tile's
// first sample's row position pos, its 16-byte-aligned chunk in the flat
// buffer and the span's byte offset rb into it.
struct Item {
  int b, r0, n, rb;
  long long pos;
  uintptr_t chunk0;
};

template <typename T>
__device__ __forceinline__ Item locate(const Geo& g, int j) {
  Item t;
  t.b = j / g.tiles;
  t.r0 = (j - t.b * g.tiles) * 16 * g.mt;
  t.n = min(16 * g.mt, g.rows - t.r0);
  t.pos = (long long)g.start[t.b] + g.pre + (long long)t.r0 * g.lsamp;
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(g.buf) + (uintptr_t)(((long long)t.b * g.len + t.pos) * (long long)sizeof(T));
  t.rb = (int)(at & 15);
  t.chunk0 = at - t.rb;
  return t;
}

// Start the copies of item j's span into a ring stage (chunk c into staged
// row c / (RB / 16)), then commit a group: an empty one past the last item,
// so every iteration commits one. demod_core.cuh's fetch, its row geometry
// at run time.
template <typename T>
__device__ __forceinline__ void fetch(const Geo& g, int j, unsigned char* stage, int lane) {
  constexpr int E = 16 / (int)sizeof(T);  // samples a chunk
  if (j < g.items) {
    const Item t = locate<T>(g, j);
    const int need = (t.rb + t.n * g.rb + 15) / 16;
    const long long p0 = t.pos - t.rb / (int)sizeof(T);  // row position of chunk 0's first sample
    const int cmask = (1 << g.cps_shift) - 1;
    if (p0 >= 0 && p0 + (long long)need * E <= g.len) {  // the span within the row: whole chunks
      for (int c = lane; c < g.chunks; c += 32) {
        const bool live = c < need;
        cp_async16(stage + (c >> g.cps_shift) * g.row + (c & cmask) * 16,
                   live ? reinterpret_cast<const void*>(t.chunk0 + 16 * (uintptr_t)c) : static_cast<const void*>(g.buf),
                   live ? 16 : 0);
      }
    } else {
      for (int c = lane; c < g.chunks; c += 32) {
        const long long p = p0 + (long long)c * E;
        const long long left = g.len - p;  // samples of the row from the chunk's first on
        const int bytes = (c < need && p + E > 0 && left > 0) ? (int)(left < E ? left : E) * (int)sizeof(T) : 0;
        const void* src = bytes ? reinterpret_cast<const void*>(t.chunk0 + 16 * (uintptr_t)c)
                                : static_cast<const void*>(g.buf);
        cp_async16(stage + (c >> g.cps_shift) * g.row + (c & cmask) * 16, src, bytes);
      }
    }
  }
  cp_async_commit();
}

// The byte offsets in a staged row of a lane's four words of a k-step, word
// x (x = x0 + 4 hk + w for bf16 and int8, x0 + 8 hk + w for float32, w = 0,
// 1) at 4 x, or past the row's 16 bytes of pad for x >= wps: only the last
// k-step of a row can reach past it (x0 < 8), so the others take 4 x + 32
// ks (64 ks for float32) of the first k-step's offsets.
template <bool F32>
__device__ __forceinline__ void word_offsets(int x0, int ks, int wps, int (&off)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int x = x0 + (F32 ? 16 : 8) * ks + (F32 ? 8 : 4) * (q >> 1) + (q & 1);
    off[q] = 4 * x + (x >= wps ? 16 : 0);
  }
}

// The epilogue of one m16 tile and tone group: e[t][h] is the energy of
// the group's (I, Q) pair p = 4 t + i of A row row0 + lane / 4 + 8 h: slot
// p / gm of the row (symbol row r + p / gm), tone grp gm + p % gm. The
// energies go to [B, S, m] at the group's columns (the slots of a row of
// r > 1 symbols are consecutive symbols of m tones: index row r m + p).
// The decisions fold each slot's tones over the lane's n-tiles, then the
// slot's lanes (both lanes of a pair at gm = 2, the quad past it), both
// rows h at once, then the groups into fb, ft, fs; after the last group
// one lane of the slot stores each row: lane h of the quad (h < 2), or
// lane i of a pair storing row i & 1, so a store covers the warp's rows.
template <int NT, bool DECIDE>
__device__ __forceinline__ void epilogue(const Geo& g, int b, int row0, int grp, const float (&e)[NT][2],
                                         float (&fb)[2], int (&ft)[2], float (&fs)[2]) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, i = lane & 3;
  const long long sym0 = (long long)(row0 + gq) * g.r;  // row h's first symbol: + 8 h r
  if constexpr (!DECIDE) {
    float* out = static_cast<float*>(g.out0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long s = sym0 + 8 * h * g.r;
      float* o = out + ((long long)b * g.n_symbols + s) * g.m + grp * g.gm;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int p = 4 * t + i;
        const int u = p >> g.gm_shift;
        if (u < g.r && s + u < g.n_symbols) o[p] = e[t][h];
      }
    }
  } else {
    const bool quad = g.gm >= 4;                 // a slot's tones span the quad (warp-uniform)
    const int tmask = (quad ? g.gm >> 2 : 1) - 1;  // n-tiles a slot spans in a lane, less one
    const int hs = quad ? i : (i & 1);           // the row this lane stores, if below 2
    float bq[2], tot[2];
    int bt[2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int p = 4 * t + i;
      const int c = p & (g.gm - 1);
      const bool first = (t & tmask) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (first) {
          bq[h] = e[t][h];
          bt[h] = c;
          tot[h] = e[t][h];
        } else {
          if (e[t][h] > bq[h]) {  // tones rise with t: a tie keeps the first
            bq[h] = e[t][h];
            bt[h] = c;
          }
          tot[h] += e[t][h];
        }
      }
      if ((t & tmask) != tmask) continue;  // the lane's n-tiles of the slot are in: the slot's lanes next
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        if (off == 1 || quad) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float oq = __shfl_xor_sync(0xffffffffu, bq[h], off);
            const int ot = __shfl_xor_sync(0xffffffffu, bt[h], off);
            tot[h] += __shfl_xor_sync(0xffffffffu, tot[h], off);
            if (anet::better(oq, ot, bq[h], bt[h])) {
              bq[h] = oq;
              bt[h] = ot;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (grp == 0) {
          fb[h] = bq[h];
          ft[h] = bt[h];
          fs[h] = tot[h];
        } else {
          if (bq[h] > fb[h]) {  // groups rise in tone: a tie keeps the earlier
            fb[h] = bq[h];
            ft[h] = grp * g.gm + bt[h];
          }
          fs[h] += tot[h];
        }
      }
      const int u = p >> g.gm_shift;
      const long long sym = sym0 + 8 * hs * g.r + u;
      if (grp == g.ng - 1 && hs < 2 && u < g.r && sym < g.n_symbols) {
        const long long o = (long long)b * g.n_symbols + sym;
        static_cast<int32_t*>(g.out0)[o] = hs ? ft[1] : ft[0];
        g.out1[o] = hs ? fb[1] : fb[0];
        g.out2[o] = hs ? fs[1] : fs[0];
      }
    }
  }
}

// T the buffer's samples: bf16 (one product), int8 (one product into
// int32), float32 (the three-term split, six products). NT n-tiles a group
// of columns; DECIDE: the decisions epilogue, else the energies.
template <typename T, int NT, bool DECIDE>
__global__ void __launch_bounds__(THREADS) demod_at_any_kernel(const Geo g) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr bool I8 = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<I8, int32_t, float>::type;
  constexpr int RING = ring_depth<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, i = lane & 3;
  uint2* sb0 = reinterpret_cast<uint2*>(smem);  // b0, one copy a block (SharedTerms' staging)
  unsigned char* ring = smem + 8 * g.b0_words + warp * RING * g.stage;
  const int step = gridDim.x * WARPS;
  int j = blockIdx.x * WARPS + warp;

#pragma unroll
  for (int s = 0; s < RING - 1; ++s) fetch<T>(g, j + s * step, ring + s * g.stage, lane);
  for (int w = threadIdx.x; w < g.b0_words; w += THREADS) sb0[w] = __ldg(g.b0 + w);
  __syncthreads();  // the only block-wide sync: before any warp's walk
  for (int it = 0; j < g.items; j += step, ++it) {
    fetch<T>(g, j + (RING - 1) * step, ring + ((it + RING - 1) % RING) * g.stage, lane);
    cp_async_wait<RING - 1>();
    __syncwarp();
    unsigned char* stage = ring + (it % RING) * g.stage;
    const Item t = locate<T>(g, j);
    if (t.pos < 0) {  // zero the span's bytes before the row's start
      const long long before = t.rb - t.pos * (long long)sizeof(T);
      const int z = before < g.chunks * 16 ? (int)before : g.chunks * 16;
      for (int y = lane; y < z; y += 32) stage[(y / g.rb) * g.row + y % g.rb] = 0;
      __syncwarp();
    }
    const int x0 = (t.rb >> 2) + (F32 ? 2 * i : i);  // the lane's first word of a k-step
    const int sh = 8 * (t.rb & 3);
    int first[4], last[4];  // the lane's word offsets in a row's first and last k-steps
    word_offsets<F32>(x0, 0, g.wps, first);
    word_offsets<F32>(x0, g.ks - 1, g.wps, last);
    for (int mt = 0; mt < g.mt && 16 * mt < t.n; ++mt) {
      const unsigned char* rows[2] = {stage + (16 * mt + gq) * g.row, stage + (16 * mt + gq + 8) * g.row};
      float fb[2], fs[2];
      int ft[2];
      for (int grp = 0; grp < g.ng; ++grp) {
        Acc big[NT][4];
        float small[F32 ? NT : 1][4];
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            big[u][v] = 0;
            if constexpr (F32) small[u][v] = 0.0f;
          }
        // the products of one k-step: the lane's words at off (+ add bytes) of
        // rows g and g + 8, the B words at bp0 (and bp12)
        auto kstep = [&](const int (&off)[4], int add, const uint2* bp0, const uint4* bp12) {  // bp0 in shared memory
          if constexpr (F32) {
            uint32_t a0[4], a1[4], a2[4];
#pragma unroll
            for (int hk = 0; hk < 2; ++hk)
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // samples x and x + 1 of rows g and g + 8
                const unsigned char* r = rows[h] + add;
                float lo = *reinterpret_cast<const float*>(r + off[2 * hk]);
                float hi = *reinterpret_cast<const float*>(r + off[2 * hk + 1]);
                a0[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
                a1[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
                a2[2 * hk + h] = bf16_pair(lo, hi, lo, hi);
              }
#pragma unroll
            for (int u = 0; u < NT; ++u) {  // SplitTerms' six products, smallest first
              const uint2 w = bp0[32 * u];
              const uint4 v = __ldg(bp12 + 32 * u);
              mma(small[u], a2, w.x, w.y);
              mma(small[u], a1, v.x, v.y);
              mma(small[u], a0, v.z, v.w);
              mma(small[u], a1, w.x, w.y);
              mma(small[u], a0, v.x, v.y);
              mma(big[u], a0, w.x, w.y);
            }
          } else {
            uint32_t a[4];
#pragma unroll
            for (int hk = 0; hk < 2; ++hk)
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // word x of rows g and g + 8 and the next, joined
                const unsigned char* r = rows[h] + add;
                a[2 * hk + h] = __funnelshift_r(*reinterpret_cast<const uint32_t*>(r + off[2 * hk]),
                                                *reinterpret_cast<const uint32_t*>(r + off[2 * hk + 1]), sh);
              }
#pragma unroll
            for (int u = 0; u < NT; ++u) {
              const uint2 w = bp0[32 * u];
              mma(big[u], a, w.x, w.y);
            }
          }
        };
        constexpr int KB = F32 ? 64 : 32;  // bytes of a k-step of a row
        const size_t b_first = (size_t)grp * g.ks * NT * 32 + lane;  // the group's first k-step
        for (int ks = 0; ks < g.ks - 1; ++ks)
          kstep(first, KB * ks, sb0 + b_first + ks * NT * 32, g.b12 + b_first + ks * NT * 32);
        kstep(last, 0, sb0 + b_first + (g.ks - 1) * NT * 32, g.b12 + b_first + (g.ks - 1) * NT * 32);
        float e[NT][2];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          if constexpr (F32) {
            e[u][0] = anet::tone_energy(big[u][0] + small[u][0], big[u][1] + small[u][1]);
            e[u][1] = anet::tone_energy(big[u][2] + small[u][2], big[u][3] + small[u][3]);
          } else {
            e[u][0] = anet::tone_energy((float)big[u][0], (float)big[u][1]);
            e[u][1] = anet::tone_energy((float)big[u][2], (float)big[u][3]);
          }
        }
        epilogue<NT, DECIDE>(g, t.b, t.r0 + 16 * mt, grp, e, fb, ft, fs);
      }
    }
    __syncwarp();  // the stage is read: the next iteration's copies may land in it
  }
  cp_async_wait<0>();
}

// Launch the instantiation with the geometry set, on stream st.
template <typename T, int NT, bool DECIDE>
cudaError_t run(Geo g, int B, cudaStream_t st) {
  auto kernel = demod_at_any_kernel<T, NT, DECIDE>;
  static int sms = 0;  // one per instantiation, set on its first launch
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  const int smem = 8 * g.b0_words + WARPS * ring_depth<T>() * g.stage;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)B * g.tiles;
  if (items > (1LL << 30)) return cudaErrorInvalidValue;  // the walk counts items in int
  g.items = (int)items;
  const long long blocks = (items + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm);
  kernel<<<grid, THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

template <typename T, bool DECIDE>
cudaError_t dispatch_tiles(int nt, const Geo& g, int B, cudaStream_t st) {
  if (nt == 1) return run<T, 1, DECIDE>(g, B, st);
  if (nt == 2) return run<T, 2, DECIDE>(g, B, st);
  if (nt == 4) return run<T, 4, DECIDE>(g, B, st);
  return run<T, 8, DECIDE>(g, B, st);
}

int dispatch(const void* buf, int dtype, int B, long long len, const void* start, int pre, int sps,
             int n_symbols, int m, bool decide, const void* basis, void* out0, void* out1, void* out2,
             void* stream) {
  const bool pow2 = m >= 2 && (m & (m - 1)) == 0;
  if (B < 0 || n_symbols < 0 || len < 0 || sps < 1 || 128 % sps || !pow2) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  if (dtype != anet::DTYPE_BF16 && dtype != anet::DTYPE_I8 && dtype != anet::DTYPE_F32)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == anet::DTYPE_I8 ? 1 : dtype == anet::DTYPE_BF16 ? 2 : 4;  // bytes a sample
  const int e = dtype == anet::DTYPE_I8 ? 32 : 16;                                    // samples a k-step
  Geo g{};
  g.buf = static_cast<const unsigned char*>(buf);
  g.len = len;
  g.start = static_cast<const int32_t*>(start);
  g.pre = pre;
  g.n_symbols = n_symbols;
  g.m = m;
  g.r = sps < e ? e / sps : 1;
  g.lsamp = g.r * sps;
  g.rows = (n_symbols + g.r - 1) / g.r;
  g.ks = g.lsamp / e;
  g.gm = g.r > 1 || m < GROUP ? m : GROUP;
  g.ng = m / g.gm;
  g.gm_shift = 0;
  while ((1 << g.gm_shift) < g.gm) ++g.gm_shift;
  const int cols = g.r * 2 * g.gm;  // a group's columns: r slots of 2 gm
  if (cols > 8 * 8) return (int)cudaErrorInvalidValue;  // more than 8 n-tiles: tones past Nyquist
  const int nt = cols <= 8 ? 1 : cols <= 16 ? 2 : cols <= 32 ? 4 : 8;
  g.rb = g.lsamp * esize;
  g.row = g.rb + 16;
  g.cps_shift = 0;
  while ((16 << g.cps_shift) < g.rb) ++g.cps_shift;
  g.wps = g.rb / 4;
  g.mt = 16 * g.rb >= STAGE_TARGET ? 1 : STAGE_TARGET / (16 * g.rb);
  g.chunks = 16 * g.mt * (g.rb / 16) + 1;
  g.stage = 16 * g.mt * g.row + 16;
  g.tiles = (g.rows + 16 * g.mt - 1) / (16 * g.mt);
  g.b0 = static_cast<const uint2*>(basis);
  g.b0_words = g.ng * g.ks * nt * 32;
  g.b12 = reinterpret_cast<const uint4*>(g.b0 + g.b0_words);
  g.out0 = out0;
  g.out1 = static_cast<float*>(out1);
  g.out2 = static_cast<float*>(out2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16)
    return decide ? (int)dispatch_tiles<__nv_bfloat16, true>(nt, g, B, st)
                  : (int)dispatch_tiles<__nv_bfloat16, false>(nt, g, B, st);
  if (dtype == anet::DTYPE_I8)
    return decide ? (int)dispatch_tiles<int8_t, true>(nt, g, B, st) : (int)dispatch_tiles<int8_t, false>(nt, g, B, st);
  return decide ? (int)dispatch_tiles<float, true>(nt, g, B, st) : (int)dispatch_tiles<float, false>(nt, g, B, st);
}

}  // namespace

// buf: [B, len] contiguous, bfloat16 (dtype 1), int8 (2) or float32 (0),
// any alignment; start: [B] int32 preamble starts; sps dividing 128; m a
// power of two >= 2 tones; basis: kernels._demod_at_any_basis for the
// buffer's dtype; tone: [B, n_symbols] int32; best, total: [B, n_symbols]
// float32. The arguments of demod_at.cu's anet_demod_at. Returns
// cudaGetLastError().
extern "C" int anet_demod_at_any(const void* buf, int dtype, int B, long long len, const void* start, int pre,
                                 int sps, int n_symbols, int m, const void* basis, void* tone, void* best,
                                 void* total, void* stream) {
  return dispatch(buf, dtype, B, len, start, pre, sps, n_symbols, m, true, basis, tone, best, total, stream);
}

// The same buffer, starts and basis; energies: [B, n_symbols, m] float32.
// The arguments of demod_at_energies.cu's anet_demod_at_energies. Returns
// cudaGetLastError().
extern "C" int anet_demod_at_energies_any(const void* buf, int dtype, int B, long long len, const void* start,
                                          int pre, int sps, int n_symbols, int m, const void* basis,
                                          void* energies, void* stream) {
  return dispatch(buf, dtype, B, len, start, pre, sps, n_symbols, m, false, basis, energies, nullptr, nullptr,
                  stream);
}
