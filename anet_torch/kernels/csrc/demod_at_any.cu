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
// int8 (0.042 ms at 3.35 TB/s; the decisions' 12 bytes a symbol add 0.11
// GB), 0.28 GB of bf16, 0.56 GB of float32; at sps 128 with 32 tones (429
// symbols) 0.45 GB of int8 (0.134 ms). The products (64 columns of sps at
// 32 tones) take 0.02-0.05 ms in bf16 at the tensor cores' peak, about
// 0.35 ms as float32's six split products at 32 tones.
//
// Layout, the reference's own (_demod_at_setup lines 1895-1906: r_syms =
// 128 / sps symbols a 128-sample row, a basis block a slot): an A row is
// L = max(sps, E) consecutive samples of the span, E the samples of an mma
// k-step (16 bf16 or float32, 32 int8): r = L / sps whole symbols. A short
// symbol (sps 4, 8, 16 below E) shares its row with the next r - 1, and
// the basis is block-diagonal: slot u's 2M columns meet rows u sps .. (u +
// 1) sps - 1 only. 2M <= sps (the top tone below Nyquist), so a row's r 2M
// columns are at most one k-step's: a row is full, a symbol's samples are
// read once, no mask is needed. A row of sps >= E is one symbol of sps / E
// k-steps, its tones in groups of GROUP = 32 (8 n-tiles).
//
// Design: one instantiation for each (sample type, KS k-steps an A row, NT
// n-tiles a group, epilogue), the pairs kernels._demod_at_any_geometry
// gives (KS, NT in 1, 2, 4, 8), so the row's geometry, the k-step and
// n-tile loops and the A word offsets are constants; r, the tones a group
// and the groups stay at run time (shifts and masks).
// - Items: each warp walks (stream, tile) items, a tile MT m16 tiles of A
//   rows (about STAGE_TARGET bytes of samples), advancing its stream and
//   tile by the launch's step (no division past the first item). Each
//   item's span goes into the warp's ring (RING stages; RING - 1 items in
//   flight) by 16-byte cp.async copies aligned down to 16 bytes of the flat
//   buffer, the copy loop unrolled with constant offsets; a span within the
//   row copies whole chunks with no bounds; at a stream's edges the source
//   size zero-fills past len, chunks wholly outside the row read nothing,
//   bytes before the row's start are zeroed after the copy lands. Staged
//   rows are RB + 16 bytes (RB a row's bytes), so the 8 rows of an A
//   fragment lie in 8 distinct bank groups; a lane's bf16 or int8 A
//   register is the two aligned words around it joined by one
//   __funnelshift_r, a float32 one two words split in registers into three
//   bf16 terms. Only a row's last k-step can reach past its pad: its four
//   offsets are set once an item, the others are constants.
// - B: kernels._demod_at_any_basis, a lane's two words of b0 one 8-byte
//   vector by (group, k-step, n-tile, lane) and, float32, its words of b1
//   and b2 one 16-byte vector after all of b0. Where KS NT <= 8 (2 for
//   float32: the short symbols) every word of B stays in a lane's registers
//   for the whole walk; past that b0 is staged once a block in shared
//   memory behind the kernel's one __syncthreads. Each B fragment meets U =
//   2 m16 tiles of an item (one where an item is one m16 tile) before the
//   next.
// - float32 rows of one symbol at 8 n-tiles (32 tones at sps 64 and 128):
//   a pair of warps shares each item, its ring and its 8.4 KB stages (sps
//   128), each warp taking 4 n-tiles, the pair synced by a named barrier;
//   b1 and b2 lie in shared memory beside b0, and a block takes as many
//   pairs as fit (8 at 32 tones: 16 warps an SM). One warp an item with b1
//   and b2 read through the read-only cache left 8 warps an SM and took
//   1.28 ms at sps 128 (decisions, B = 8,192, device, H100; the same pair
//   with b1 and b2 in the L1 that 4 blocks' rings leave, 1.32; this
//   design 1.03-1.07).
// - Products, demod_core.cuh's in its order: bf16 samples one m16n8k16,
//   int8 one m16n8k32 into int32 (the x127 integer basis, exact), float32
//   the three-term split's six products smallest first, a0 b0 in an
//   accumulator of its own; each product issued for every (m16 tile,
//   n-tile) before the next, so no accumulator waits on its own last
//   product.
// - Epilogue, through a scratch of the warp in shared memory: the lanes
//   write the energies of a batch's U m16 tiles (at most 4 n-tiles a pass;
//   a warp's 8 n-tiles take two passes of 16 tones), then each lane takes
//   whole symbols (two lanes a symbol where a batch holds 16): the
//   decisions fold its tones in order (strict >: the first tone wins a
//   tie; passes and groups, which rise in tone, folded after; a pair's
//   second warp hands its higher tones' decisions to the first through
//   shared memory), and consecutive lanes store consecutive symbols; the
//   energies go out as 16-byte (8-byte at 2 tones) vectors, consecutive
//   lanes at consecutive addresses.
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

constexpr int WARPS = 4;                       // warps a block, but where pairs of warps share items
constexpr int GROUP = 32;                      // tones a group: 8 n8 tiles of 4 tones' (I, Q)
constexpr int STAGE_TARGET = 2048;             // bytes of samples an item aims at, as demod_core.cuh's
constexpr int MAX_BASIS = 2 * 8 * 8 * 32 * 8;  // b0 of 64 tones at 8 k-steps: 2 groups of 8 n-tiles
constexpr int BLOCK_SMEM = 232448;             // a block's dynamic shared memory at most (sm_90)

// The walk's geometry for samples of T, KS k-steps an A row and NT n-tiles
// a group, in bytes where not said.
template <typename T, int KS, int NT>
struct Walk {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool I8 = std::is_same<T, int8_t>::value;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int KB = (I8 ? 32 : 16) * ES;  // a k-step of a row: 32, float32 64
  static constexpr int RB = KS * KB;               // an A row
  static constexpr int ROW = RB + 16;              // a staged row, with its pad
  static constexpr int CPS = RB / 16;              // 16-byte chunks a row: divides 32
  static constexpr int WPS = RB / 4;               // 32-bit words a row
  static constexpr int WK = KB / 4;                // words a k-step of a row
  // m16 tiles an item: about STAGE_TARGET bytes, and 2 at bf16 and int8
  // rows of 128 bytes (int8 at sps 128: 0.215 ms against 0.256 at one,
  // device, B = 8,192, H100, time_search --kernels demod_at_any), whose B
  // fragments then meet two m16 tiles; short rows keep 2 KB items (4 KB
  // ones took 0.134 ms against 0.121 at sps 16, int8: fewer warps an SM)
  static constexpr int MT = 16 * RB >= STAGE_TARGET ? (!F32 && RB <= 128 ? 2 : 1) : STAGE_TARGET / (16 * RB);
  static constexpr int ROWS = 16 * MT;             // A rows an item
  static constexpr int CHUNKS = ROWS * CPS + 1;    // + the chunk an offset span runs into
  static constexpr int STAGE = ROWS * ROW + 16;    // a ring stage
  // 3 stages (2 items in flight, one read) for bf16 and int8 buffers,
  // F32_RING for float32 ones (their stages are twice as large), as
  // demod_core.cuh's walks
  static constexpr int RING = F32 ? anet::demod::F32_RING : 3;
  // Warps an item (a team): 2 for float32 rows of one symbol at 8 n-tiles,
  // each taking 4 n-tiles of the item's one m16 tile from a ring the pair
  // shares (one warp a ring of 8.4 KB stages left 8 warps an SM at sps
  // 128), else 1.
  static constexpr int P = F32 && NT == 8 && KS > 1 ? 2 : 1;
  static constexpr int NTW = NT / P;                // n-tiles a warp
  // Where a pair shares an item, b1 and b2 lie in shared memory beside b0
  // (read through the read-only cache, 32 KB at sps 128 met an L1 of what
  // the rings leave), and a block takes as many pairs as fit, at most 8:
  // one block of 16 warps an SM at 32 tones.
  static constexpr bool B12S = P > 1;
  static constexpr int MAX_TEAMS = P > 1 ? 8 : WARPS;  // teams a block, at most
  static constexpr int MAX_THREADS = 32 * P * MAX_TEAMS;
  static constexpr int U = MT >= 2 && !(F32 && NT == 8) ? 2 : 1;  // m16 tiles a B fragment meets
  static constexpr bool BREG = KS * NT <= (F32 ? 2 : 8);         // B in registers for the walk
  // n-tiles an epilogue pass: a warp's 8 n-tiles of a row of one symbol
  // (KS > 1) take two, 16 tones each
  static constexpr int NTE = NTW < 4 || KS == 1 ? NTW : 4;
  static constexpr int PASSES = NTW / NTE;          // a warp's passes
  static constexpr int GUS = NTE == 1 ? 2 : NTE == 2 ? 3 : NTE == 4 ? 4 : 5;  // log2(4 NTE)
  static constexpr int PP = NTE == 1 ? 12 : 4 * NTE + 4;  // floats a scratch row: 8 rows in 8 bank groups
  static constexpr int SCRATCH = 16 * U * PP * 4;   // a warp's
  static constexpr int MERGE = P > 1 ? 16 * U * 16 : 0;  // a team's decisions passed between its warps
  static constexpr int TEAM_SMEM = RING * STAGE + P * SCRATCH + MERGE;
  // Blocks an SM that shared memory leaves at one group of tones (228 KB an
  // SM, 1 KB reserved a block), at most 4: the launch bound that lets each
  // thread take the registers that occupancy leaves, 128 or more (ptxas
  // otherwise held bf16's sps-128 decisions to 72 registers for an
  // occupancy the rings never reach: 0.477 ms against 0.400, device, B =
  // 8,192, H100, time_search --kernels demod_at_any).
  static constexpr int SMEM_BLOCKS = 233472 / ((BREG ? 0 : 8 * KS * NT * 32) + MAX_TEAMS * TEAM_SMEM + 1024);
  static constexpr int MIN_BLOCKS = P > 1 || SMEM_BLOCKS < 1 ? 1 : SMEM_BLOCKS < 4 ? SMEM_BLOCKS : 4;
  static constexpr int MAX_SMEM = P > 1 ? BLOCK_SMEM : (BREG ? 0 : MAX_BASIS) + MAX_TEAMS * TEAM_SMEM;
  static_assert(32 % CPS == 0 && RB % 32 == 0, "a row must be whole chunks dividing a warp's");
};

// The launch's geometry, all set on the host.
struct Geo {
  const unsigned char* buf;
  long long len;           // samples a row of the buffer
  const int32_t* start;    // [B] preamble starts
  int streams;             // B
  int pre, n_symbols, m;
  int r, rs;               // symbols an A row, log2(r)
  int lsamp;               // samples an A row, r sps
  int rows;                // A rows a stream, ceil(n_symbols / r)
  int tiles;               // items a stream
  int gm, gs, ng;          // tones a group, log2(gm), groups
  int step_b, step_t;      // a team's step between items, gridDim.x teams a block, in streams and items
  const uint2* b0;         // [ng, KS, NT, 32] b0 words
  int b0_words;            // their count
  const uint4* b12;        // [ng, KS, NT, 32] b1 and b2 words (float32 buffers)
  void* out0;              // tone [B, S] int32, or energies [B, S, m]
  float* out1;             // best [B, S]
  float* out2;             // total [B, S]
};

// An item: stream b, tile of the stream.
struct Cursor {
  int b, tile;
};

__device__ __forceinline__ void advance(const Geo& g, Cursor& c) {
  c.tile += g.step_t;
  c.b += g.step_b;
  if (c.tile >= g.tiles) {
    c.tile -= g.tiles;
    ++c.b;
  }
}

// The row position of an item's first sample, from its stream's start.
template <typename W>
__device__ __forceinline__ long long item_pos(const Geo& g, const Cursor& c, int start) {
  return (long long)start + g.pre + (long long)c.tile * (W::ROWS * g.lsamp);
}

template <typename W>
__device__ __forceinline__ uintptr_t item_address(const Geo& g, const Cursor& c, long long pos) {
  return reinterpret_cast<uintptr_t>(g.buf) + (uintptr_t)(((long long)c.b * g.len + pos) * W::ES);
}

// A team's barrier: its warp, or bar.sync of the pair's 64 threads (barrier
// 1 + team; 0 is __syncthreads').
template <typename W>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (W::P == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * W::P) : "memory");
  }
}

// Start the copies of item c's span into a ring stage (chunk ch into staged
// row ch / CPS), the team's thread tl taking chunks tl, tl + 32 P, ...;
// then commit a group: an empty one past the last item, so every
// iteration commits one.
template <typename W>
__device__ __forceinline__ void fetch(const Geo& g, const Cursor& c, unsigned char* stage, int tl) {
  constexpr int CE = 16 / W::ES;                 // samples a chunk
  constexpr int N = 32 * W::P;                   // the team's threads
  constexpr int DROW = N / W::CPS * W::ROW;      // staged bytes from chunk ch to ch + N
  if (c.b < g.streams) {
    const long long pos = item_pos<W>(g, c, __ldg(g.start + c.b));
    const uintptr_t at = item_address<W>(g, c, pos);
    const int rb = (int)(at & 15);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(at - rb) + 16 * tl;
    unsigned char* dst = stage + (tl / W::CPS) * W::ROW + (tl % W::CPS) * 16;
    const long long p0 = pos - rb / W::ES;  // row position of chunk 0's first sample
    if (p0 >= 0 && p0 + (long long)W::CHUNKS * CE <= g.len) {  // the span within the row: whole chunks
#pragma unroll
      for (int k = 0; k < (W::CHUNKS + N - 1) / N; ++k)
        if (tl + N * k < W::CHUNKS) cp_async16(dst + k * DROW, src + 16 * N * k, 16);
    } else {
#pragma unroll
      for (int k = 0; k < (W::CHUNKS + N - 1) / N; ++k) {
        const long long p = p0 + (long long)(tl + N * k) * CE;
        const long long left = g.len - p;  // samples of the row from the chunk's first on
        const int bytes = (p + CE > 0 && left > 0) ? (int)(left < CE ? left : CE) * W::ES : 0;
        if (tl + N * k < W::CHUNKS)
          cp_async16(dst + k * DROW,
                     bytes ? static_cast<const void*>(src + 16 * N * k) : static_cast<const void*>(g.buf), bytes);
      }
    }
  }
  cp_async_commit();
}

// Tone c of energy e into the decisions so far (tones in rising order:
// strict >, so the first wins a tie).
__device__ __forceinline__ void take(float e, int c, float& best, int& tone, float& total) {
  if (e > best) {
    best = e;
    tone = c;
  }
  total += e;
}

// The decisions of n tones of one symbol from s (their energies, >= 0, in
// tone order): the first largest (tone relative to s), largest, sum.
__device__ __forceinline__ void fold_tones(const float* s, int n, float& best, int& tone, float& total) {
  best = -1.0f;
  tone = 0;
  total = 0.0f;
  if ((n & 3) == 0) {  // 16-byte reads
    for (int c = 0; c < n; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + c);
      take(v.x, c, best, tone, total);
      take(v.y, c + 1, best, tone, total);
      take(v.z, c + 2, best, tone, total);
      take(v.w, c + 3, best, tone, total);
    }
  } else {
    for (int c = 0; c < n; ++c) take(s[c], c, best, tone, total);
  }
}

// T the buffer's samples: bf16 (one product), int8 (one product into
// int32), float32 (the three-term split, six products). KS k-steps an A
// row, NT n-tiles a group of columns; DECIDE: the decisions epilogue, else
// the energies.
template <typename T, int KS, int NT, bool DECIDE>
__global__ void __launch_bounds__(Walk<T, KS, NT>::MAX_THREADS, Walk<T, KS, NT>::MIN_BLOCKS)
    demod_at_any_kernel(const Geo g) {
  using W = Walk<T, KS, NT>;
  constexpr bool F32 = W::F32;
  constexpr int U = W::U, NTW = W::NTW;
  using Acc = typename std::conditional<W::I8, int32_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / W::P, pw = warp % W::P;  // the warp's team, and its place there
  const int tl = 32 * pw + lane;                   // the thread's place in its team
  const int gq = lane >> 2, i = lane & 3;
  const uint2* sb0 = reinterpret_cast<const uint2*>(smem);  // b0 past the registers, one copy a block
  const uint4* sb12 = reinterpret_cast<const uint4*>(smem + 8 * g.b0_words);  // and b1, b2 (B12S)
  unsigned char* ring = smem + (W::BREG ? 0 : 8 * g.b0_words * (W::B12S ? 3 : 1)) + team * W::TEAM_SMEM;
  float* scratch = reinterpret_cast<float*>(ring + W::RING * W::STAGE + pw * W::SCRATCH);
  float4* merge = reinterpret_cast<float4*>(ring + W::RING * W::STAGE + W::P * W::SCRATCH);

  const int j0 = blockIdx.x * (blockDim.x / (32 * W::P)) + team;
  Cursor cons{j0 / g.tiles, j0 % g.tiles};
  Cursor prod = cons;
#pragma unroll
  for (int s = 0; s < W::RING - 1; ++s) {
    fetch<W>(g, prod, ring + s * W::STAGE, tl);
    advance(g, prod);
  }
  uint2 b0r[W::BREG ? KS : 1][W::BREG ? NT : 1];
  uint4 b12r[W::BREG && F32 ? KS : 1][W::BREG && F32 ? NT : 1];
  auto load_b = [&](int grp) {  // group grp's B words into registers
    if constexpr (W::BREG) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int w = ((grp * KS + ks) * NT + t) * 32 + lane;
          b0r[ks][t] = __ldg(g.b0 + w);
          if constexpr (F32) b12r[ks][t] = __ldg(g.b12 + w);
        }
    }
  };
  if constexpr (W::BREG) {
    load_b(0);
  } else {
    uint2* s = reinterpret_cast<uint2*>(smem);  // b0, then (B12S) b1 and b2: one contiguous operand
    for (int w = threadIdx.x; w < g.b0_words * (W::B12S ? 3 : 1); w += blockDim.x) s[w] = __ldg(g.b0 + w);
  }
  __syncthreads();  // the only block-wide sync: before any warp's walk
  int start = cons.b < g.streams ? __ldg(g.start + cons.b) : 0;

  for (int it = 0; cons.b < g.streams; ++it) {
    fetch<W>(g, prod, ring + ((it + W::RING - 1) % W::RING) * W::STAGE, tl);
    advance(g, prod);
    Cursor next = cons;
    advance(g, next);
    const int start_next = next.b < g.streams ? __ldg(g.start + next.b) : 0;
    cp_async_wait<W::RING - 1>();
    team_sync<W>(team);  // every copy of the team into the stage has landed
    unsigned char* stage = ring + (it % W::RING) * W::STAGE;
    const long long pos = item_pos<W>(g, cons, start);
    const int rb = (int)(item_address<W>(g, cons, pos) & 15);
    if (pos < 0) {  // zero the span's bytes before the row's start
      const long long before = rb - pos * W::ES;
      const int z = before < W::CHUNKS * 16 ? (int)before : W::CHUNKS * 16;
      for (int y = tl; y < z; y += 32 * W::P) stage[(y / W::RB) * W::ROW + y % W::RB] = 0;
      team_sync<W>(team);
    }
    const int r0 = cons.tile * W::ROWS;  // the item's first A row
    const int n = min(W::ROWS, g.rows - r0);
    const int x0 = (rb >> 2) + (F32 ? 2 * i : i);  // the lane's first word of a k-step
    const int sh = 8 * (rb & 3);
    const int lo = 4 * x0;                         // its byte in a row, k-steps before the last
    int last[4];  // the lane's four word offsets in a row's last k-step, past the pad where x >= WPS
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int x = x0 + W::WK * (KS - 1) + (F32 ? 8 : 4) * (q >> 1) + (q & 1);
      last[q] = 4 * x + (x >= W::WPS ? 16 : 0);
    }
    auto offset = [&](int ks, int q) {  // word q (2 hk + w) of k-step ks
      return ks < KS - 1 ? lo + W::KB * ks + 4 * ((F32 ? 8 : 4) * (q >> 1) + (q & 1)) : last[q];
    };
    auto b_index = [&](int grp, int ks, int t) {  // the lane's B vector of (group, k-step, the warp's n-tile t)
      return ((grp * KS + ks) * NT + pw * NTW + t) * 32 + lane;
    };
    auto b0_of = [&](int grp, int ks, int t) {
      if constexpr (W::BREG) return b0r[ks][t];
      else return sb0[b_index(grp, ks, t)];
    };

#pragma unroll 1
    for (int ub = 0; ub < W::MT / U; ++ub) {
      if (16 * U * ub >= n) break;
      const unsigned char* rp[U][2];  // rows g and g + 8 of each m16 tile of the batch
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) rp[u][h] = stage + (16 * (U * ub + u) + gq + 8 * h) * W::ROW;
      const int nsym = (16 * U) << g.rs;  // symbols of the batch
      const int lps = nsym >= 32 ? 1 : 2;  // lanes a symbol in the epilogue
      const int half = lane & (lps - 1);
      float fb = 0.0f, fs = 0.0f;  // decisions of the lane's symbol over passes and groups (r = 1)
      int ft = 0;
#pragma unroll 1
      for (int grp = 0; grp < g.ng; ++grp) {
        if (W::BREG && g.ng > 1) load_b(grp);  // the registers hold one group's B
        Acc big[U][NTW][4];
        float small[F32 ? U : 1][F32 ? NTW : 1][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int t = 0; t < NTW; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              big[u][t][v] = 0;
              if constexpr (F32) small[u][t][v] = 0.0f;
            }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if constexpr (F32) {
            uint32_t a0[U][4], a1[U][4], a2[U][4];
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int hk = 0; hk < 2; ++hk)
#pragma unroll
                for (int h = 0; h < 2; ++h) {  // samples x and x + 1 of rows g and g + 8
                  float x = *reinterpret_cast<const float*>(rp[u][h] + offset(ks, 2 * hk));
                  float y = *reinterpret_cast<const float*>(rp[u][h] + offset(ks, 2 * hk + 1));
                  a0[u][2 * hk + h] = bf16_pair(x, y, x, y);
                  a1[u][2 * hk + h] = bf16_pair(x, y, x, y);
                  a2[u][2 * hk + h] = bf16_pair(x, y, x, y);
                }
            uint2 w[NTW];
            uint4 v[NTW];
#pragma unroll
            for (int t = 0; t < NTW; ++t) {
              w[t] = b0_of(grp, ks, t);
              if constexpr (W::BREG) v[t] = b12r[ks][t];
              else if constexpr (W::B12S) v[t] = sb12[b_index(grp, ks, t)];
              else v[t] = __ldg(g.b12 + b_index(grp, ks, t));
            }
            // SplitTerms' six products, smallest first, each over every
            // (tile, n-tile) before the next
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int t = 0; t < NTW; ++t) mma(small[u][t], a2[u], w[t].x, w[t].y);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int t = 0; t < NTW; ++t) mma(small[u][t], a1[u], v[t].x, v[t].y);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int t = 0; t < NTW; ++t) mma(small[u][t], a0[u], v[t].z, v[t].w);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int t = 0; t < NTW; ++t) mma(small[u][t], a1[u], w[t].x, w[t].y);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int t = 0; t < NTW; ++t) mma(small[u][t], a0[u], v[t].x, v[t].y);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int t = 0; t < NTW; ++t) mma(big[u][t], a0[u], w[t].x, w[t].y);
          } else {
            uint2 w[NTW];
#pragma unroll
            for (int t = 0; t < NTW; ++t) w[t] = b0_of(grp, ks, t);
            uint32_t a[U][4];
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int hk = 0; hk < 2; ++hk)
#pragma unroll
                for (int h = 0; h < 2; ++h)  // word x of rows g and g + 8 and the next, joined
                  a[u][2 * hk + h] =
                      __funnelshift_r(*reinterpret_cast<const uint32_t*>(rp[u][h] + offset(ks, 2 * hk)),
                                      *reinterpret_cast<const uint32_t*>(rp[u][h] + offset(ks, 2 * hk + 1)), sh);
#pragma unroll
            for (int t = 0; t < NTW; ++t)
#pragma unroll
              for (int u = 0; u < U; ++u) mma(big[u][t], a[u], w[t].x, w[t].y);
          }
        }

        const int gus = g.gs < W::GUS ? g.gs : W::GUS;  // log2 of a slot's tones in a pass
        const int gu = 1 << gus;
#pragma unroll
        for (int pass = 0; pass < W::PASSES; ++pass) {
          // scratch row 16 u + g + 8 h, column 4 t + i: the energy of pair
          // 4 t + i of the pass, slot (4 t + i) / gu, tone (4 t + i) % gu
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int tt = 0; tt < W::NTE; ++tt) {
              const int t = pass * W::NTE + tt;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float e;
                if constexpr (F32)
                  e = anet::tone_energy(big[u][t][2 * h] + small[u][t][2 * h],
                                        big[u][t][2 * h + 1] + small[u][t][2 * h + 1]);
                else
                  e = anet::tone_energy((float)big[u][t][2 * h], (float)big[u][t][2 * h + 1]);
                scratch[(16 * u + gq + 8 * h) * W::PP + 4 * tt + i] = e;
              }
            }
          __syncwarp();
          const int tone0 = grp * g.gm + (pw * W::PASSES + pass) * gu;  // the pass's first tone
          const long long sym0 = (long long)(r0 + 16 * U * ub) << g.rs;  // the batch's first symbol
          if constexpr (DECIDE) {
            const int per = gu / lps;  // tones a lane folds
            const bool carry = g.ng > 1 || W::P * W::PASSES > 1;  // (r = 1: one symbol a lane or pair)
            for (int s0 = 0; s0 < nsym; s0 += 32 / lps) {
              const int sg = s0 + lane / lps;
              const int row = sg >> g.rs, slot = sg & (g.r - 1);
              float bq, tot;
              int bt;
              fold_tones(scratch + row * W::PP + slot * gu + half * per, per, bq, bt, tot);
              bt += half * per;
              if (lps == 2) {  // the pair's halves, the lower tones first
                const float oq = __shfl_xor_sync(0xffffffffu, bq, 1);
                const int ot = __shfl_xor_sync(0xffffffffu, bt, 1);
                tot += __shfl_xor_sync(0xffffffffu, tot, 1);
                if (anet::better(oq, ot, bq, bt)) {
                  bq = oq;
                  bt = ot;
                }
              }
              bt += tone0;
              if (carry && (grp > 0 || pass > 0)) {  // a warp's passes and groups rise in tone: a tie keeps the earlier
                if (bq > fb) {
                  fb = bq;
                  ft = bt;
                }
                fs += tot;
              } else {
                fb = bq;
                ft = bt;
                fs = tot;
              }
              if (grp < g.ng - 1 || pass < W::PASSES - 1) continue;
              if constexpr (W::P > 1) {  // the team's second warp holds the higher tones of each group
                if (pw == 1 && half == 0) merge[sg] = make_float4(fb, __int_as_float(ft), fs, 0.0f);
                team_sync<W>(team);
                if (pw == 1) continue;
                const float4 o = merge[sg];
                if (anet::better(o.x, __float_as_int(o.y), fb, ft)) {
                  fb = o.x;
                  ft = __float_as_int(o.y);
                }
                fs += o.z;
              }
              const long long sym = sym0 + sg;
              if (half == 0 && sym < g.n_symbols) {
                const long long o = (long long)cons.b * g.n_symbols + sym;
                static_cast<int32_t*>(g.out0)[o] = ft;
                g.out1[o] = fb;
                g.out2[o] = fs;
              }
            }
          } else {
            float* out = static_cast<float*>(g.out0);
            const long long base = (long long)cons.b * g.n_symbols;
            if (gu >= 4) {  // 16-byte pieces: piece q of the batch, r gu / 4 a scratch row
              const int ps = g.rs + gus - 2;  // log2 of the pieces a row
              for (int q = lane; q < (16 * U) << ps; q += 32) {
                const int row = q >> ps, c = 4 * (q & ((1 << ps) - 1));
                const long long sym = sym0 + ((long long)row << g.rs) + (c >> gus);
                if (sym < g.n_symbols)
                  *reinterpret_cast<float4*>(out + (base + sym) * g.m + tone0 + (c & (gu - 1))) =
                      *reinterpret_cast<const float4*>(scratch + row * W::PP + c);
              }
            } else {  // 2 tones: 8-byte pieces, a symbol each
              for (int q = lane; q < nsym; q += 32) {
                const int row = q >> g.rs, slot = q & (g.r - 1);
                const long long sym = sym0 + q;
                if (sym < g.n_symbols)
                  *reinterpret_cast<float2*>(out + (base + sym) * g.m + tone0) =
                      *reinterpret_cast<const float2*>(scratch + row * W::PP + 2 * slot);
              }
            }
          }
          __syncwarp();  // the scratch is read: the next pass may write it
        }
      }
    }
    team_sync<W>(team);  // the stage is read: the next iteration's copies may land in it
    cons = next;
    start = start_next;
  }
  cp_async_wait<0>();
}

// The geometry of a launch (all but the step), and its KS and NT.
cudaError_t make_geo(Geo& g, int& ks, int& nt, int dtype, int B, long long len, int pre, int sps, int n_symbols,
                     int m) {
  const bool pow2 = m >= 2 && (m & (m - 1)) == 0;
  if (B < 0 || n_symbols < 0 || len < 0 || sps < 1 || 128 % sps || !pow2) return cudaErrorInvalidValue;
  if (dtype != anet::DTYPE_BF16 && dtype != anet::DTYPE_I8 && dtype != anet::DTYPE_F32) return cudaErrorInvalidValue;
  const int e = dtype == anet::DTYPE_I8 ? 32 : 16;  // samples a k-step
  g = Geo{};
  g.len = len;
  g.streams = B;
  g.pre = pre;
  g.n_symbols = n_symbols;
  g.m = m;
  g.r = sps < e ? e / sps : 1;
  g.rs = 0;
  while ((1 << g.rs) < g.r) ++g.rs;
  g.lsamp = g.r * sps;
  g.rows = (n_symbols + g.r - 1) / g.r;
  ks = g.lsamp / e;
  g.gm = g.r > 1 || m < GROUP ? m : GROUP;
  g.ng = m / g.gm;
  g.gs = 0;
  while ((1 << g.gs) < g.gm) ++g.gs;
  const int cols = g.r * 2 * g.gm;  // a group's columns: r slots of 2 gm
  if (cols > 8 * 8) return cudaErrorInvalidValue;  // more than 8 n-tiles: tones past Nyquist
  nt = cols <= 8 ? 1 : cols <= 16 ? 2 : cols <= 32 ? 4 : 8;
  g.b0_words = g.ng * ks * nt * 32;
  return cudaSuccess;
}

// The block of a launch of the instantiation: its teams (pairs of warps:
// as many as fit, at most MAX_TEAMS) and shared memory; false where B
// does not fit.
template <typename T, int KS, int NT>
bool block_of(const Geo& g, int& teams, int& smem) {
  using W = Walk<T, KS, NT>;
  const int basis = W::BREG ? 0 : 8 * g.b0_words * (W::B12S ? 3 : 1);
  if (!W::BREG && 8 * g.b0_words > MAX_BASIS) return false;
  teams = W::P > 1 ? (BLOCK_SMEM - basis) / W::TEAM_SMEM : W::MAX_TEAMS;
  if (teams > W::MAX_TEAMS) teams = W::MAX_TEAMS;
  smem = basis + teams * W::TEAM_SMEM;
  return teams >= 1;
}

// Launch the instantiation with the geometry set, on stream st.
template <typename T, int KS, int NT, bool DECIDE>
cudaError_t run(Geo g, cudaStream_t st) {
  using W = Walk<T, KS, NT>;
  auto kernel = demod_at_any_kernel<T, KS, NT, DECIDE>;
  static int sms = 0;  // one per instantiation, set on its first launch
  static int per_sm_smem = -1, per_sm = 0;  // blocks an SM at the last shared memory asked
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::MAX_SMEM);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  int teams = 0, smem = 0;
  if (!block_of<T, KS, NT>(g, teams, smem)) return cudaErrorInvalidValue;
  const int threads = 32 * W::P * teams;
  if (smem != per_sm_smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    per_sm_smem = smem;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  g.tiles = (g.rows + W::ROWS - 1) / W::ROWS;
  const long long items = (long long)g.streams * g.tiles;
  if (items > (1LL << 30)) return cudaErrorInvalidValue;  // the walk counts items in int
  const long long blocks = (items + teams - 1) / teams;
  const int grid = (int)(blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm);
  g.step_b = grid * teams / g.tiles;
  g.step_t = grid * teams % g.tiles;
  kernel<<<grid, threads, smem, st>>>(g);
  return cudaGetLastError();
}

// What the card gives the instantiation at the geometry: {blocks an SM,
// threads a block, shared memory bytes, registers and local (spill) bytes
// a thread, KS, NT, m16 tiles an item}.
template <typename T, int KS, int NT, bool DECIDE>
cudaError_t occupancy(Geo g, int* out) {
  using W = Walk<T, KS, NT>;
  auto kernel = demod_at_any_kernel<T, KS, NT, DECIDE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::MAX_SMEM);
  if (err != cudaSuccess) return err;
  int teams = 0, smem = 0;
  if (!block_of<T, KS, NT>(g, teams, smem)) return cudaErrorInvalidValue;
  const int threads = 32 * W::P * teams;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int values[8] = {blocks, threads, smem, fa.numRegs, (int)fa.localSizeBytes, KS, NT, W::MT};
  for (int q = 0; q < 8; ++q) out[q] = values[q];
  return cudaSuccess;
}

// f(instantiation) for the (KS, NT) pair of the geometry: KS k-steps an A
// row (1, 2, 4, 8; int8 at most 4, a row of sps 128), NT n-tiles a group.
template <typename T, bool DECIDE, typename F>
cudaError_t with_pair(int ks, int nt, F&& f) {
  auto by_nt = [&](auto ks_c) -> cudaError_t {
    constexpr int K = decltype(ks_c)::value;
    if (nt == 1) return f.template operator()<T, K, 1, DECIDE>();
    if (nt == 2) return f.template operator()<T, K, 2, DECIDE>();
    if (nt == 4) return f.template operator()<T, K, 4, DECIDE>();
    return f.template operator()<T, K, 8, DECIDE>();
  };
  if (ks == 1) return by_nt(std::integral_constant<int, 1>{});
  if (ks == 2) return by_nt(std::integral_constant<int, 2>{});
  if (ks == 4) return by_nt(std::integral_constant<int, 4>{});
  if constexpr (!std::is_same<T, int8_t>::value) {
    if (ks == 8) return by_nt(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t with_instantiation(int dtype, bool decide, int ks, int nt, F&& f) {
  if (dtype == anet::DTYPE_BF16)
    return decide ? with_pair<__nv_bfloat16, true>(ks, nt, f) : with_pair<__nv_bfloat16, false>(ks, nt, f);
  if (dtype == anet::DTYPE_I8)
    return decide ? with_pair<int8_t, true>(ks, nt, f) : with_pair<int8_t, false>(ks, nt, f);
  return decide ? with_pair<float, true>(ks, nt, f) : with_pair<float, false>(ks, nt, f);
}

struct Launch {
  const Geo& g;
  cudaStream_t st;
  template <typename T, int KS, int NT, bool DECIDE>
  cudaError_t operator()() const {
    return run<T, KS, NT, DECIDE>(g, st);
  }
};

struct Occupancy {
  const Geo& g;
  int* out;
  template <typename T, int KS, int NT, bool DECIDE>
  cudaError_t operator()() const {
    return occupancy<T, KS, NT, DECIDE>(g, out);
  }
};

int dispatch(const void* buf, int dtype, int B, long long len, const void* start, int pre, int sps,
             int n_symbols, int m, bool decide, const void* basis, void* out0, void* out1, void* out2,
             void* stream) {
  Geo g;
  int ks = 0, nt = 0;
  const cudaError_t err = make_geo(g, ks, nt, dtype, B, len, pre, sps, n_symbols, m);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  g.buf = static_cast<const unsigned char*>(buf);
  g.start = static_cast<const int32_t*>(start);
  g.b0 = static_cast<const uint2*>(basis);
  g.b12 = reinterpret_cast<const uint4*>(g.b0 + g.b0_words);
  g.out0 = out0;
  g.out1 = static_cast<float*>(out1);
  g.out2 = static_cast<float*>(out2);
  return (int)with_instantiation(dtype, decide, ks, nt, Launch{g, reinterpret_cast<cudaStream_t>(stream)});
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

// The instantiation's occupancy for a buffer of dtype at sps, m tones and
// n_symbols, decide 1 (the decisions) or 0 (the energies): out[8] as
// occupancy's. Returns a cudaError_t.
extern "C" int anet_demod_at_any_occupancy(int dtype, int sps, int n_symbols, int m, int decide, int* out) {
  Geo g;
  int ks = 0, nt = 0;
  const cudaError_t err = make_geo(g, ks, nt, dtype, 1, 0, 0, sps, n_symbols, m);
  if (err != cudaSuccess) return (int)err;
  return (int)with_instantiation(dtype, decide != 0, ks, nt, Occupancy{g, out});
}
