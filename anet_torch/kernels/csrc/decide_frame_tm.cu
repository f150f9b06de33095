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
// halves it, 0.17 ms). The filterbank is 2 x 34,304 x 32 flops a stream:
// about 0.54 ms on the CUDA cores in float32, 0.04 ms on the tensor cores.
// Measured there (python -m anet_torch.kernels.time_search --kernels frame,
// H100 80GB HBM3, 700 W limit, device time of the kernel): bf16 0.40-0.43
// ms, about 2.7 TB/s of the data rows; int8 0.26-0.28 ms, held by the
// per-symbol loop (0.21 ms with the copies taken out) more than by its
// bytes. The float32 body: 2.69-2.78.
//
// Design of the bfloat16 and int8 kernel (frame_tm_mma):
// - The product. Per symbol, IQ[b, n] = sum_k x[row0 + s sps + k, b] *
//   basis[k, n]: streams on the M axis of mma.sync m16n8k16 (bf16, float32
//   sums) or m16n8k32 (s8, exact int32 I/Q), the packed interleaved-(I, Q)
//   basis of demod_core.cuh (kernels._demod_mma_basis) as B fragments held
//   in registers for the whole launch. A lane's C registers are one tone's
//   I and Q for one stream, so I*I + Q*Q needs no shuffle.
// - The A operand from time-major rows. A block owns NB = 64 streams and
//   walks all of their symbols: each symbol's sps rows x 64 streams (128
//   bytes a row in bf16, 64 in int8) are staged in shared memory with
//   16-byte cp.async copies in a ring of STAGES symbols (about 40 KB), so
//   every load of a warp covers whole row pieces. Shared rows are padded
//   by 16 bytes and their chunks swizzled (chunk q of row t at q ^ 2 bit 3
//   of t), so each 8-row ldmatrix phase below hits 8 distinct bank groups.
//   bf16: ldmatrix.x4.trans of (time 0-7 | 8-15) x (stream 0-7 | 8-15)
//   yields a0..a3 directly. int8: a stream pair is one 16-bit element;
//   ldmatrix.x4.trans of the rows at times {4i, 4i+1} and {4i+2, 4i+3}
//   (and + 16) and two __byte_perm give the 4 consecutive time bytes of
//   streams 2g and 2g+1: M row g is stream 2g, row g + 8 stream 2g + 1.
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
//   for bf16 or 16 for int8, or an unaligned base) cannot take 16-byte
//   copies: then the fetch loads element by element into the same layout.
// - decide_tones_tm's bfloat16 route (anet/kernels/__init__.py
//   decide_tones_tm, pallas_call at line 304) is this walk with another
//   epilogue (TONES): row0 0, every symbol's tone, best and total stored
//   by lanes 0 and 1 of each quad (M rows g and g + 8), no word, CRC
//   count or sum. Bound at the smoke run's oversized window (544 symbols
//   of 64 bf16 samples, B = 16384): 1.25 GB read and written, 0.37 ms;
//   measured (time_search --kernels tones_tm, as above) 0.46-0.47 ms.
//
// float32 data keeps the CUDA cores (frame_tm_f32, anet_decide_frame_tm_f32):
// a bf16 hi + lo split of float32 samples would lose 2^-16 of weak tones'
// I/Q. One thread per stream, the symbol axis split across blockIdx.y; the
// [sps, 32] basis in shared memory as float4 broadcasts, the P table rows
// at warp-uniform addresses, CRC counts and quality sums added into zeroed
// outputs with atomicAdd (the counts are integers, exact in any order).
#include <algorithm>

#include "demod_core.cuh"

namespace {

constexpr int SB = 8;  // symbols per packed word (TM_SYMBOL_TILE)

// --- bfloat16 and int8: the tensor-core filterbank ---------------------------

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
  static constexpr int STAGES =
      RING_TARGET / STAGE < 3 ? 3 : RING_TARGET / STAGE > 16 ? 16 : RING_TARGET / STAGE;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int KS = SPS * (int)sizeof(T) / 32;  // k-steps: 16 bf16 or 32 int8 times
  static_assert((SPS * CH) % THREADS == 0, "a stage's chunks split evenly over the block");
  static_assert((SPS * NB) % THREADS == 0, "a stage's samples split evenly over the block");
  static_assert(CH >= 4, "the swizzle flips bit 1 of the chunk index");
};

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

struct Frame {
  const unsigned char* x;
  int B, row0, n_symbols, n_tiles, bps;
  bool aligned;           // 16-byte copies: every row piece starts on a 16-byte boundary
  const uint32_t* basis;  // kernels._demod_mma_basis
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

// TONES: decide_tones_tm's epilogue, each symbol's tone, best and total
// stored; else decide_frame_tm's, the packed words, CRC counts and sums.
template <typename T, int SPS, int NT, bool TONES>
__global__ void __launch_bounds__(THREADS) frame_tm_mma(Frame f) {
  using G = Geo<T, SPS>;
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i = lane & 3;
  const int b0 = blockIdx.x * NB;
  // M rows g and g + 8 of this warp's tile: bf16 streams g, g + 8; int8 2g, 2g + 1
  int sb[2];
  sb[0] = b0 + 16 * warp + (sizeof(T) == 2 ? g : 2 * g);
  sb[1] = b0 + 16 * warp + (sizeof(T) == 2 ? g + 8 : 2 * g + 1);

  uint32_t bf[G::KS][NT][2];
#pragma unroll
  for (int ks = 0; ks < G::KS; ++ks)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) bf[ks][t][r] = f.basis[((ks * NT + t) * 2 + r) * 32 + lane];

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
      typename anet::demod::Acc<T>::type acc[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks) {
        uint32_t a[4];
        a_frag<T, SPS>(stage, ks, warp, lane, a);
#pragma unroll
        for (int t = 0; t < NT; ++t) anet::demod::mma(acc[t], a, bf[ks][t][0], bf[ks][t][1]);
      }
      float best[2], total[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bq = anet::tone_energy((float)acc[0][2 * h], (float)acc[0][2 * h + 1]);
        float tot = bq;
        int bt = i;
#pragma unroll
        for (int v = 1; v < NT; ++v) {
          const float e = anet::tone_energy((float)acc[v][2 * h], (float)acc[v][2 * h + 1]);
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

// The grid: a block per NB streams (x) and, while that leaves the card
// short of its resident blocks, a share of the tiles (y).
template <typename T, int SPS, int NT, bool TONES>
cudaError_t launch_mma(const Frame& f, cudaStream_t st) {
  using G = Geo<T, SPS>;
  static int resident = 0;  // blocks the card holds at once; 0 until the first call
  auto kernel = frame_tm_mma<T, SPS, NT, TONES>;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, G::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int gx = (f.B + NB - 1) / NB;
  const int gy = std::min(std::max(1, resident / gx), f.n_tiles);
  kernel<<<dim3(gx, gy), THREADS, G::SMEM, st>>>(f);
  return cudaGetLastError();
}

template <typename T, int SPS, bool TONES>
cudaError_t dispatch_tones(int m, const Frame& f, cudaStream_t st) {
  if (m <= 4) return launch_mma<T, SPS, 1, TONES>(f, st);
  if (m <= 8) return launch_mma<T, SPS, 2, TONES>(f, st);
  return launch_mma<T, SPS, 4, TONES>(f, st);
}

template <typename T, bool TONES = false>
cudaError_t dispatch_sps(int sps, int m, const Frame& f, cudaStream_t st) {
  switch (sps) {
    case 32:
      return dispatch_tones<T, 32, TONES>(m, f, st);
    case 64:
      return dispatch_tones<T, 64, TONES>(m, f, st);
    case 128:
      return dispatch_tones<T, 128, TONES>(m, f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// --- float32: the CUDA-core body ---------------------------------------------

constexpr int NCOL = 32;  // basis columns: cos/sin of 16 (padded) tones
constexpr int F32_THREADS = 128;

__global__ void __launch_bounds__(F32_THREADS)
frame_tm_f32(const float* __restrict__ x, int B, int row0, int sps, int n_symbols, int n_tiles,
             int tiles_per_block, int bps, const float* __restrict__ basis,
             const float* __restrict__ ptab, int hdr_bits, int pay_lo, int pay_hi,
             int32_t* __restrict__ words, float* __restrict__ crc, float* __restrict__ qual) {
  extern __shared__ float4 sbasis4[];  // [sps][NCOL / 4]
  for (int i = threadIdx.x; i < sps * NCOL / 4; i += blockDim.x)
    sbasis4[i] = reinterpret_cast<const float4*>(basis)[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_tiles);

  float cnt[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) cnt[c] = 0.0f;
  float conf = 0.0f, bsum = 0.0f, tsum = 0.0f;

  for (int tile = tile0; tile < tile1; ++tile) {
    uint32_t word = 0;
    for (int s8 = 0; s8 < SB; ++s8) {
      const int s = tile * SB + s8;
      int data = 0;
      if (s < n_symbols) {
        float acc[NCOL];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[c] = 0.0f;
        const float* xs = x + (int64_t)(row0 + (int64_t)s * sps) * B + b;
        for (int j = 0; j < sps; ++j) {
          const float v = xs[(int64_t)j * B];
          const float4* bj = sbasis4 + j * (NCOL / 4);
#pragma unroll
          for (int c4 = 0; c4 < NCOL / 4; ++c4) {
            const float4 w = bj[c4];
            acc[4 * c4 + 0] = fmaf(v, w.x, acc[4 * c4 + 0]);
            acc[4 * c4 + 1] = fmaf(v, w.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(v, w.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(v, w.w, acc[4 * c4 + 3]);
          }
        }
        float best = -1.0f, total = 0.0f;
        int tone = 0;
#pragma unroll
        for (int c = 0; c < NCOL / 2; ++c) {
          const float e = anet::tone_energy(acc[c], acc[c + NCOL / 2]);
          if (e > best) {  // strict: the first index wins ties
            best = e;
            tone = c;
          }
          total += e;
        }
        conf += best / fmaxf(total, 1e-20f);
        bsum += best;
        tsum += total;
        data = tone;  // Gray -> binary
        for (int sh = 1; sh < bps; sh <<= 1) data ^= data >> sh;
      }
      word |= (uint32_t)data << ((SB - 1 - s8) * bps);
      // CRC bit counts: message bit r = s * bps + k (MSB-first in a symbol)
      for (int k = 0; k < bps; ++k) {
        const int r = s * bps + k;
        const float bit = (float)((data >> (bps - 1 - k)) & 1);
        if (r < hdr_bits) {
          const float4* p = reinterpret_cast<const float4*>(ptab + (int64_t)r * 64);
#pragma unroll
          for (int c4 = 0; c4 < 8; ++c4) {
            const float4 w = __ldg(p + c4);
            cnt[4 * c4 + 0] = fmaf(bit, w.x, cnt[4 * c4 + 0]);
            cnt[4 * c4 + 1] = fmaf(bit, w.y, cnt[4 * c4 + 1]);
            cnt[4 * c4 + 2] = fmaf(bit, w.z, cnt[4 * c4 + 2]);
            cnt[4 * c4 + 3] = fmaf(bit, w.w, cnt[4 * c4 + 3]);
          }
        }
        if (r >= pay_lo && r < pay_hi) {
          const float4* p = reinterpret_cast<const float4*>(ptab + (int64_t)r * 64 + 32);
#pragma unroll
          for (int c4 = 0; c4 < 8; ++c4) {
            const float4 w = __ldg(p + c4);
            cnt[32 + 4 * c4 + 0] = fmaf(bit, w.x, cnt[32 + 4 * c4 + 0]);
            cnt[32 + 4 * c4 + 1] = fmaf(bit, w.y, cnt[32 + 4 * c4 + 1]);
            cnt[32 + 4 * c4 + 2] = fmaf(bit, w.z, cnt[32 + 4 * c4 + 2]);
            cnt[32 + 4 * c4 + 3] = fmaf(bit, w.w, cnt[32 + 4 * c4 + 3]);
          }
        }
      }
    }
    words[(int64_t)tile * B + b] = (int32_t)word;
  }
#pragma unroll
  for (int c = 0; c < 64; ++c)
    if (cnt[c] != 0.0f) atomicAdd(crc + (int64_t)c * B + b, cnt[c]);
  atomicAdd(qual + b, conf);
  atomicAdd(qual + (int64_t)B + b, bsum);
  atomicAdd(qual + 2 * (int64_t)B + b, tsum);
}

}  // namespace

// bfloat16 (dtype 1) or int8 (dtype 2) x: [T, B] time-major, any base
// alignment; m <= 16 tones, sps 32, 64 or 128; basis: the B fragments of
// demod_core.cuh (kernels._demod_mma_basis); masks: [n_tiles, 64] int32
// (kernels._frame_crc_masks). words: [n_tiles, B] int32; crc: [64, B] and qual: [8, B] float32, zeroed by the
// caller. Returns cudaGetLastError().
extern "C" int anet_decide_frame_tm(const void* x, int dtype, int B, int row0, int sps, int m,
                                    int n_symbols, int n_tiles, int bps, const void* basis,
                                    const void* masks, void* words, void* crc, void* qual, void* stream) {
  if (m < 1 || m > 16 || (bps != 1 && bps != 2 && bps != 4)) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_tiles == 0) return (int)cudaSuccess;
  const int elem = dtype == anet::DTYPE_BF16 ? 2 : 1;
  Frame f{static_cast<const unsigned char*>(x), B, row0, n_symbols, n_tiles, bps,
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && ((int64_t)B * elem) % 16 == 0,
          static_cast<const uint32_t*>(basis), static_cast<const uint32_t*>(masks),
          static_cast<int32_t*>(words), static_cast<float*>(crc),
          static_cast<float*>(qual), nullptr, nullptr, nullptr};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_sps<__nv_bfloat16>(sps, m, f, st);
  if (dtype == anet::DTYPE_I8) return (int)dispatch_sps<int8_t>(sps, m, f, st);
  return (int)cudaErrorInvalidValue;
}

// decide_tones_tm on the tensor cores. bfloat16 x: [>= n_symbols * sps, B]
// time-major, symbol-aligned at row 0, any base alignment; m <= 16 tones,
// sps 32, 64 or 128; basis: the B fragments of demod_core.cuh
// (kernels._demod_mma_basis). tone: [n_symbols, B] int32; best, total:
// [n_symbols, B] float32. Returns cudaGetLastError().
extern "C" int anet_decide_tones_tm_mma(const void* x, int B, int sps, int m, int n_symbols,
                                        const void* basis, void* tone, void* best, void* total,
                                        void* stream) {
  if (m < 1 || m > 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  Frame f{static_cast<const unsigned char*>(x), B, 0, n_symbols, (n_symbols + SB - 1) / SB, 0,
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && ((int64_t)B * 2) % 16 == 0,
          static_cast<const uint32_t*>(basis), nullptr, nullptr, nullptr, nullptr,
          static_cast<int32_t*>(tone), static_cast<float*>(best), static_cast<float*>(total)};
  return (int)dispatch_sps<__nv_bfloat16, true>(sps, m, f, reinterpret_cast<cudaStream_t>(stream));
}

// float32 x: [T, B] time-major; basis: [sps, 32] float32; ptab:
// [n_tiles*8*bps, 64] float32 in message-bit row order; words: [n_tiles, B]
// int32; crc: [64, B] and qual: [8, B] float32, zeroed by the caller.
// Returns cudaGetLastError().
extern "C" int anet_decide_frame_tm_f32(const void* x, int B, int row0, int sps, int n_symbols,
                                        int n_tiles, int bps, const void* basis, const void* ptab,
                                        int hdr_bits, int pay_lo, int pay_hi, void* words,
                                        void* crc, void* qual, void* stream) {
  if (B == 0 || n_tiles == 0) return (int)cudaSuccess;
  const int tiles_per_block = 4;
  dim3 grid((B + F32_THREADS - 1) / F32_THREADS, (n_tiles + tiles_per_block - 1) / tiles_per_block);
  const size_t smem = (size_t)sps * NCOL * sizeof(float);
  frame_tm_f32<<<grid, F32_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), B, row0, sps, n_symbols, n_tiles, tiles_per_block, bps,
      static_cast<const float*>(basis), static_cast<const float*>(ptab), hdr_bits, pay_lo, pay_hi,
      static_cast<int32_t*>(words), static_cast<float*>(crc), static_cast<float*>(qual));
  return (int)cudaGetLastError();
}
