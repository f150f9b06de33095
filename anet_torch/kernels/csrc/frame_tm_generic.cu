// frame_tm_generic: the time-major pair (decide_tones_tm, decide_frame_tm)
// at every geometry outside decide_frame_tm.cu's tensor-core walk, on
// Hopper's CUDA cores.
//
// Replaces, at those geometries, the TPU kernels anet/kernels/__init__.py
// decide_tones_tm (line 269, pallas_call at line 304) and decide_frame_tm
// (line 488, pallas_call at line 586), which take any samples_per_symbol
// and tone count. decide_frame_tm.cu's walk takes sps 32, 64 or 128 and at
// most 16 tones for decide_frame_tm (kernels._tensor_core_geometry), and
// also sps 48 and 80 and up to 32 tones for decide_tones_tm
// (kernels._filterbank_tensor_core_geometry): every MFSK preset. Custom
// configs off those (sps 24, 40, 96 or 160; more than 32 tones; and
// decide_frame_tm at sps 48 or 80) come here (kernels._tm_operands picks
// the route).
//
// Input: time-major x[T, B] (bfloat16 or float32; int8 too for the frame
// epilogue), symbol s in rows row0 + s sps .. row0 + (s + 1) sps - 1. Per
// stream and symbol: the [sps, 2M] filterbank, I*I + Q*Q of each tone
// (rounded after each operation, as common.cuh's tone_energy), the argmax
// (the first tone on ties), best and total; then one of two epilogues:
// - TONES (decide_tones_tm): tone, best and total, [S, B] each;
// - frame (decide_frame_tm: bps 1, 2 or 4, at most 16 tones): Gray decode,
//   8 symbols packed into an int32 word MSB-first, the header and payload
//   CRC bit counts as popcounts of the words against
//   kernels._frame_crc_masks, the quality sums conf/best/total: the outputs
//   and layout of decide_frame_tm.cu.
//
// What bounds it on the H100: at sps 80 with 32 tones (payload 256: 429
// symbols, B = 16,384) the read is 1.12 GB of bf16 (0.34 ms at 3.35 TB/s)
// or 2.25 GB of float32 (0.67 ms), and the filterbank's 72 GFLOP take 1.07
// ms at the CUDA cores' 67 TFLOP/s: on this route the operations bound it.
// At sps 48 with 8 tones (715 symbols: 18 GFLOP, 0.27 ms) the bytes bound
// it, 0.38 ms in bf16 and 0.71 ms in float32. Measured at those two shapes
// (chip_smoke.py phase 2, H100 80GB HBM3, 700 W): 4.92-4.95 and 1.41-1.77
// ms, the shared basis loads its limit by the SASS.
//
// Design, simple first:
// - A thread a stream, NB = 128 streams a block: each time row is one
//   coalesced read across a warp's 32 streams (64 bytes in bf16, 128 in
//   float32, 32 in int8), a symbol's samples read in order.
// - The basis in shared memory, copied once a block from the wrapper's
//   operand (kernels._generic_tm_basis): [M / G, sps, 2G] with G = min(M,
//   16) tones a pass, row k of pass p the cos of tones pG .. pG + G - 1,
//   then their sin; float32 (bf16-rounded entries for bfloat16 data), or the
//   x127 integers as int32 for int8 data. All lanes of a warp read the same
//   row: a broadcast, 16 bytes a load. A basis larger than a block's shared
//   memory is read in place from device memory, in the same layout.
// - A pass keeps the I and Q of its G tones in registers (float32 sums of
//   fmaf; int32 sums of the int8 products, exact), then folds their
//   energies into the running argmax, best and total; M > 16 takes M / 16
//   passes over the symbol's rows (the later ones read them from L1).
// - The grid: a block per 128 streams (x) and, while that leaves the card
//   short of the blocks it holds at once, a share of the 8-symbol tiles
//   (y), as decide_frame_tm.cu. With one share a block stores its CRC
//   counts and quality sums; with several each adds them into the zeroed
//   outputs with atomicAdd (the counts are integers, exact in any order; the
//   sums change their rounding order only).
// The TPU kernels' 8 x 128 tiles and their zero padding are not carried
// over: a stream past B has no thread, a symbol past n_symbols no pass.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int SB = 8;         // symbols per packed word (kernels.TM_SYMBOL_TILE)
constexpr int NB = 128;       // streams a block, a thread a stream
constexpr int MAX_G = 16;     // tones a pass (kernels.TM_GENERIC_TONES)
constexpr int CRC_COLS = 64;  // header CRC counts in columns 0..31, payload in 32..63

struct Generic {
  const void* x;  // [T, B] time-major
  int B, row0, sps, m, n_symbols, n_tiles, bps;
  const void* basis;      // [m / G, sps, 2G], float32 or int32
  int staged;             // the basis copied into shared memory
  const uint32_t* masks;  // [n_tiles, 64] (frame)
  int32_t* words;         // [n_tiles, B] (frame)
  float* crc;             // [64, B] (frame)
  float* qual;            // [8, B] (frame)
  int32_t* tone;          // [n_symbols, B] (TONES)
  float* best;
  float* total;
};

// The sums of a sample type: int32 for int8 samples (exact), else float32.
template <typename T>
using Acc = std::conditional_t<std::is_same_v<T, int8_t>, int, float>;

template <typename A>
using Vec4 = std::conditional_t<std::is_same_v<A, int>, int4, float4>;

template <typename T>
__device__ __forceinline__ Acc<T> sample(const T* p) {
  if constexpr (std::is_same_v<T, int8_t>)
    return static_cast<int>(*p);
  else
    return anet::to_f32(*p);
}

__device__ __forceinline__ float madd(float x, float b, float acc) { return fmaf(x, b, acc); }
__device__ __forceinline__ int madd(int x, int b, int acc) { return acc + x * b; }

template <typename T, int G, bool TONES>
__global__ void __launch_bounds__(NB) frame_tm_generic(Generic f) {
  using A = Acc<T>;
  using V = Vec4<A>;
  constexpr int RV = 2 * G / 4;  // 16-byte vectors of a basis row
  extern __shared__ __align__(16) unsigned char generic_smem[];
  const int n_pass = f.m / G;
  const V* basis = static_cast<const V*>(f.basis);
  if (f.staged) {
    V* sb = reinterpret_cast<V*>(generic_smem);
    const int n_vec = n_pass * f.sps * RV;
    for (int i = threadIdx.x; i < n_vec; i += NB) sb[i] = basis[i];
    __syncthreads();
    basis = sb;
  }
  const int b = blockIdx.x * NB + threadIdx.x;
  if (b >= f.B) return;  // no sync follows
  const int64_t B = f.B;
  const T* col = static_cast<const T*>(f.x) + b;

  float conf = 0.0f, bsum = 0.0f, tsum = 0.0f;
  int cnt[TONES ? 1 : CRC_COLS];
  if constexpr (!TONES) {
#pragma unroll
    for (int c = 0; c < CRC_COLS; ++c) cnt[c] = 0;
  }
  for (int tile = blockIdx.y; tile < f.n_tiles; tile += gridDim.y) {
    const int s0 = tile * SB, s1 = min(s0 + SB, f.n_symbols);
    uint32_t word = 0;
    for (int s = s0; s < s1; ++s) {
      const T* sym = col + ((int64_t)f.row0 + (int64_t)s * f.sps) * B;
      float bv = -1.0f, tot = 0.0f;
      int bi = 0;
      for (int p = 0; p < n_pass; ++p) {
        A ci[G], cq[G];
#pragma unroll
        for (int j = 0; j < G; ++j) ci[j] = cq[j] = A(0);
        const V* bp = basis + (int64_t)p * f.sps * RV;
#pragma unroll 4
        for (int k = 0; k < f.sps; ++k) {
          const A v = sample(sym + (int64_t)k * B);
          A w[2 * G];
#pragma unroll
          for (int q = 0; q < RV; ++q) {
            const V u = bp[k * RV + q];
            w[4 * q] = u.x;
            w[4 * q + 1] = u.y;
            w[4 * q + 2] = u.z;
            w[4 * q + 3] = u.w;
          }
#pragma unroll
          for (int j = 0; j < G; ++j) {
            ci[j] = madd(v, w[j], ci[j]);
            cq[j] = madd(v, w[G + j], cq[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float e = anet::tone_energy(static_cast<float>(ci[j]), static_cast<float>(cq[j]));
          if (e > bv) {  // the tones ascend: strict > keeps the first
            bv = e;
            bi = p * G + j;
          }
          tot += e;
        }
      }
      if constexpr (TONES) {
        const int64_t o = (int64_t)s * B + b;
        f.tone[o] = bi;
        f.best[o] = bv;
        f.total[o] = tot;
      } else {
        conf += bv / fmaxf(tot, 1e-20f);
        bsum += bv;
        tsum += tot;
        int data = bi;  // Gray -> binary
        for (int sh = 1; sh < f.bps; sh <<= 1) data ^= data >> sh;
        word |= (uint32_t)data << ((SB - 1 - (s - s0)) * f.bps);
      }
    }
    if constexpr (!TONES) {
      f.words[(int64_t)tile * B + b] = (int32_t)word;
      const uint4* mp = reinterpret_cast<const uint4*>(f.masks + (int64_t)tile * CRC_COLS);
#pragma unroll
      for (int c4 = 0; c4 < CRC_COLS / 4; ++c4) {
        const uint4 mk = __ldg(mp + c4);
        cnt[4 * c4 + 0] += __popc(word & mk.x);
        cnt[4 * c4 + 1] += __popc(word & mk.y);
        cnt[4 * c4 + 2] += __popc(word & mk.z);
        cnt[4 * c4 + 3] += __popc(word & mk.w);
      }
    }
  }
  if constexpr (!TONES) {
    if (gridDim.y == 1) {  // the block holds the stream's whole sums
#pragma unroll
      for (int c = 0; c < CRC_COLS; ++c) f.crc[c * B + b] = (float)cnt[c];
      f.qual[b] = conf;
      f.qual[B + b] = bsum;
      f.qual[2 * B + b] = tsum;
    } else {
#pragma unroll
      for (int c = 0; c < CRC_COLS; ++c)
        if (cnt[c]) atomicAdd(f.crc + c * B + b, (float)cnt[c]);
      atomicAdd(f.qual + b, conf);
      atomicAdd(f.qual + B + b, bsum);
      atomicAdd(f.qual + 2 * B + b, tsum);
    }
  }
}

// The grid: a block per NB streams (x) and, while that leaves the card
// short of its resident blocks, a share of the tiles (y).
template <typename T, int G, bool TONES>
cudaError_t launch(Generic f, cudaStream_t st) {
  void (*kernel)(Generic) = frame_tm_generic<T, G, TONES>;
  // per instantiation: the card's SMs and shared-memory limit, the dynamic
  // shared memory allowed so far, the blocks an SM at the last size asked
  static int sms = 0, optin = 0, smem_set = 0, occ_smem = -1, occ_blocks = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0, n = 0, limit = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    sms = n;
    optin = limit;
  }
  const long long bytes = (long long)f.m * 2 * f.sps * 4;  // the basis: M / G passes x sps x 2G words
  f.staged = bytes <= optin;
  const int smem = f.staged ? (int)bytes : 0;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (smem != occ_smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NB, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    occ_blocks = per_sm;
    occ_smem = smem;
  }
  const int gx = (f.B + NB - 1) / NB;
  const int gy = std::min(std::max(1, sms * occ_blocks / gx), f.n_tiles);
  kernel<<<dim3(gx, gy), NB, smem, st>>>(f);
  return cudaGetLastError();
}

// G = min(m, 16): m a power of two from 2, or a multiple of 16.
template <typename T, bool TONES>
cudaError_t dispatch_tones(const Generic& f, cudaStream_t st) {
  if (f.m >= MAX_G && f.m % MAX_G == 0) return launch<T, MAX_G, TONES>(f, st);
  switch (f.m) {
    case 2:
      return launch<T, 2, TONES>(f, st);
    case 4:
      return launch<T, 4, TONES>(f, st);
    case 8:
      return launch<T, 8, TONES>(f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// decide_frame_tm at any sps. float32 (dtype 0), bfloat16 (1) or int8 (2)
// x: [T, B] time-major, any alignment; m 2, 4, 8 or 16 tones, bps 1, 2 or
// 4; basis: [m / G, sps, 2G] (kernels._generic_tm_basis: float32, int32
// for int8); masks: [n_tiles, 64] int32 (kernels._frame_crc_masks). words:
// [n_tiles, B] int32; crc: [64, B] and qual: [8, B] float32, zeroed by the
// caller. The arguments of anet_decide_frame_tm. Returns cudaGetLastError().
extern "C" int anet_decide_frame_tm_generic(const void* x, int dtype, int B, int row0, int sps, int m,
                                            int n_symbols, int n_tiles, int bps, const void* basis,
                                            const void* masks, void* words, void* crc, void* qual,
                                            void* stream) {
  if (m < 2 || m > MAX_G || sps < 1 || (bps != 1 && bps != 2 && bps != 4)) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_tiles == 0) return (int)cudaSuccess;
  Generic f{};
  f.x = x;
  f.B = B;
  f.row0 = row0;
  f.sps = sps;
  f.m = m;
  f.n_symbols = n_symbols;
  f.n_tiles = n_tiles;
  f.bps = bps;
  f.basis = basis;
  f.masks = static_cast<const uint32_t*>(masks);
  f.words = static_cast<int32_t*>(words);
  f.crc = static_cast<float*>(crc);
  f.qual = static_cast<float*>(qual);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_tones<__nv_bfloat16, false>(f, st);
  if (dtype == anet::DTYPE_I8) return (int)dispatch_tones<int8_t, false>(f, st);
  if (dtype == anet::DTYPE_F32) return (int)dispatch_tones<float, false>(f, st);
  return (int)cudaErrorInvalidValue;
}

// decide_tones_tm at any sps and tone count. float32 (dtype 0) or bfloat16
// (1) x: [>= n_symbols * sps, B] time-major, symbol-aligned at row 0; m a
// power of two from 2; basis as anet_decide_frame_tm_generic takes it.
// tone: [n_symbols, B] int32; best, total: [n_symbols, B] float32. The
// arguments of anet_decide_tones_tm_mma. Returns cudaGetLastError().
extern "C" int anet_decide_tones_tm_generic(const void* x, int dtype, int B, int sps, int m, int n_symbols,
                                            const void* basis, void* tone, void* best, void* total,
                                            void* stream) {
  if (m < 2 || sps < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_symbols == 0) return (int)cudaSuccess;
  Generic f{};
  f.x = x;
  f.B = B;
  f.sps = sps;
  f.m = m;
  f.n_symbols = n_symbols;
  f.n_tiles = (n_symbols + SB - 1) / SB;
  f.basis = basis;
  f.tone = static_cast<int32_t*>(tone);
  f.best = static_cast<float*>(best);
  f.total = static_cast<float*>(total);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == anet::DTYPE_BF16) return (int)dispatch_tones<__nv_bfloat16, true>(f, st);
  if (dtype == anet::DTYPE_F32) return (int)dispatch_tones<float, true>(f, st);
  return (int)cudaErrorInvalidValue;
}
