// gather_rows_fused: per-stream timing-alignment gather, Hopper.
//
// Replaces the TPU kernel anet/kernels/__init__.py gather_rows_fused
// (pallas_call at line 1460, body _gather_rows_kernel at line 1394):
//   out[b, i] = buffer[b, start[b] + i]          (i < size)
// Pure data movement, bit-exact in any dtype of 1, 2 or 4 bytes (int8,
// bfloat16, float16, float32): the samples are moved as bytes and never
// converted. Positions outside [0, L) read as zero (the reference reads its
// zero padding there).
//
// What bounds it on the H100: bytes. Each output sample is read once and
// written once (size x B x 2 x itemsize: 1.19 GB at B = 8192, size = 36,352
// bf16, 0.36 ms at 3.35 TB/s) plus the 4-byte start of each stream.
// Measured there (python -m anet_torch.kernels.time_search --kernels
// gather, H100 80GB HBM3, 700 W limit, device time): bf16 0.42 ms, int8
// 0.21, float32 0.84, about 2.84 TB/s moved: 1.18x the bound.
//
// Design: the TPU kernel's 128-lane rows, lane roll and iota select become
// a 16-byte funnel-shift copy.
// - Every store of a row's body is 16 bytes, aligned: a row's first bytes
//   up to a 16-byte boundary of the output (head) and its last partial
//   vector (tail), at most 15 bytes each, are copied element by element.
// - Every load is one aligned 16-byte vector of the buffer. Output vector j
//   of a row is bytes [r, r + 16) of source vectors q0 + j and q0 + j + 1,
//   r = the source address of its first byte mod 16, the same for the whole
//   row: lane l loads vector q0 + j + l, takes its neighbour's with a
//   shuffle, and one __funnelshift_r a word (after a select of the word by
//   r / 4) aligns it. A warp walks SPAN vectors in passes of 32 x U; the
//   vector past a pass is the next pass's first and is carried, so each
//   source byte is read once a warp.
// - Bytes outside row b (a start below 0, a span past L, or the vector at
//   either end of the row reaching into its neighbour) are zeroed by a byte
//   mask on the vectors at the row's two ends. Those vectors never reach
//   outside [buf, buf + B L itemsize): one that would (the allocation's
//   first and last 16 bytes) is read byte by byte instead.
// - Offsets are 64-bit: B L itemsize passes 2^31 at the main path's sizes.
// - Two lanes' vectors a pass and eight passes a warp (48 registers, no
//   stack) ran faster than four or eight a pass (more registers, fewer
//   warps an SM) and than a register cap that spills.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 2;                    // vectors a lane stores a pass (loads in flight)
constexpr int SPAN = 32 * U * 8;        // output vectors a warp: eight passes
constexpr unsigned FULL = 0xffffffffu;

// Bytes [a, z) of a 32-bit word, a and z clamped to [0, 4].
__device__ __forceinline__ uint32_t byte_mask(int a, int z) {
  a = min(max(a, 0), 4);
  z = min(max(z, 0), 4);
  return (uint32_t)((1ull << (8 * z)) - 1) & ~(uint32_t)((1ull << (8 * a)) - 1);
}

// One row of the buffer, as byte offsets from `base`, the buffer's address
// rounded down to 16 bytes.
struct Row {
  const unsigned char* base;
  int64_t a_lo, a_hi;  // the buffer [buf, buf + B L itemsize)
  int64_t lo, hi;      // this row
};

// Aligned vector q (bytes [16 q, 16 q + 16) from base) with its bytes
// outside the row zeroed.
__device__ __forceinline__ uint4 vec_at(const Row& r, int64_t q) {
  const int64_t lo = 16 * q, hi = lo + 16;
  if (hi <= r.lo || lo >= r.hi) return make_uint4(0u, 0u, 0u, 0u);
  if (lo >= r.lo && hi <= r.hi) return *reinterpret_cast<const uint4*>(r.base + lo);
  const int s = r.lo > lo ? (int)(r.lo - lo) : 0, e = r.hi < hi ? (int)(r.hi - lo) : 16;  // live bytes
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (lo >= r.a_lo && hi <= r.a_hi) {  // inside the buffer: one load, then the mask
    const uint4 v = *reinterpret_cast<const uint4*>(r.base + lo);
    w[0] = v.x & byte_mask(s, e);
    w[1] = v.y & byte_mask(s - 4, e - 4);
    w[2] = v.z & byte_mask(s - 8, e - 8);
    w[3] = v.w & byte_mask(s - 12, e - 12);
  } else {  // it would reach outside the buffer: the live bytes one by one
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i >= s && i < e) w[i >> 2] |= (uint32_t)r.base[lo + i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes [r, r + 16) of the 32 bytes a, b.
__device__ __forceinline__ uint4 funnel(const uint4& a, const uint4& b, int r) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = r >> 2;
  const uint32_t sh = 8 * (r & 3);
  uint32_t t[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) t[k] = q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[k + 3];
  return make_uint4(__funnelshift_r(t[0], t[1], sh), __funnelshift_r(t[1], t[2], sh),
                    __funnelshift_r(t[2], t[3], sh), __funnelshift_r(t[3], t[4], sh));
}

// Lane l's next vector: lane l + 1's `own`; lane 31 gets lane 0's `first`.
// (The select is made a word at a time: a select of whole vectors would
// put them in local memory.)
__device__ __forceinline__ uint4 next_vec(const uint4& own, const uint4& first, int lane) {
  const bool z = lane == 0;
  const int src = (lane + 1) & 31;
  return make_uint4(__shfl_sync(FULL, z ? first.x : own.x, src), __shfl_sync(FULL, z ? first.y : own.y, src),
                    __shfl_sync(FULL, z ? first.z : own.z, src), __shfl_sync(FULL, z ? first.w : own.w, src));
}

// Vector q, or zeros where it is not `live`; EDGE: through vec_at.
template <bool EDGE>
__device__ __forceinline__ uint4 load_vec(const Row& r, int64_t q, bool live) {
  if (!live) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (EDGE) return vec_at(r, q);
  return *reinterpret_cast<const uint4*>(r.base + 16 * q);
}

// Output vectors [j0, j1) of a row to dst (16-byte aligned): vector j is
// bytes [rs, rs + 16) of source vectors q0 + j, q0 + j + 1. EDGE: some
// source vector of the span reaches outside the row, so each goes through
// vec_at; else all lie inside it and load as they are. A vector past j1 is
// never loaded.
template <bool EDGE>
__device__ __forceinline__ void copy_span(const Row& r, int64_t q0, int rs, int64_t j0, int64_t j1,
                                          unsigned char* dst, int lane) {
  uint4 carry = load_vec<EDGE>(r, q0 + j0 + lane, j0 + lane <= j1);
  for (int64_t j = j0; j < j1; j += 32 * U) {
    uint4 v[U + 1];
    v[0] = carry;
#pragma unroll
    for (int u = 1; u <= U; ++u) {  // v[U]: the next pass's first
      const int64_t jj = j + 32 * u + lane;
      v[u] = load_vec<EDGE>(r, q0 + jj, jj <= j1);
    }
    carry = v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint4 nb = next_vec(v[u], v[u + 1], lane);
      const int64_t jj = j + 32 * u + lane;
      if (jj < j1) *reinterpret_cast<uint4*>(dst + 16 * jj) = funnel(v[u], nb, rs);
    }
  }
}

// W: the element's bits (uint8_t, uint16_t or uint32_t). Block (b, y) copies
// row b's vectors from (y WARPS + warp) SPAN, a warp each; block (b, 0)
// also the head and the tail.
template <typename W>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const unsigned char* __restrict__ buf, int64_t total, int64_t len,
                   const int32_t* __restrict__ start, int size, unsigned char* __restrict__ out) {
  constexpr int E = (int)sizeof(W);
  const int64_t b = blockIdx.x;
  const int64_t st = start[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = (int64_t)size * E;  // the output row's bytes
  unsigned char* o = out + b * n;
  const int64_t pad = (16 - (int64_t)(reinterpret_cast<uintptr_t>(o) & 15)) & 15;
  const int64_t h = pad < n ? pad : n;
  const int64_t nvec = (n - h) >> 4;
  if (blockIdx.y == 0 && warp == 0) {  // head: lanes 0-15; tail: lanes 16-31
    const int64_t tail0 = h + 16 * nvec;
    const int64_t byte = lane < 16 ? (int64_t)lane * E : tail0 + (int64_t)(lane - 16) * E;
    if (lane < 16 ? byte < h : byte < n) {
      const int64_t p = st + byte / E;
      reinterpret_cast<W*>(o)[byte / E] =
          p >= 0 && p < len ? reinterpret_cast<const W*>(buf)[b * len + p] : W(0);
    }
  }
  const int64_t j0 = ((int64_t)blockIdx.y * WARPS + warp) * SPAN;
  if (j0 >= nvec) return;
  const int64_t j1 = j0 + SPAN < nvec ? j0 + SPAN : nvec;

  Row r;
  r.a_lo = (int64_t)(reinterpret_cast<uintptr_t>(buf) & 15);
  r.base = buf - r.a_lo;
  r.a_hi = r.a_lo + total;
  r.lo = r.a_lo + b * len * E;
  r.hi = r.lo + len * E;
  const int64_t p0 = r.lo + st * E + h;  // the source byte of output vector 0
  const int64_t q0 = p0 >> 4;            // floor: p0 < 0 for a start before the row's
  const int rs = (int)(p0 & 15);
  // vectors q0 + j0 .. q0 + j1 are the most the span loads
  if (16 * (q0 + j0) >= r.lo && 16 * (q0 + j1) + 16 <= r.hi)
    copy_span<false>(r, q0, rs, j0, j1, o + h, lane);
  else
    copy_span<true>(r, q0, rs, j0, j1, o + h, lane);
}

}  // namespace

// buf: [B, len] contiguous, elements of `itemsize` bytes (1, 2 or 4); start:
// [B] int32; out: [B, size] of the same element type, as torch.empty gives
// it (aligned to its element). Returns cudaGetLastError().
extern "C" int anet_gather_rows(const void* buf, int itemsize, int B, long long len,
                                const void* start, int size, void* out, void* stream) {
  if (B == 0 || size == 0) return (int)cudaSuccess;
  const int64_t nvec = (int64_t)size * itemsize / 16;
  const int64_t gy = (nvec + WARPS * SPAN - 1) / (WARPS * SPAN);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, gy > 0 ? (unsigned)gy : 1u);
  const int64_t total = (int64_t)B * len * itemsize;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const unsigned char*>(buf);
  const auto* s = static_cast<const int32_t*>(start);
  auto* o = static_cast<unsigned char*>(out);
  if (itemsize == 1) {
    gather_rows_kernel<uint8_t><<<grid, THREADS, 0, st>>>(x, total, len, s, size, o);
  } else if (itemsize == 2) {
    gather_rows_kernel<uint16_t><<<grid, THREADS, 0, st>>>(x, total, len, s, size, o);
  } else if (itemsize == 4) {
    gather_rows_kernel<uint32_t><<<grid, THREADS, 0, st>>>(x, total, len, s, size, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
