// The locked stream's n-lag probes, Hopper: demod_probe_fused's first
// launch and probe_at_fused, on one staged warp-per-stream front.
//
// demod_probe_fused replaces, with demod_at.cu's entry as its second
// launch, the TPU kernel anet/kernels/__init__.py demod_probe_fused
// (pallas_call at line 2415, body _demod_probe_kernel at line 2092). For
// each stream b with probe base st = st0[b]:
//   corr[o] = sum_j buf[st + o + j] * t[j]                (o < n_lags <= 8)
//   cmax    = max_o |corr[o]|, off = its first argmax (ties: earliest lag)
//   energy  = sum of buf[i]^2 over the row-aligned superset span
//             [e0, e0 + 128 pw_e), e0 = 128 floor(st / 128),
//             pw_e = ceil((k + n_lags - 1) / 128) + 1
//   start   = st + off, where the wrapper's second launch demodulates:
//             anet_demod_at (demod_at.cu's tensor-core align+demod; float32
//             buffers take its three-term bf16 split).
// The caller normalizes q = cmax * rsqrt(te * max(energy, 1e-4 te)).
//
// probe_at_fused replaces the TPU kernel anet/kernels/__init__.py
// probe_at_fused (pallas_call at line 1710, body _probe_at_kernel at line
// 1585), the unmerged lock step's probe (bfloat16 buffers on the path;
// float32 too): the same corr over the st-ALIGNED span [st, st + 128 pw_e),
// e0 = st, and it writes the normalized quality of every lag,
//   q[o] = |corr[o]| * rsqrt(te * max(energy, 1e-4 te)),
// te read from the card through its address when the caller passes one
// (the stream's template energy: no host read) or else taken by value.
//
// Reads outside [0, len) of the row are zero.
//
// An int8 buffer (the quantized stream carry; demod_probe_fused only)
// comes with the template quantized by the wrapper to round(t * 127 /
// max|t|): the correlation and the energy sum in int32 (exact: 2,304 x
// 127^2 passes float32's 2^24) and convert to float32 once, as the
// reference's int32 sums; the wrapper's cmax scale max|t| / 127 (a device
// pointer) multiplies cmax here. bfloat16 and float32 buffers take float32
// taps (bf16-rounded for bf16) and sum in float32.
//
// What bounds them on the H100: bytes, and little of them. Each stream's
// energy span is read once (2,304 samples at the uncoded path: 4.6 KB in
// bf16, 38 MB at B = 8192, 0.011 ms; 1,280 at the coded path's 1,024-tap
// preamble, 0.006 ms); the n_lags x k products a stream (84 M
// multiply-adds at B = 8192) take about a microsecond of the CUDA cores.
// The demod launch after demod_probe's reads the ~34,300-sample data span.
//
// Design: one warp per stream, WARPS streams a block. The TPU kernels' row
// selects, the second lag block for residues 124..127 and the one-hot
// slab shift were artefacts of their 128-lane rows; here the span is
// indexed directly. The energy span holds every probe window (at offset
// st - e0 < 128, 0 for probe_at), so each warp stages it once in its own
// shared memory with 16-byte cp.async copies aligned down to 16 bytes of
// the FLAT buffer (any row pitch, any start: the rule of demod_core.cuh's
// fetch): the source size zero-fills bytes at and past the row's end,
// chunks wholly outside the row read nothing, bytes before the row's start
// are zeroed after the copy lands. The block stages the template in
// shared memory meanwhile, behind the kernel's one barrier. Lane l takes
// taps l, l + 32, ... for every lag and samples l, l + 32, ... for the
// energy (consecutive lanes on consecutive samples: no bank conflict), and
// the warp reduces with xor shuffles in a fixed order (probe_sums, shared
// by both kernels); then lane 0 (demod_probe) or lane o (probe_at's lag o)
// writes. Where the taps and the 8 warps' spans pass a block's shared
// memory (a preamble past about 11,000 samples in bfloat16, 6,000 in
// float32: sps 480's 15,360), the *_direct kernels take the same sums in
// the same order from device memory (probe_sums_direct): the same bits.
#include "demod_core.cuh"

namespace {

constexpr int WARPS = 8;  // streams a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int32_t widen(int8_t v) { return v; }

__device__ __forceinline__ float mac(float x, float t, float acc) { return fmaf(x, t, acc); }
__device__ __forceinline__ int32_t mac(int32_t x, int32_t t, int32_t acc) { return acc + x * t; }

// 16-byte chunks of a warp's staged span: 128 pw_e samples from rb bytes
// into the first chunk, rb < 16.
template <typename T>
__host__ __device__ __forceinline__ int span_chunks(int pw_e) {
  return 8 * pw_e * (int)sizeof(T) + 1;
}

__host__ __device__ __forceinline__ int tap_bytes(int k) { return (4 * k + 15) / 16 * 16; }

template <typename T>
using ProbeAcc = std::conditional_t<std::is_same<T, int8_t>::value, int32_t, float>;  // taps, sums

// The probes' front, shared by both kernels. Every thread of the block
// calls it (it holds the kernel's one barrier). The warp of stream b stages
// the 128 pw_e samples from e0 (ROW_ALIGNED: 128 floor(st / 128), else st)
// and sums its NL correlations and the span's energy, the same in every
// lane. Returns false for a warp past the last stream (sums unset).
template <typename T, int NL, bool ROW_ALIGNED>
__device__ __forceinline__ bool probe_sums(const T* __restrict__ buf, int B, int64_t len,
                                           const int32_t* __restrict__ st0,
                                           const float* __restrict__ taps, int k, int pw_e,
                                           int64_t& st, ProbeAcc<T> (&corr)[NL], ProbeAcc<T>& en) {
  using Acc = ProbeAcc<T>;
  constexpr int E = 16 / (int)sizeof(T);  // samples a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  const int chunks = span_chunks<T>(pw_e);
  Acc* tap = reinterpret_cast<Acc*>(smem);
  unsigned char* span = smem + tap_bytes(k) + warp * 16 * chunks;

  // the warp's span copies first, so they fly while the block stages taps
  st = 0;
  int64_t p0 = 0;
  int rb = 0;
  if (b < B) {
    st = st0[b];
    const int64_t e0 = ROW_ALIGNED ? (st >= 0 ? st : st - 127) / 128 * 128  // floor, as the plain version's
                                   : st;
    const uintptr_t at = reinterpret_cast<uintptr_t>(buf) +
                         (uintptr_t)(((int64_t)b * len + e0) * (int64_t)sizeof(T));
    rb = (int)(at & 15);
    p0 = e0 - rb / (int)sizeof(T);  // row position of chunk 0's first sample
    const uintptr_t chunk0 = at - rb;
    for (int c = lane; c < chunks; c += 32) {
      const int64_t p = p0 + (int64_t)c * E;
      const int64_t left = len - p;  // samples of the row from the chunk's first on
      const int bytes = (p + E > 0 && left > 0) ? (int)(left < E ? left : E) * (int)sizeof(T) : 0;
      const void* src = bytes ? reinterpret_cast<const void*>(chunk0 + 16 * (uintptr_t)c)
                              : static_cast<const void*>(buf);
      anet::demod::cp_async16(span + 16 * c, src, bytes);
    }
  }
  anet::demod::cp_async_commit();
  for (int j = threadIdx.x; j < k; j += THREADS) tap[j] = (Acc)taps[j];
  __syncthreads();
  if (b >= B) return false;
  anet::demod::cp_async_wait<0>();
  if (p0 < 0) {  // zero the span's bytes before the row's start
    const int64_t before = -p0 * (int64_t)sizeof(T);
    const int z = before < 16 * chunks ? (int)before : 16 * chunks;
    __syncwarp();
    for (int y = lane; y < z; y += 32) span[y] = 0;
  }
  __syncwarp();

  const T* s = reinterpret_cast<const T*>(span + rb);  // s[i]: row position e0 + i
  const int d = (int)(st - (p0 + rb / (int)sizeof(T)));  // st - e0: in [0, 128), or 0
#pragma unroll
  for (int o = 0; o < NL; ++o) corr[o] = 0;
#pragma unroll 4
  for (int j = lane; j < k; j += 32) {
    const Acc t = tap[j];
#pragma unroll
    for (int o = 0; o < NL; ++o) corr[o] = mac(widen(s[d + o + j]), t, corr[o]);
  }
  en = 0;
#pragma unroll 4
  for (int i = lane; i < 128 * pw_e; i += 32) {
    const Acc v = widen(s[i]);
    en = mac(v, v, en);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
    for (int o = 0; o < NL; ++o) corr[o] += __shfl_xor_sync(0xffffffffu, corr[o], sh);
    en += __shfl_xor_sync(0xffffffffu, en, sh);
  }
  return true;
}

// probe_sums for a template and span past a block's shared memory (taps
// and 8 warps' spans of 128 pw_e samples: a preamble of about 11,000
// samples in bfloat16): the same sums in the same order, the samples read
// in place through the caches (zero outside [0, len)) and the taps through
// the read-only cache, so the same bits. No barrier.
template <typename T, int NL, bool ROW_ALIGNED>
__device__ __forceinline__ bool probe_sums_direct(const T* __restrict__ buf, int B, int64_t len,
                                                  const int32_t* __restrict__ st0,
                                                  const float* __restrict__ taps, int k, int pw_e,
                                                  int64_t& st, ProbeAcc<T> (&corr)[NL], ProbeAcc<T>& en) {
  using Acc = ProbeAcc<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return false;
  st = st0[b];
  const int64_t e0 = ROW_ALIGNED ? (st >= 0 ? st : st - 127) / 128 * 128 : st;
  const T* row = buf + (int64_t)b * len;
  auto sample = [&](int64_t p) -> Acc { return p >= 0 && p < len ? widen(row[p]) : Acc(0); };
#pragma unroll
  for (int o = 0; o < NL; ++o) corr[o] = 0;
#pragma unroll 4
  for (int j = lane; j < k; j += 32) {
    const Acc t = (Acc)__ldg(taps + j);
#pragma unroll
    for (int o = 0; o < NL; ++o) corr[o] = mac(sample(st + o + j), t, corr[o]);
  }
  en = 0;
#pragma unroll 4
  for (int i = lane; i < 128 * pw_e; i += 32) {
    const Acc v = sample(e0 + i);
    en = mac(v, v, en);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
    for (int o = 0; o < NL; ++o) corr[o] += __shfl_xor_sync(0xffffffffu, corr[o], sh);
    en += __shfl_xor_sync(0xffffffffu, en, sh);
  }
  return true;
}

// demod_probe_fused's probe's epilogue: lane 0 writes (cmax, off, energy,
// start) of stream b.
template <typename T, int NL>
__device__ __forceinline__ void probe_out(int64_t st, const ProbeAcc<T> (&corr)[NL], ProbeAcc<T> en,
                                          const float* __restrict__ cmax_scale, float* __restrict__ cmax_out,
                                          int32_t* __restrict__ off_out, float* __restrict__ energy_out,
                                          int32_t* __restrict__ start_out) {
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0) {
    float cm = -1.0f;
    int off = 0;
#pragma unroll
    for (int o = 0; o < NL; ++o) {
      const float c = fabsf((float)corr[o]);  // int32: rounded to nearest once
      if (c > cm) {  // strict: the first lag wins ties
        cm = c;
        off = o;
      }
    }
    cmax_out[b] = cmax_scale ? __fmul_rn(cm, *cmax_scale) : cm;
    off_out[b] = off;
    energy_out[b] = (float)en;
    start_out[b] = (int32_t)(st + off);
  }
}

// probe_at_fused's epilogue: q [B, NL], lane o writes lag o. te from te_ptr
// when not null, else te_val.
template <int NL>
__device__ __forceinline__ void probe_at_out(const float (&corr)[NL], float en,
                                             const float* __restrict__ te_ptr, float te_val,
                                             float* __restrict__ q_out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (lane < NL) {
    const float te = te_ptr ? *te_ptr : te_val;
    float c = 0.0f;
#pragma unroll
    for (int o = 0; o < NL; ++o)
      if (lane == o) c = corr[o];
    q_out[b * NL + lane] = fabsf(c) * rsqrtf(te * fmaxf(en, 1e-4f * te));
  }
}

// demod_probe_fused's probe: (cmax, off, energy, start) of each stream;
// DIRECT past a block's shared memory (probe_sums_direct).
template <typename T, int NL, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const T* __restrict__ buf, int B, int64_t len, const int32_t* __restrict__ st0,
             const float* __restrict__ taps, int k, int pw_e,
             const float* __restrict__ cmax_scale, float* __restrict__ cmax_out,
             int32_t* __restrict__ off_out, float* __restrict__ energy_out,
             int32_t* __restrict__ start_out) {
  int64_t st;
  ProbeAcc<T> corr[NL], en;
  const bool live = DIRECT ? probe_sums_direct<T, NL, true>(buf, B, len, st0, taps, k, pw_e, st, corr, en)
                           : probe_sums<T, NL, true>(buf, B, len, st0, taps, k, pw_e, st, corr, en);
  if (!live) return;
  probe_out<T, NL>(st, corr, en, cmax_scale, cmax_out, off_out, energy_out, start_out);
}

// probe_at_fused: q [B, NL], lane o writes lag o; DIRECT as above.
template <typename T, int NL, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
probe_at_kernel(const T* __restrict__ buf, int B, int64_t len, const int32_t* __restrict__ st0,
                const float* __restrict__ taps, int k, int pw_e, const float* __restrict__ te_ptr,
                float te_val, float* __restrict__ q_out) {
  static_assert(!std::is_same<T, int8_t>::value, "probe_at takes float32 and bfloat16 buffers");
  int64_t st;
  float corr[NL], en;
  const bool live = DIRECT ? probe_sums_direct<T, NL, false>(buf, B, len, st0, taps, k, pw_e, st, corr, en)
                           : probe_sums<T, NL, false>(buf, B, len, st0, taps, k, pw_e, st, corr, en);
  if (!live) return;
  probe_at_out<NL>(corr, en, te_ptr, te_val, q_out);
}

// Raise `kernel`'s dynamic shared memory limit to smem where it needs more
// than it has (smem_set: the caller's record of the limit, a static of
// each instantiation).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int& smem_set) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  return cudaSuccess;
}

template <typename T>
int64_t probe_smem(int k, int pw_e) {
  return (int64_t)tap_bytes(k) + WARPS * 16 * (int64_t)span_chunks<T>(pw_e);
}

// f(std::integral_constant<int, n_lags>{}): the instantiation of n_lags.
template <typename F>
cudaError_t dispatch_lags(int n_lags, F&& f) {
  switch (n_lags) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

struct Args {
  const void* buf;
  int B;
  long long len;
  const void* st0;
  const void* taps;
  int k, pw_e;
  const void* cmax_scale;
  void *cmax, *off, *energy, *start;
  cudaStream_t st;
};

template <typename T, int NL>
cudaError_t launch(const Args& a) {
  static int smem_set = 48 * 1024;  // this instantiation's dynamic shared memory limit
  const int64_t need = probe_smem<T>(a.k, a.pw_e);
  const bool staged = need <= MAX_SMEM;  // else the same sums read in place
  auto kernel = staged ? probe_kernel<T, NL, false> : probe_kernel<T, NL, true>;
  const int smem = staged ? (int)need : 0;
  const cudaError_t err = staged ? allow_smem(kernel, smem, smem_set) : cudaSuccess;
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + WARPS - 1) / WARPS, THREADS, smem, a.st>>>(
      static_cast<const T*>(a.buf), a.B, a.len, static_cast<const int32_t*>(a.st0),
      static_cast<const float*>(a.taps), a.k, a.pw_e, static_cast<const float*>(a.cmax_scale),
      static_cast<float*>(a.cmax), static_cast<int32_t*>(a.off), static_cast<float*>(a.energy),
      static_cast<int32_t*>(a.start));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lags(int n_lags, const Args& a) {
  return dispatch_lags(n_lags, [&](auto nl) { return launch<T, decltype(nl)::value>(a); });
}

struct AtArgs {
  const void* buf;
  int B;
  long long len;
  const void* st0;
  const void* taps;
  int k, pw_e;
  const void* te_ptr;
  float te;
  void* q;
  cudaStream_t st;
};

template <typename T, int NL>
cudaError_t launch_at(const AtArgs& a) {
  static int smem_set = 48 * 1024;
  const int64_t need = probe_smem<T>(a.k, a.pw_e);
  const bool staged = need <= MAX_SMEM;  // else the same sums read in place
  auto kernel = staged ? probe_at_kernel<T, NL, false> : probe_at_kernel<T, NL, true>;
  const int smem = staged ? (int)need : 0;
  const cudaError_t err = staged ? allow_smem(kernel, smem, smem_set) : cudaSuccess;
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + WARPS - 1) / WARPS, THREADS, smem, a.st>>>(
      static_cast<const T*>(a.buf), a.B, a.len, static_cast<const int32_t*>(a.st0),
      static_cast<const float*>(a.taps), a.k, a.pw_e, static_cast<const float*>(a.te_ptr), a.te,
      static_cast<float*>(a.q));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_at_lags(int n_lags, const AtArgs& a) {
  return dispatch_lags(n_lags, [&](auto nl) { return launch_at<T, decltype(nl)::value>(a); });
}

}  // namespace

// buf: [B, len] contiguous, any alignment; st0: [B] int32 probe bases;
// taps: [k] float32 (the x127 integers for an int8 buffer); cmax_scale:
// a float32 scalar on the card that multiplies cmax, or null; cmax,
// energy: [B] float32; off, start: [B] int32. n_lags in 1..8 and 128 pw_e
// >= k + n_lags + 126 (the window inside the span at every residue).
// Returns cudaGetLastError().
extern "C" int anet_demod_probe(const void* buf, int dtype, int B, long long len,
                                const void* st0, const void* taps, int k, int n_lags, int pw_e,
                                const void* cmax_scale, void* cmax, void* off, void* energy,
                                void* start, void* stream) {
  if (k < 1 || n_lags < 1 || n_lags > 8 || 128LL * pw_e < (long long)k + n_lags + 126)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{buf, B, len, st0, taps, k, pw_e, cmax_scale, cmax, off, energy, start,
               reinterpret_cast<cudaStream_t>(stream)};
  if (dtype == anet::DTYPE_BF16) return (int)launch_lags<__nv_bfloat16>(n_lags, a);
  if (dtype == anet::DTYPE_I8) return (int)launch_lags<int8_t>(n_lags, a);
  return (int)launch_lags<float>(n_lags, a);
}

// probe_at_fused. buf: [B, len] contiguous, any alignment, float32 or
// bfloat16; st0: [B] int32 probe bases; taps: [k] float32 (bf16-rounded
// for a bf16 buffer); te_ptr: the template energy, a float32 scalar on the
// card, or null to take te; q: [B, n_lags] float32. n_lags in 1..8 and
// 128 pw_e >= k + n_lags - 1 (every window inside the span). Returns
// cudaGetLastError().
extern "C" int anet_probe_at(const void* buf, int dtype, int B, long long len, const void* st0,
                             const void* taps, int k, int n_lags, int pw_e, const void* te_ptr,
                             float te, void* q, void* stream) {
  if (k < 1 || n_lags < 1 || n_lags > 8 || 128LL * pw_e < (long long)k + n_lags - 1 ||
      dtype == anet::DTYPE_I8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const AtArgs a{buf, B, len, st0, taps, k, pw_e, te_ptr, te, q,
                 reinterpret_cast<cudaStream_t>(stream)};
  if (dtype == anet::DTYPE_BF16) return (int)launch_at_lags<__nv_bfloat16>(n_lags, a);
  return (int)launch_at_lags<float>(n_lags, a);
}
