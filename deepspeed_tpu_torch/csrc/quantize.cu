// Grouped fake quantization for Hopper (sm_90a): x [groups, n], fp32 or
// bf16, quantized to `bits` bits per group and dequantized back to x's
// dtype, with nearest or stochastic rounding, symmetric or asymmetric.
//
// Replaces the Pallas kernel of deepspeed_tpu/ops/pallas/quantize.py:
// quantize (:109), _quant_kernel (:76), which runs one program a group
// with the whole group in VMEM. Arithmetic, in fp32, as that kernel runs
// under XLA (the division by the constant qmax becomes a product with its
// rounded reciprocal `rcp`, which the wrapper passes):
//   symmetric:  scale = amax|x| * rcp (0 -> 1); t = x / scale;
//               q = clip(round(t), -qmax - 1, qmax); out = q * scale
//   asymmetric: scale = (max - min) * rcp (0 -> 1); t = (x - min) / scale;
//               q = clip(round(t), 0, 2^bits - 1); out = q * scale + min
//   round: rintf (half to even, as jnp.round), or floor(t + u) with
//   u = (r >> 8) * 2^-24 and r a Philox4x32-10 draw keyed by (seed, flat
//   index / 4), lane flat index % 4.
// Every step is an IEEE operation rounded to nearest (__fmul_rn,
// __fdiv_rn, __fsub_rn, __fadd_rn: nvcc would contract a*b + c into an
// FMA), so the kernel equals the plain version bit for bit. A NaN in a
// group makes every output of the group NaN, as jnp.max propagates it.
//
// What bounds it on the H100: 4 + 4 bytes an fp32 element (read, write)
// and ~10 fp32 operations: bound by bytes. One MoQ boundary of GPT-2
// large (773.5M fp32 master elements) is 6.19 GB, 1.85 ms at 3.35 TB/s.
//
// What the design does about it. The TPU grid (one program a group) would
// leave 131 of 132 SMs idle on a single group of 64.4M elements (GPT-2's
// wte at groups = 1), so a group is split over many blocks, twice:
// 1. quant_reduce_kernel: block b of group g reduces its chunk of the
//    group (amax, or min and max) with 16-byte loads, four in flight a
//    thread, and warp shuffles, into partial[g][b]. No atomics.
// 2. quant_apply_kernel: the same grid; each block first reduces its
//    group's nblk partials (at most a few KB, from L2), then rounds its
//    chunk and writes it. out may be x (in place): each element is read
//    and written by the same thread, after pass 1 has read everything.
// The wrapper picks nblk so that the grid is about 1024 blocks of 256
// threads (8 a SM) whatever the number of groups.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;         // threads a block
constexpr int UNROLL = 4;       // 16-byte vectors in flight a thread
constexpr unsigned kPosInf = 0x7f800000u, kNegInf = 0xff800000u;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, bf16* p) {
  *p = __float2bfloat16_rn(v);
}

// max / min that keep a NaN (fmaxf / fminf drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// Philox4x32-10 (Salmon et al., SC'11): counter (c, 0, 0, 0), key seed
__device__ __forceinline__ uint4 philox(uint64_t c, uint64_t seed) {
  uint32_t c0 = (uint32_t)c, c1 = (uint32_t)(c >> 32), c2 = 0, c3 = 0;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float lane_u(uint4 r, int lane) {
  const uint32_t v = lane == 0 ? r.x : lane == 1 ? r.y : lane == 2 ? r.z : r.w;
  return (float)(v >> 8) * (1.0f / 16777216.0f);
}

// the chunk [start, end) of flat indices that block b of group g owns, and
// a0: the first index of its 16-byte aligned part (end when x is not
// aligned)
struct Span {
  int64_t start, a0, end;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <int VEC>
__device__ __forceinline__ Span block_span(int64_t n, int nblk, int64_t chunk,
                                           bool vec_ok) {
  const int64_t g = blockIdx.x / nblk, b = blockIdx.x % nblk;
  Span s;
  s.start = g * n + min64(b * chunk, n);
  s.end = g * n + min64((b + 1) * chunk, n);
  s.a0 = vec_ok ? min64(s.end, (s.start + VEC - 1) / VEC * VEC) : s.end;
  return s;
}

// block-wide reduction of (a, b) by (nan_max, nan_min); the result is in
// every thread
__device__ __forceinline__ void block_reduce(float& a, float& b) {
  __shared__ float sa[NT / 32], sb[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = nan_min(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) {
    a = nan_max(a, sa[w]);
    b = nan_min(b, sb[w]);
  }
}

// pass 1: partial[2 blockIdx.x] = max (amax when sym), [+1] = min
template <typename T>
__global__ void __launch_bounds__(NT)
quant_reduce_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int64_t n, int nblk, int64_t chunk, bool sym,
                    bool vec_ok) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte vector
  const Span s = block_span<VEC>(n, nblk, chunk, vec_ok);
  float hi = __int_as_float(kNegInf), lo = __int_as_float(kPosInf);
  bool nan = false;
  auto take = [&](float v) {
    nan |= v != v;
    if (sym) v = fabsf(v);
    hi = fmaxf(hi, v);
    lo = fminf(lo, v);
  };
  for (int64_t i = s.start + threadIdx.x; i < s.a0; i += NT) take(to_f(x[i]));
  const int64_t nvec = (s.end - s.a0) / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.a0);
  for (int64_t v0 = threadIdx.x; v0 < nvec; v0 += (int64_t)NT * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + (int64_t)u * NT;
      if (v < nvec) buf[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v0 + (int64_t)u * NT < nvec) {
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) take(to_f(e[k]));
      }
    }
  }
  for (int64_t i = s.a0 + nvec * VEC + threadIdx.x; i < s.end; i += NT)
    take(to_f(x[i]));
  if (nan) hi = lo = __int_as_float(0x7fc00000);
  block_reduce(hi, lo);
  if (threadIdx.x == 0) {
    partial[2 * (int64_t)blockIdx.x] = hi;
    partial[2 * (int64_t)blockIdx.x + 1] = lo;
  }
}

// pass 2: the group's scale from its partials, then round every element
template <typename T, bool SYM, bool SR>
__global__ void __launch_bounds__(NT)
quant_apply_kernel(const T* x, T* out, const float* __restrict__ partial,
                   const long long* __restrict__ seed, int64_t n, int nblk,
                   int64_t chunk, int bits, float rcp, bool vec_ok) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte vector
  const Span s = block_span<VEC>(n, nblk, chunk, vec_ok);
  const float* part = partial + 2 * (blockIdx.x / nblk) * (int64_t)nblk;
  float hi = __int_as_float(kNegInf), lo = __int_as_float(kPosInf);
  for (int b = threadIdx.x; b < nblk; b += NT) {
    hi = nan_max(hi, part[2 * b]);
    lo = nan_min(lo, part[2 * b + 1]);
  }
  block_reduce(hi, lo);
  float scale = SYM ? __fmul_rn(hi, rcp) : __fmul_rn(__fsub_rn(hi, lo), rcp);
  if (scale == 0.0f) scale = 1.0f;
  const float qhi = SYM ? (float)((1 << (bits - 1)) - 1)
                        : (float)((1 << bits) - 1);
  const float qlo = SYM ? -qhi - 1.0f : 0.0f;
  const uint64_t key = SR ? (uint64_t)seed[0] : 0;

  // one element at flat index i; r: the Philox draw of i / 4
  auto quant = [&](float v, int64_t i, uint4 r) {
    const float t = SYM ? __fdiv_rn(v, scale)
                        : __fdiv_rn(__fsub_rn(v, lo), scale);
    float q = SR ? floorf(__fadd_rn(t, lane_u(r, (int)(i & 3)))) : rintf(t);
    q = q < qlo ? qlo : (q > qhi ? qhi : q);     // a NaN stays NaN
    return SYM ? __fmul_rn(q, scale) : __fadd_rn(__fmul_rn(q, scale), lo);
  };
  auto draw = [&](int64_t i) {
    return SR ? philox((uint64_t)i >> 2, key) : make_uint4(0, 0, 0, 0);
  };
  for (int64_t i = s.start + threadIdx.x; i < s.a0; i += NT)
    from_f(quant(to_f(x[i]), i, draw(i)), out + i);
  const int64_t nvec = (s.end - s.a0) / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.a0);
  uint4* ov = reinterpret_cast<uint4*>(out + s.a0);
  for (int64_t v0 = threadIdx.x; v0 < nvec; v0 += (int64_t)NT * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + (int64_t)u * NT;
      if (v < nvec) buf[u] = xv[v];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + (int64_t)u * NT;
      if (v < nvec) {
        const int64_t base = s.a0 + v * VEC;    // a multiple of 4
        T* e = reinterpret_cast<T*>(&buf[u]);
        uint4 r = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (k % 4 == 0) r = draw(base + k);
          from_f(quant(to_f(e[k]), base + k, r), e + k);
        }
        ov[v] = buf[u];
      }
    }
  }
  for (int64_t i = s.a0 + nvec * VEC + threadIdx.x; i < s.end; i += NT)
    from_f(quant(to_f(x[i]), i, draw(i)), out + i);
}

template <typename T>
int launch(const void* x, void* out, void* partial, const void* seed,
           int groups, int n, int nblk, int chunk, int bits, int sym,
           int stochastic, float rcp, cudaStream_t st) {
  const bool vec_ok = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const unsigned grid = (unsigned)groups * (unsigned)nblk;
  quant_reduce_kernel<T><<<grid, NT, 0, st>>>((const T*)x, (float*)partial,
                                              n, nblk, chunk, sym != 0,
                                              vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define QUANT_APPLY(S, R)                                                    \
  quant_apply_kernel<T, S, R><<<grid, NT, 0, st>>>(                          \
      (const T*)x, (T*)out, (const float*)partial, (const long long*)seed,   \
      n, nblk, chunk, bits, rcp, vec_ok)
  if (sym && stochastic) QUANT_APPLY(true, true);
  else if (sym) QUANT_APPLY(true, false);
  else if (stochastic) QUANT_APPLY(false, true);
  else QUANT_APPLY(false, false);
#undef QUANT_APPLY
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [groups, n] fp32 (is_bf16 0) or bf16 (1), contiguous, out may
// be x; partial: fp32 scratch [groups * nblk * 2]; seed: one int64 on the
// device (read when stochastic); chunk: elements a block, a multiple of 8,
// nblk * chunk >= n; rcp: fp32(1 / qmax) (sym) or fp32(1 / (2^bits - 1))
extern "C" int dstpu_quantize(const void* x, void* out, void* partial,
                              const void* seed, int groups, int n, int nblk,
                              int chunk, int bits, int sym, int stochastic,
                              int is_bf16, float rcp, void* stream) {
  if (groups < 1 || n < 1 || nblk < 1 || chunk < 1 || bits < 1 || bits > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16>(x, out, partial, seed, groups, n, nblk, chunk,
                                bits, sym, stochastic, rcp, st)
                 : launch<float>(x, out, partial, seed, groups, n, nblk,
                                 chunk, bits, sym, stochastic, rcp, st);
}
