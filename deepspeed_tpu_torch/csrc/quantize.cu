// Grouped fake quantization for Hopper (sm_90a) of a whole table of
// leaves in one persistent launch. A leaf is a list of fp32 or bf16
// pieces (a stacked leaf: its L layer tensors in order) whose
// concatenation is cut into `groups` equal groups; each group is
// quantized to the leaf's `bits` and dequantized back to its dtype, with
// nearest or stochastic rounding, symmetric or asymmetric, optionally
// blended with the unquantized values, and written in place (or to each
// piece's own output).
//
// Replaces the Pallas kernel of deepspeed_tpu/ops/pallas/quantize.py:
// quantize (:109), _quant_kernel (:76), which runs one program a group
// with the whole group in VMEM, so each element is read from HBM once.
// Arithmetic, in fp32, as that kernel runs under XLA (the division by
// the constant qmax becomes a product with its rounded reciprocal `rcp`,
// which the wrapper passes):
//   symmetric:  scale = amax|x| * rcp (0 -> 1); t = x / scale;
//               q = clip(round(t), -qmax - 1, qmax); out = q * scale
//   asymmetric: scale = (max - min) * rcp (0 -> 1); t = (x - min) / scale;
//               q = clip(round(t), 0, 2^bits - 1); out = q * scale + min
//   round: rintf (half to even, as jnp.round), or floor(t + u) with
//   u = (r >> 8) * 2^-24 and r a Philox4x32-10 draw keyed by (the leaf's
//   seed, flat index in the leaf / 4), lane flat index % 4.
//   blend (ratio r): out = fl(fl(x * r) + fl(out * (1 - r))), each product
//   and the sum rounded to the leaf's dtype, as the three torch ops
//   q.mul_(1 - r), x.mul_(r).add_(q) and JAX's r * x + (1 - r) * q do.
// Every step is an IEEE operation rounded to nearest (__fmul_rn,
// __fdiv_rn, __fsub_rn, __fadd_rn: nvcc would contract a*b + c into an
// FMA), and max / min do not depend on order, so the kernel equals the
// plain version bit for bit. A NaN in a group makes every output of the
// group NaN, as jnp.max propagates it.
//
// What bounds it on the H100: 4 + 4 bytes an fp32 element (read, write)
// and ~10 fp32 operations: bound by bytes. One MoQ boundary of GPT-2
// large (773.5M fp32 master elements in 146 leaves) is 6.19 GB, 1.85 ms
// at 3.35 TB/s.
//
// What the design does about it. A group must be reduced (amax, or min
// and max) before any of it can be rounded, and a group is far larger
// than a block (GPT-2's wte: 8 groups of 32 MB). Here L2 (50 MB) does the
// job of the TPU's VMEM:
// 1. The wrapper cuts the table into tiles of at most TILE_BYTES, at
//    every piece edge and every group edge, each tile once as an R
//    (reduce) tile and once as an A (apply) tile, and into windows: runs
//    of whole groups under a byte budget well below L2 (a larger group is
//    a window of its own). Its work list puts window w's R tiles
//    interleaved with window w - 1's A tiles, the A tiles `lag` tiles
//    behind, so an A tile re-reads a window that was read one window
//    earlier and is still in L2: each element comes from device memory
//    once and goes back once.
// 2. One persistent grid (a few blocks an SM) takes tickets, in order,
//    from one global atomic counter and runs the ticket's tile, whose
//    48-byte entry holds its addresses, its group and the group's R-tile
//    count; the leaf's bits and rcp come from a small table of their own,
//    so a new bit width does not rebuild the work list. The last block to
//    finish zeroes the counters and the group slots, so the next launch
//    (or a CUDA graph's replay) starts from zero with no memset.
// 3. An R tile reads its elements with 16-byte loads, UNROLL in flight a
//    thread, reduces them across the block, folds the result into its
//    group's slot by atomicMax on the order-preserving integer image of
//    the float (a NaN sets a flag), then releases one increment of the
//    group's done-count.
// 4. An A tile waits, with acquire, until its group's done-count is the
//    group's number of R tiles, forms the scale exactly as the TPU kernel
//    does, and rounds, clips, dequantizes (and blends) its elements in
//    place. No deadlock: an A tile waits only on R tiles of smaller
//    tickets, which blocks that are running have taken (a block takes a
//    ticket only when it starts the tile), and an R tile waits on
//    nothing. A wait that outlasts seconds traps (a launch failure the
//    wrapper raises), not a hang.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;         // threads a block
constexpr int UNROLL = 4;       // 16-byte vectors in flight a thread
constexpr unsigned kPosInf = 0x7f800000u, kNegInf = 0xff800000u;

// a work-list entry, in ticket order (ops/cuda/quantize.py packs them)
struct __align__(16) Tile {
  const void* src;      // the tile's first element
  void* dst;            // where its result goes (src when in place)
  long long li0;        // the first element's flat index in its leaf
  unsigned ck;          // count | 1 << 31 for an A tile
  unsigned group;
  unsigned need;        // the group's R tiles
  unsigned meta;        // is_bf16 | vec_ok << 1 | leaf << 8
  unsigned pad[2];
};
// a group's slot in the scratch: the max (amax when symmetric) and the
// complement of the min as order-preserving images, the NaN flag, the
// done-count of its R tiles
struct Slot {
  unsigned hi, nlo, nan, done;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, bf16* p) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float rt(float v) {
  T t;
  from_f(v, &t);
  return to_f(t);
}

// max / min that keep a NaN (fmaxf / fminf drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// a float's order-preserving unsigned image (-0 below +0), and back
__device__ __forceinline__ unsigned enc(float f) {
  const unsigned i = __float_as_uint(f);
  return (i & 0x80000000u) ? ~i : (i | 0x80000000u);
}
__device__ __forceinline__ float dec(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
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

// elements before x's first 16-byte boundary, at most count
template <typename T>
__device__ __forceinline__ int head_of(const T* x, int count) {
  const int h = (int)(((16u - ((unsigned)(uintptr_t)x & 15u)) & 15u) /
                      sizeof(T));
  return h < count ? h : count;
}

// an R tile: x[0 .. count) reduced into its group's slot
template <typename T, bool SYM>
__device__ void reduce_tile(const T* x, int count, Slot* slot) {
  constexpr int VEC = 16 / (int)sizeof(T);   // elements a 16-byte vector
  float hi = __int_as_float(kNegInf), lo = __int_as_float(kPosInf);
  bool nan = false;
  auto take = [&](float v) {
    nan |= v != v;
    if (SYM) v = fabsf(v);
    hi = fmaxf(hi, v);
    lo = fminf(lo, v);
  };
  const int head = head_of(x, count);
  for (int i = threadIdx.x; i < head; i += NT) take(to_f(x[i]));
  const int nvec = (count - head) / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int v0 = threadIdx.x; v0 < nvec; v0 += NT * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * NT < nvec) buf[u] = __ldg(xv + v0 + u * NT);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v0 + u * NT < nvec) {
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) take(to_f(e[k]));
      }
    }
  }
  for (int i = head + nvec * VEC + threadIdx.x; i < count; i += NT)
    take(to_f(x[i]));
  if (nan) hi = lo = __int_as_float(0x7fc00000);
  block_reduce(hi, lo);
  if (threadIdx.x == 0) {
    if (hi != hi) {
      atomicOr(&slot->nan, 1u);
    } else {
      atomicMax(&slot->hi, enc(hi));
      if (!SYM) atomicMax(&slot->nlo, ~enc(lo));
    }
    // the slot's updates before the count
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(
                     &slot->done)
                 : "memory");
  }
}

// the scale and zero of an A tile's group, once its R tiles are done
// (thread 0 only)
template <bool SYM>
__device__ __forceinline__ void group_scale(const Slot* slot, unsigned need,
                                            float rcp, float& scale,
                                            float& lo) {
  for (long long n = 0; ld_acquire(&slot->done) != need; ++n) {
    if (n > (1LL << 26)) __trap();
    __nanosleep(64);
  }
  float hi = dec(ld_relaxed(&slot->hi));
  lo = SYM ? 0.0f : dec(~ld_relaxed(&slot->nlo));
  if (ld_relaxed(&slot->nan)) hi = lo = __int_as_float(0x7fc00000);
  scale = SYM ? __fmul_rn(hi, rcp) : __fmul_rn(__fsub_rn(hi, lo), rcp);
  if (scale == 0.0f) scale = 1.0f;
}

// an A tile: x[0 .. count) rounded into out; li0 is x[0]'s flat index in
// its leaf (Philox's counter)
template <typename T, bool SYM, bool SR, bool BLEND>
__device__ void apply_tile(const T* x, T* out, int count, long long li0,
                           bool vec_ok, int bits, float scale, float lo,
                           uint64_t key, float r, float omr) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const float qhi = SYM ? (float)((1 << (bits - 1)) - 1)
                        : (float)((1 << bits) - 1);
  const float qlo = SYM ? -qhi - 1.0f : 0.0f;
  // one element at leaf index i; rnd: the Philox draw of i / 4
  auto quant = [&](float v, long long i, uint4 rnd) {
    const float t = SYM ? __fdiv_rn(v, scale)
                        : __fdiv_rn(__fsub_rn(v, lo), scale);
    float q = SR ? floorf(__fadd_rn(t, lane_u(rnd, (int)(i & 3)))) : rintf(t);
    q = q < qlo ? qlo : (q > qhi ? qhi : q);     // a NaN stays NaN
    float o = SYM ? __fmul_rn(q, scale) : __fadd_rn(__fmul_rn(q, scale), lo);
    if (BLEND)
      o = __fadd_rn(rt<T>(__fmul_rn(v, r)), rt<T>(__fmul_rn(rt<T>(o), omr)));
    return o;
  };
  auto draw = [&](long long i) {
    return SR ? philox((uint64_t)i >> 2, key) : make_uint4(0, 0, 0, 0);
  };
  const int head = vec_ok ? head_of(x, count) : count;
  for (int i = threadIdx.x; i < head; i += NT)
    from_f(quant(to_f(x[i]), li0 + i, draw(li0 + i)), out + i);
  const int nvec = (count - head) / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  for (int v0 = threadIdx.x; v0 < nvec; v0 += NT * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * NT < nvec) buf[u] = __ldcs(xv + v0 + u * NT);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * NT;
      if (v < nvec) {
        const long long base = li0 + head + (long long)v * VEC;
        T* e = reinterpret_cast<T*>(&buf[u]);
        uint4 rnd = make_uint4(0, 0, 0, 0);
        long long rc = -1;                       // the counter rnd is of
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (SR && ((base + k) >> 2) != rc) {
            rc = (base + k) >> 2;
            rnd = draw(base + k);
          }
          from_f(quant(to_f(e[k]), base + k, rnd), e + k);
        }
        __stcs(ov + v, buf[u]);
      }
    }
  }
  for (int i = head + nvec * VEC + threadIdx.x; i < count; i += NT)
    from_f(quant(to_f(x[i]), li0 + i, draw(li0 + i)), out + i);
}

template <bool SYM, bool SR, bool BLEND>
__global__ void __launch_bounds__(NT, 4)
quant_leaves_kernel(const Tile* __restrict__ tiles, int n_tiles,
                    const uint2* __restrict__ leaf_params, unsigned* scratch,
                    int n_groups, const long long* __restrict__ seeds,
                    float r, float omr) {
  __shared__ int s_ticket;
  __shared__ float s_scale, s_lo;
  __shared__ bool s_last;
  unsigned* ticket = scratch;            // scratch[1]: blocks finished
  Slot* slots = reinterpret_cast<Slot*>(scratch + 4);
  for (;;) {
    if (threadIdx.x == 0) s_ticket = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int t = s_ticket;
    if (t >= n_tiles) break;
    const Tile d = tiles[t];
    const int count = (int)(d.ck & 0x7fffffffu);
    const bool bf = d.meta & 1u;
    Slot* slot = slots + d.group;
    if (!(d.ck >> 31)) {
      if (bf) reduce_tile<bf16, SYM>((const bf16*)d.src, count, slot);
      else reduce_tile<float, SYM>((const float*)d.src, count, slot);
    } else {
      const uint2 lp = leaf_params[d.meta >> 8];     // bits, rcp
      if (threadIdx.x == 0) {
        float scale, lo;
        group_scale<SYM>(slot, d.need, __uint_as_float(lp.y), scale, lo);
        s_scale = scale;
        s_lo = lo;
      }
      __syncthreads();
      const int bits = (int)lp.x;
      const bool vec_ok = (d.meta >> 1) & 1u;
      const uint64_t key = SR ? (uint64_t)seeds[d.meta >> 8] : 0;
      if (bf)
        apply_tile<bf16, SYM, SR, BLEND>((const bf16*)d.src, (bf16*)d.dst,
                                         count, d.li0, vec_ok, bits, s_scale,
                                         s_lo, key, r, omr);
      else
        apply_tile<float, SYM, SR, BLEND>((const float*)d.src, (float*)d.dst,
                                          count, d.li0, vec_ok, bits, s_scale,
                                          s_lo, key, r, omr);
    }
    __syncthreads();          // s_ticket and s_scale are the next tile's
  }
  // the last block out zeroes the counters and the slots for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(scratch + 1, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (s_last) {
    for (int i = threadIdx.x; i < 4 * (n_groups + 1); i += NT) scratch[i] = 0;
  }
}

}  // namespace

// One launch over a work list of n_tiles tiles (ops/cuda/quantize.py
// builds it): tiles [n_tiles] Tile in ticket order; leaf_params [leaves]
// (bits, fp32 rcp's bits); scratch: (n_groups + 1) * 16 bytes (the ticket
// counter, the finished-block counter, then a Slot a group), zero before
// the launch and zero again after it; seeds: one int64 a leaf on the
// device (read when stochastic); r, omr: the blend's fp32(r) and fp32(1 -
// r) (read when blend); blocks: the persistent grid.
extern "C" int dstpu_quantize_leaves(const void* tiles, int n_tiles,
                                     const void* leaf_params, void* scratch,
                                     int n_groups, const void* seeds, int sym,
                                     int stochastic, int blend, float r,
                                     float omr, int blocks, void* stream) {
  if (n_tiles < 1 || n_groups < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(blocks < n_tiles ? blocks : n_tiles);
#define QUANT_LEAVES(S, R, B)                                                \
  quant_leaves_kernel<S, R, B><<<grid, NT, 0, st>>>(                         \
      (const Tile*)tiles, n_tiles, (const uint2*)leaf_params,               \
      (unsigned*)scratch, n_groups, (const long long*)seeds, r, omr)
#define QUANT_LEAVES_B(S, R)                                                 \
  if (blend) QUANT_LEAVES(S, R, true);                                       \
  else QUANT_LEAVES(S, R, false)
  if (sym && stochastic) { QUANT_LEAVES_B(true, true); }
  else if (sym) { QUANT_LEAVES_B(true, false); }
  else if (stochastic) { QUANT_LEAVES_B(false, true); }
  else { QUANT_LEAVES_B(false, false); }
#undef QUANT_LEAVES_B
#undef QUANT_LEAVES
  return (int)cudaGetLastError();
}
