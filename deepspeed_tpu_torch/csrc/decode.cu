// Decode-tick (S=1) kernels for paged GPT-2 and LLaMA serving on Hopper
// (sm_90a).
//
// Replaces seven Pallas kernels of deepspeed_tpu/ops/pallas/decode.py:
//   ln_qkv_int8_stacked     (:432, kernel _ln_qkv_stacked_kernel :496)
//   matvec_int8_stacked     (:523, kernel _matvec_stacked_kernel :558)
//   out_ffn_int8_stacked    (:698, kernel _out_ffn_stacked_kernel :1000)
//   decode_attention_paged  (:854, kernel _decode_attn_paged_kernel :931)
//   kv_quant_int8           (:297, kernel _kv_quant_kernel :279)
//   decode_attention_int8_stacked, decode_attention_fp_stacked
//                           (:565, :794, kernel _decode_attn_stacked_kernel
//                            :643)
// and the four unstacked ones, which compute the stacked kernels' function
// at one layer and run their device code with a one-layer view (a null
// layer pointer reads as layer 0):
//   matvec_int8             (:75, kernel _matvec_kernel :63)
//   decode_attention_int8   (:163, kernel _decode_attn_kernel :110)
//   ln_qkv_int8             (:245, kernel _ln_qkv_kernel :225)
//   out_ffn_int8            (:359, kernel _out_ffn_kernel :320)
// for bf16 activations: GPT-2's LayerNorm/bias/gelu_tanh contract and
// LLaMA's RMSNorm/bias-free/SwiGLU one, each with bf16 weights or int8
// codes and per-layer scales; head dim 64 or 128, GQA query rows, a bf16 KV
// cache or an int8 one with per-row fp32 scales.
//
// What bounds them on the H100: bytes. At 8 slots a decode matvec does
// 2*B = 16 flops per weight byte read, far below the ~295 flop/byte the
// card needs before the tensor cores limit, so each projection is a
// stream of W[layer] through the SMs at 3.35 TB/s, and paged attention
// is a stream of the live K/V rows.
//
// What the design does about it:
// - The TPU kernels carry state across a sequential grid in VMEM scratch
//   (LN once at grid step 0, an fp32 accumulator revisited by every F
//   tile). CUDA blocks run in no order, so a matvec block owns a 64-column
//   tile and a slice of K outright, recomputes the tiny LayerNorm
//   prologue itself (8 x 1280 values), and the blocks that share a tile
//   form a thread-block cluster that sums their partials through
//   distributed shared memory, in a fixed order.
// - A load that takes only a 32- or 64-byte piece of a 128-byte line
//   holds an SM's weight stream far below its share of the bandwidth
//   (clock64 phases on an H100), so 8 lanes read one whole line of a W
//   row, K is split over up to 8 blocks so at least
//   160 blocks stream, each thread keeps its next batch of rows in flight
//   during the current one's FMAs, and u sits transposed in shared memory
//   (one 16-byte load gives a row's 8 batch values).
// - Round trips are counted too: the input rows and the layer's LayerNorm
//   parameters come in one batch of 16-byte loads, and the epilogue's
//   bias and residual are requested before the weight stream.
// - out_ffn needs the whole x1 row before its LayerNorm and the whole F
//   row before W2, so it is three launches of one templated matvec:
//   (a) x1 = x + ctx.Wp.sp + bp, (b) h = gelu_tanh(LN(x1).W1.s1 + b1),
//   (c) y = x1 + h.W2.s2 + b2; a block holds only its K slice of h.
//   Rounding points follow the Pallas kernel: x1, u and h are rounded to
//   bf16, every product accumulates in fp32.
// - LLaMA (fuse_proj=False, the large-E path): x arrives as the bf16 x1
//   (o_proj ran as matvec_stacked), so (a) is skipped. (b) streams the
//   gate and up tiles together as the Pallas kernel does (decode.py:709):
//   the blocks of a column tile's gate half and of its up half form one
//   cluster, each streams its own matrix, and the epilogue takes both
//   sums from distributed shared memory: h = silu(u.Wg.sg) * (u.Wu.su).
//   Its RMSNorm prologue stages the bf16 x1 rows (8 x 4096 x 2 B = 64 KiB
//   at LLaMA-7B); fp32 rows would not leave room for u at 8 slots.
// - The layer index (a one-element device int32) and the per-layer
//   scales are read on the device, so a layer loop never syncs to the
//   host.
// - Paged attention: one block per (KV head, slot), reading page_table
//   itself (there is no scalar prefetch). Its 8 warps split the slot's
//   live keys in 16-key groups, each warp with its own fp32 online
//   softmax, holding the next group's K/V in registers while it computes
//   the current one (no shared-memory staging, no block barrier in the
//   loop); the block merges the 8 states at the end. Head dim D is a
//   template parameter: D/32 lanes own a key for the score (32 dims
//   each), a lane owns D/32 dims of P.V, and a group holds 1024/D keys
//   (16 at D 64, 8 at D 128), so a warp's K/V registers do not grow with
//   D. GQA: the R query rows of a KV head share its stream. Splitting
//   one slot over several blocks ("flash-decoding") is later work: a
//   long slot still runs on one SM.
// - int8 weight codes (LLaMA's quantized serving): a 128-byte line of an
//   int8 row holds 128 columns, so the int8 matvec's column tile is 128
//   and 16 lanes read a line, 8 bytes (8 columns) each: every load still
//   takes whole lines and a lane keeps the same [MAXB x 8] accumulator;
//   each thread keeps twice as many rows in flight, so the bytes in
//   flight match the bf16 stream. A code converts to float exactly, the
//   products accumulate in fp32 and the sum is multiplied by s[layer], as
//   the Pallas kernels do (w.astype(bf16), a bf16 dot, then * s).
// - The int8 KV cache: at head dim 128 a key row is 128 bytes, so 2 lanes
//   own a key (64 dims each, the same four 16-byte loads as bf16's 32) and
//   a group holds 16 keys; a lane's 4 dims of a V row are one 32-bit word.
//   At head dim 64 a key row is 64 bytes: 2 lanes still own a key (32 dims,
//   two 16-byte loads), so a group keeps 16 keys and a page of 16 rows
//   holds whole groups; a lane's 2 dims of a V row are a 16-bit load.
//   The lane that owns a key also reads its two fp32 scales. The order of
//   operations is the Pallas kernel's (decode.py:964-991): s = q.k * scale
//   * ks[row], the softmax sum takes the unscaled p, P.V takes
//   bf16(p * vs[row]).
// - The contiguous layer-stacked cache [Lyr, B, H, L, D] of the dense fast
//   path shares the paged kernel's body through its addressing: with no
//   page table, slot b's keys are one "page" of L rows in block b, and one
//   position (a device scalar, pos_stride 0) serves every slot. Only the
//   groups up to pos are read, as the Pallas kernel skips blocks past it.
// - kv_quant_int8: one warp per (slot, head, K or V) row: amax by warp
//   shuffles, the scale amax * fl(1/127) as XLA compiles amax / 127.0, an
//   IEEE division and rintf (round half to even, as jnp.round), so the
//   codes and scales equal the plain version's bit for bit. It
//   writes straight into the cache (pool block blk[b], row rows[b], or the
//   stacked cache's position), which Mosaic could not (decode.py:281).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

// jax.nn.gelu(approximate=False)
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// jax.nn.silu
__device__ __forceinline__ float silu_f32(float v) {
  return v / (1.f + __expf(-v));
}

enum { PRO_COPY = 0, PRO_LN_BF16 = 1, PRO_LN_F32 = 2, PRO_RMS_BF16 = 3 };
// EPI_BIAS: a*s (+ b); EPI_RESID: resid + a*s (+ b); EPI_GELU /
// EPI_GELU_ERF: gelu_tanh / gelu of a*s (+ b); EPI_SWIGLU (paired gate/up
// launches only): silu(a_gate*s_gate) * (a_up*s_up). A null bias adds
// nothing.
enum { EPI_BIAS = 0, EPI_RESID_X1 = 1, EPI_GELU = 2, EPI_RESID = 3,
       EPI_SWIGLU = 4, EPI_GELU_ERF = 5 };

// bytes of one element of the kernel's input rows
template <int PRO>
__host__ __device__ constexpr int in_bytes() {
  return PRO == PRO_LN_F32 ? 4 : 2;
}

constexpr int kStageBatch = 8;           // 16-byte loads in flight a thread
constexpr int kMaxSplit = 8;             // blocks a cluster (portable limit)

// The weight stream's geometry for weight type TW: a lane reads 8 columns
// of a W row (16 bytes of bf16, 8 of int8), so 8 or 16 lanes cover one
// 128-byte line and a block's column tile is 64 or 128.
template <typename TW>
struct WGeom {
  static constexpr int kLanes = sizeof(TW) == 2 ? 8 : 16;  // lanes a line
  static constexpr int kCols = kLanes * 8;                 // a column tile
  static constexpr int kRowGroups = kThreads / kLanes;     // rows a step
  using Vec = typename std::conditional<sizeof(TW) == 2, uint4, uint2>::type;
};

// the 8 bf16 values of a 16-byte vector, as floats
__device__ __forceinline__ void unpack8(const uint4 v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the 4 int8 codes of a 32-bit word, as floats, exactly: byte c ^ 0x80 is
// c + 128 in [0, 255], and 2^23 + (c + 128) - (2^23 + 128) = c
__device__ __forceinline__ void unpack4_i8(uint32_t w, float f[4]) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(0x4b000000u | ((w >> (8 * i)) & 0xffu)) -
           8388736.f;
}

// the 8 int8 codes of an 8-byte vector, as floats
__device__ __forceinline__ void unpack8(const uint2 v, float f[8]) {
  unpack4_i8(v.x, f);
  unpack4_i8(v.y, f + 4);
}

__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Copies three runs of 16-byte vectors from global to shared memory as one
// index space. Each thread issues kStageBatch loads before its first
// store, so a prologue costs about one memory latency, not one per vector.
__device__ __forceinline__ void stage_rows(
    uint4* d0, const uint4* __restrict__ s0, int n0, uint4* d1,
    const uint4* __restrict__ s1, int n1, uint4* d2,
    const uint4* __restrict__ s2, int n2) {
  const int total = n0 + n1 + n2;
  for (int base = threadIdx.x; base < total; base += kStageBatch * kThreads) {
    uint4 r[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < n0) r[j] = __ldg(s0 + i);
      else if (i < n0 + n1) r[j] = __ldg(s1 + (i - n0));
      else if (i < total) r[j] = __ldg(s2 + (i - n0 - n1));
    }
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < n0) d0[i] = r[j];
      else if (i < n0 + n1) d1[i - n0] = r[j];
      else if (i < total) d2[i - n0 - n1] = r[j];
    }
  }
}

// ut[kk][b] = bf16(LayerNorm(x[b]) * w + b) at k = k_lo + kk of the block's
// K slice (kk < klen). One warp per row; the statistics take the whole
// staged row, two-pass as in _ln (decode.py:217); w, b are the staged
// slice of the layer's parameters.
template <int MAXB, typename Tin>
__device__ void layer_norm_slice(const Tin* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 bf16* __restrict__ ut, int B, int K,
                                 int k_lo, int klen, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < B; r += kWarps) {
    const Tin* xr = x + (size_t)r * K;
    float f[8], s = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      load8(xr + k, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    const float mu = warp_sum(s) / K;
    float v = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      load8(xr + k, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
    }
    const float rstd = rsqrtf(warp_sum(v) / K + eps);
    for (int kk = lane * 8; kk < klen; kk += 256) {
      float g[8], h[8];
      load8(xr + k_lo + kk, f);
      load8(w + kk, g);
      load8(b + kk, h);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ut[(kk + i) * MAXB + r] =
            __float2bfloat16((f[i] - mu) * rstd * g[i] + h[i]);
    }
  }
}

// ut[kk][b] = bf16(x[b] * rsqrt(mean(x[b]^2) + eps) * w) at k = k_lo + kk,
// as _rms (decode.py:425): fp32 mean of squares over the whole staged row.
template <int MAXB>
__device__ void rms_norm_slice(const bf16* __restrict__ x,
                               const float* __restrict__ w,
                               bf16* __restrict__ ut, int B, int K, int k_lo,
                               int klen, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < B; r += kWarps) {
    const bf16* xr = x + (size_t)r * K;
    float f[8], s = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      load8(xr + k, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i] * f[i];
    }
    const float rstd = rsqrtf(warp_sum(s) / K + eps);
    for (int kk = lane * 8; kk < klen; kk += 256) {
      float g[8];
      load8(xr + k_lo + kk, f);
      load8(w + kk, g);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ut[(kk + i) * MAXB + r] = __float2bfloat16(f[i] * rstd * g[i]);
    }
  }
}

// dst[j] = W row k0 + j * kRowGroups (the thread's 8 columns), or zeros at
// and past row k_hi: one predicated batch of loads.
template <int NB, typename TW>
__device__ __forceinline__ void load_w_rows(
    typename WGeom<TW>::Vec (&dst)[NB], const TW* __restrict__ Wl, int ncols,
    int k0, int k_hi) {
  using Vec = typename WGeom<TW>::Vec;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int k = k0 + j * WGeom<TW>::kRowGroups;
    dst[j] = k < k_hi ? __ldg(reinterpret_cast<const Vec*>(
                            Wl + (size_t)k * ncols))
                      : Vec{};
  }
}

// out[b, n] = epilogue(sum_k u[b, k] * W[layer, k, n]), u = prologue(xin).
//
// Grid (N / kCols column tiles, S): the S blocks of a column tile form one
// thread-block cluster and split K into S slices. In a block, kLanes lanes
// cover one 128-byte line of a W row (kCols = 64 bf16 or 128 int8
// columns), so every load takes whole lines; each thread keeps a [MAXB x
// 8] fp32 accumulator, streaming its rows kBatch at a time with the next
// batch in flight. The block folds its warps through shared memory into a
// [B x kCols] partial; after a cluster barrier each block sums its share
// of the outputs over the S partials (distributed shared memory, fixed
// order, so the result does not depend on timing) and applies the
// epilogue. PAIR (the SwiGLU gate/up launch): grid (N / kCols, 2S), the
// cluster's first S blocks stream W (gate, scales), the last S W2 (up,
// scales2).
//
// Shared memory: red [kWarps][MAXB][kCols] f32, part [MAXB][kCols] f32, ut
// [kslice][MAXB] bf16 (u transposed: one 16-byte load gives a row's B
// values) and, for a norm prologue, the whole input rows [B][K] and
// the slice of ln_w (and ln_b for LayerNorm).
template <int MAXB, int PRO, int EPI, bool PAIR, typename TW>
__global__ void __launch_bounds__(kThreads, MAXB <= 8 ? 2 : 1)
    stacked_matvec_kernel(const void* __restrict__ xin,
                          const float* __restrict__ ln_w,
                          const float* __restrict__ ln_b,
                          const TW* __restrict__ W,
                          const float* __restrict__ scales,
                          const TW* __restrict__ W2,
                          const float* __restrict__ scales2,
                          const float* __restrict__ bias,
                          const int* __restrict__ layer_ptr,
                          const bf16* __restrict__ resid,
                          bf16* __restrict__ out, float* __restrict__ out_f32,
                          int B, int K, int N, int kslice, float eps) {
  using G = WGeom<TW>;
  constexpr int kCols = G::kCols, kLanesPerRow = G::kLanes;
  constexpr int kRowGroups = G::kRowGroups;
  // the same bytes in flight a thread for either weight type
  constexpr int kBatch = (MAXB <= 8 ? 4 : 2) * (sizeof(TW) == 2 ? 1 : 2);
  constexpr int kOut = (MAXB * kCols + kThreads - 1) / kThreads;
  constexpr bool kResid = EPI == EPI_RESID_X1 || EPI == EPI_RESID;
  constexpr bool kNorm = PRO != PRO_COPY;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nblk = (int)cluster.num_blocks();
  const int nsplit = PAIR ? nblk / 2 : nblk;     // blocks a matrix
  const bool up = PAIR && rank >= nsplit;        // this block streams W2
  const int krank = up ? rank - nsplit : rank;
  const int k_lo = krank * kslice, k_hi = min(K, k_lo + kslice);
  const int klen = max(k_hi - k_lo, 0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [kWarps][MAXB][kCols]
  float* part = red + kWarps * MAXB * kCols;         // [MAXB][kCols]
  bf16* ut = reinterpret_cast<bf16*>(part + MAXB * kCols);  // [kslice][MAXB]
  unsigned char* xs = reinterpret_cast<unsigned char*>(ut + kslice * MAXB);
  float* lnw = reinterpret_cast<float*>(xs + (size_t)B * K * in_bytes<PRO>());
  float* lnb = lnw + kslice;
  const int l = layer_ptr ? *layer_ptr : 0;
  const float s = scales[l];
  const float s2 = PAIR ? scales2[l] : 0.f;

  // this block's share of the tile's B x 64 outputs, and their epilogue
  // operands, requested now so they arrive during the weight stream
  const int n_out = B * kCols, per = (n_out + nblk - 1) / nblk;
  const int o_lo = rank * per, o_hi = min(n_out, o_lo + per);
  float pre_b[kOut], pre_r[kOut];
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const int i = o_lo + threadIdx.x + t * kThreads;
    const int b = i / kCols, n = blockIdx.x * kCols + i % kCols;
    const bool ok = i < o_hi && n < N;
    pre_b[t] = ok && bias != nullptr ? bias[(size_t)l * N + n] : 0.f;
    pre_r[t] = ok && kResid ? __bfloat162float(resid[(size_t)b * N + n])
                            : 0.f;
  }

  if (!kNorm) {
    // the slice of the input rows, transposed into ut
    const bf16* x = reinterpret_cast<const bf16*>(xin);
    const int vpr = klen / 8, nv = B * vpr;
    for (int base = threadIdx.x; base < nv; base += kStageBatch * kThreads) {
      uint4 r[kStageBatch];
#pragma unroll
      for (int j = 0; j < kStageBatch; ++j) {
        const int i = base + j * kThreads;
        if (i < nv)
          r[j] = __ldg(reinterpret_cast<const uint4*>(
              x + (size_t)(i / vpr) * K + k_lo + (i % vpr) * 8));
      }
#pragma unroll
      for (int j = 0; j < kStageBatch; ++j) {
        const int i = base + j * kThreads;
        if (i < nv) {
          const int b = i / vpr, kk = (i % vpr) * 8;
          const uint32_t wd[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
#pragma unroll
          for (int c = 0; c < 8; ++c)
            ut[(kk + c) * MAXB + b] = __ushort_as_bfloat16(
                (unsigned short)(wd[c >> 1] >> (16 * (c & 1))));
        }
      }
    }
  } else {
    const bool rms = PRO == PRO_RMS_BF16;
    stage_rows(reinterpret_cast<uint4*>(xs),
               reinterpret_cast<const uint4*>(xin),
               B * K * in_bytes<PRO>() / 16, reinterpret_cast<uint4*>(lnw),
               reinterpret_cast<const uint4*>(ln_w + (size_t)l * K + k_lo),
               klen / 4, reinterpret_cast<uint4*>(lnb),
               reinterpret_cast<const uint4*>(
                   rms ? ln_w : ln_b + (size_t)l * K + k_lo),
               rms ? 0 : klen / 4);
    __syncthreads();
    if (PRO == PRO_RMS_BF16)
      rms_norm_slice<MAXB>(reinterpret_cast<const bf16*>(xs), lnw, ut, B, K,
                           k_lo, klen, eps);
    else if (PRO == PRO_LN_BF16)
      layer_norm_slice<MAXB>(reinterpret_cast<const bf16*>(xs), lnw, lnb, ut,
                             B, K, k_lo, klen, eps);
    else
      layer_norm_slice<MAXB>(reinterpret_cast<const float*>(xs), lnw, lnb,
                             ut, B, K, k_lo, klen, eps);
  }
  __syncthreads();

  const int cgi = threadIdx.x % kLanesPerRow, rg = threadIdx.x / kLanesPerRow;
  const int n0 = blockIdx.x * kCols + cgi * 8;
  float acc[MAXB][8];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[b][c] = 0.f;

  if (n0 < N) {
    const TW* Wl = (up ? W2 : W) + (size_t)l * K * N + n0;
    constexpr int kStep = kBatch * kRowGroups;
    typename G::Vec cur[kBatch], nxt[kBatch];
    load_w_rows<kBatch, TW>(cur, Wl, N, k_lo + rg, k_hi);
    for (int k0 = k_lo + rg; k0 < k_hi; k0 += kStep) {
      if (k0 + kStep < k_hi)
        load_w_rows<kBatch, TW>(nxt, Wl, N, k0 + kStep, k_hi);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k0 + j * kRowGroups;
        if (k < k_hi) {
          float w[8], ub[MAXB];
          unpack8(cur[j], w);
#pragma unroll
          for (int b0 = 0; b0 < MAXB; b0 += 8)
            load8(ut + (k - k_lo) * MAXB + b0, ub + b0);
#pragma unroll
          for (int b = 0; b < MAXB; ++b) {
            if (b < B) {
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[b][c] = fmaf(ub[b], w[c], acc[b][c]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) cur[j] = nxt[j];
    }
  }

  // lanes that share cgi differ in the bits >= log2(kLanesPerRow)
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[b][c];
#pragma unroll
      for (int o = kLanesPerRow; o < 32; o <<= 1)
        v += __shfl_xor_sync(kFull, v, o);
      acc[b][c] = v;
    }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          red[(warp * MAXB + b) * kCols + lane * 8 + c] = acc[b][c];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * MAXB * kCols + i];
    part[i] = a;
  }
  cluster.sync();  // every block's partial is visible to the cluster

#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const int i = o_lo + threadIdx.x + t * kThreads;
    const int b = i / kCols, n = blockIdx.x * kCols + i % kCols;
    if (i >= o_hi || n >= N) continue;
    float a = 0.f;
    for (int q = 0; q < nsplit; ++q) a += cluster.map_shared_rank(part, q)[i];
    const float bn = pre_b[t];
    const size_t o = (size_t)b * N + n;
    if (EPI == EPI_BIAS) {
      out[o] = __float2bfloat16(a * s + bn);
    } else if (EPI == EPI_RESID_X1) {
      const float x1 = pre_r[t] + (a * s + bn);
      out_f32[o] = x1;
      out[o] = __float2bfloat16(x1);
    } else if (EPI == EPI_GELU) {
      out[o] = __float2bfloat16(gelu_tanh(a * s + bn));
    } else if (EPI == EPI_GELU_ERF) {
      out[o] = __float2bfloat16(gelu_erf(a * s + bn));
    } else if (EPI == EPI_SWIGLU) {
      float a2 = 0.f;
      for (int q = nsplit; q < nblk; ++q)
        a2 += cluster.map_shared_rank(part, q)[i];
      out[o] = __float2bfloat16(silu_f32(a * s) * (a2 * s2));
    } else {
      out[o] = __float2bfloat16((pre_r[t] + a * s) + bn);
    }
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// Splits K over a cluster of S blocks: the smallest power of two that puts
// at least 160 blocks on the card (H100: 132 SMs, 2 blocks each), at most
// kMaxSplit blocks a cluster; each slice a multiple of 8 rows. A paired
// launch has two matrices, so twice the blocks a split.
inline int split_for(int n_tiles, bool pair) {
  const int mats = pair ? 2 : 1;
  int S = 1;
  while (S * mats < kMaxSplit && n_tiles * S * mats < 160) S *= 2;
  return S;
}

template <int MAXB, int PRO, typename TW>
size_t matvec_smem(int B, int K, int kslice) {
  const size_t rows = (size_t)B * K * in_bytes<PRO>();
  return (size_t)(kWarps + 1) * MAXB * WGeom<TW>::kCols * sizeof(float) +
         (size_t)kslice * MAXB * sizeof(bf16) +
         (PRO == PRO_COPY       ? 0
          : PRO == PRO_RMS_BF16 ? rows + (size_t)kslice * sizeof(float)
                                : rows + 2 * (size_t)kslice * sizeof(float));
}

template <int MAXB, int PRO, int EPI, bool PAIR, typename TW>
cudaError_t launch_matvec(const void* xin, const float* ln_w,
                          const float* ln_b, const TW* W,
                          const float* scales, const TW* W2,
                          const float* scales2, const float* bias,
                          const int* layer_ptr, const bf16* resid,
                          bf16* out, float* out_f32,
                          int B, int K, int N, float eps, cudaStream_t st) {
  auto kern = stacked_matvec_kernel<MAXB, PRO, EPI, PAIR, TW>;
  const int n_tiles = (N + WGeom<TW>::kCols - 1) / WGeom<TW>::kCols;
  const int S = split_for(n_tiles, PAIR);
  const int kslice = ((K + S - 1) / S + 7) / 8 * 8;
  const size_t smem = matvec_smem<MAXB, PRO, TW>(B, K, kslice);
  // raise the kernel's dynamic shared-memory limit once per size, so a
  // launch inside CUDA-graph capture makes no attribute call
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const int cluster = S * (PAIR ? 2 : 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, cluster, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, xin, ln_w, ln_b, W, scales, W2,
                            scales2, bias, layer_ptr, resid, out, out_f32, B,
                            K, N, kslice, eps);
}

template <int PRO, int EPI, bool PAIR = false, typename TW = bf16>
cudaError_t matvec(const void* xin, const float* ln_w, const float* ln_b,
                   const TW* W, const float* scales, const float* bias,
                   const int* layer_ptr, const bf16* resid, bf16* out,
                   float* out_f32, int B, int K, int N, float eps,
                   cudaStream_t st, const TW* W2 = nullptr,
                   const float* scales2 = nullptr) {
  if (B <= 8)
    return launch_matvec<8, PRO, EPI, PAIR, TW>(
        xin, ln_w, ln_b, W, scales, W2, scales2, bias, layer_ptr, resid, out,
        out_f32, B, K, N, eps, st);
  return launch_matvec<16, PRO, EPI, PAIR, TW>(
      xin, ln_w, ln_b, W, scales, W2, scales2, bias, layer_ptr, resid, out,
      out_f32, B, K, N, eps, st);
}

// ------------------------------------------------------- decode attention

constexpr int kAttnWarps = 8;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kMaxRows = 8;   // R, query rows per KV head

// One group of a slot's K/V rows, as one warp holds it, for head dim D and
// a bf16 (Q8 false) or int8 (Q8 true) cache: kLanes lanes own a key,
// kKDims dims each (32 bf16 values, or 64 int8 at D 128 and 32 at D 64:
// kKLoads 16-byte loads), so a group has 32/kLanes keys; lane i has
// K[key0 + i/kLanes][kKDims*(i%kLanes) .. +kKDims) and V[key0 + j][i*D/32
// .. +D/32) for every key j of the group (kVBytes bytes: one or two 32-bit
// words, or at D 64 int8 a 16-bit half in the low bits of one) and, int8,
// the two scales of key key0 + i/kLanes.
template <bool Q8>
struct KVScales {};
template <>
struct KVScales<true> {
  float ks, vs;
};

template <int D, bool Q8>
struct KVGroup : KVScales<Q8> {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using T = typename std::conditional<Q8, int8_t, bf16>::type;
  static constexpr int kKDims = Q8 && D == 128 ? 64 : 32;
  static constexpr int kKLoads = kKDims * (int)sizeof(T) / 16;
  static constexpr int kLanes = D / kKDims;
  static constexpr int kKeys = 32 / kLanes;
  static constexpr int kVBytes = D / 32 * (int)sizeof(T);
  static constexpr int kVWords = kVBytes < 4 ? 1 : kVBytes / 4;
  uint4 k[kKLoads];
  uint32_t v[kKeys][kVWords];
};

// the group whose first key is row ``row`` of the [.., rows, D] cache
template <int D, bool Q8>
__device__ __forceinline__ void load_group(
    KVGroup<D, Q8>& g, const typename KVGroup<D, Q8>::T* __restrict__ kc,
    const typename KVGroup<D, Q8>::T* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs, size_t row,
    int lane) {
  using G = KVGroup<D, Q8>;
  constexpr int kRowWords = D * (int)sizeof(typename G::T) / 4;
  const uint4* kr = reinterpret_cast<const uint4*>(
      kc + (row + lane / G::kLanes) * D + (lane % G::kLanes) * G::kKDims);
#pragma unroll
  for (int i = 0; i < G::kKLoads; ++i) g.k[i] = __ldg(kr + i);
  if constexpr (G::kVBytes == 2) {
    const unsigned short* vh =
        reinterpret_cast<const unsigned short*>(vc + row * D) + lane;
#pragma unroll
    for (int j = 0; j < G::kKeys; ++j) g.v[j][0] = __ldg(vh + j * (D / 2));
  } else {
    const uint32_t* vr =
        reinterpret_cast<const uint32_t*>(vc + row * D) + lane * G::kVWords;
#pragma unroll
    for (int j = 0; j < G::kKeys; ++j) {
      if constexpr (G::kVWords == 2) {
        const uint2 t =
            __ldg(reinterpret_cast<const uint2*>(vr + j * kRowWords));
        g.v[j][0] = t.x;
        g.v[j][1] = t.y;
      } else {
        g.v[j][0] = __ldg(vr + j * kRowWords);
      }
    }
  }
  if constexpr (Q8) {
    g.ks = __ldg(ks + row + lane / G::kLanes);
    g.vs = __ldg(vs + row + lane / G::kLanes);
  }
}

// One block per (KV head, slot). Each warp walks the slot's live keys in
// groups (g = warp, warp + 8, ...) with its own fp32 online softmax for
// the R rows, loading the next group while it computes this one; the
// block then merges the 8 partial (max, sum, acc) states.
// Addressing: row ((l*NB + blk)*H + h)*page + key % page of the cache,
// blk = pt[b][key / page] (the paged pool), or with no page table blk = b
// and page = the cache length (the layer-stacked cache [Lyr, B, H, L, D]).
// Slot b's position is pos_arr[b * pos_stride].
template <int D, bool Q8>
__global__ void __launch_bounds__(kAttnThreads) decode_attn_kernel(
    const bf16* __restrict__ q, const typename KVGroup<D, Q8>::T* __restrict__ kc,
    const typename KVGroup<D, Q8>::T* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ pos_arr, int pos_stride,
    const int* __restrict__ pt, const int* __restrict__ layer_ptr,
    bf16* __restrict__ out, int H, int R, int NB, int page, int maxp,
    int rows_per_step, float scale) {
  using G = KVGroup<D, Q8>;
  constexpr int kLanes = G::kLanes, kKeys = G::kKeys, kKDims = G::kKDims;
  constexpr int kDims = D / 32;   // P.V dims a lane owns
  __shared__ __align__(16) float qs[kMaxRows][D];
  __shared__ float part_m[kAttnWarps][kMaxRows];
  __shared__ float part_l[kAttnWarps][kMaxRows];
  __shared__ float part_acc[kAttnWarps][kMaxRows][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = pos_arr[b * pos_stride];
  const int npair = R * D;
  bf16* ob = out + (size_t)(b * H + h) * npair;

  // idle slot: zeros, and no page is touched (decode.py:959-961 — even a
  // multi-query window must not pull page 0 in)
  if (pos < 0) {
    for (int i = threadIdx.x; i < npair; i += kAttnThreads)
      ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int l = layer_ptr ? *layer_ptr : 0;
  // keys past pos + max_step are masked for every row, as are pages past
  // the table: the Pallas grid visits page p iff p*page <= pos + max_step
  const int max_step = rows_per_step > 0 ? R / rows_per_step - 1 : 0;
  const int n_keys = min(pos + max_step + 1, maxp * page);
  const int n_groups = (n_keys + kKeys - 1) / kKeys;

  const bf16* qb = q + (size_t)(b * H + h) * npair;
  for (int i = threadIdx.x; i < npair; i += kAttnThreads)
    qs[i / D][i % D] = __bfloat162float(qb[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % kLanes;
  const int* ptb = pt ? pt + (size_t)b * maxp : nullptr;
  auto group_row = [&](int g) {
    const int key0 = g * kKeys, p = key0 / page;   // page % 16 == 0
    const int blk = ptb ? ptb[p] : b;
    return ((size_t)(l * NB + blk) * H + h) * page + (key0 - p * page);
  };

  float m[kMaxRows], lsum[kMaxRows], acc[kMaxRows][kDims];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m[r] = -1e30f;
    lsum[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[r][d] = 0.f;
  }
  G cur, nxt;
  int g = warp;
  if (g < n_groups) load_group<D, Q8>(cur, kc, vc, ks, vs, group_row(g), lane);
  for (; g < n_groups; g += kAttnWarps) {
    if (g + kAttnWarps < n_groups)
      load_group<D, Q8>(nxt, kc, vc, ks, vs, group_row(g + kAttnWarps), lane);
    const int key = g * kKeys + lane / kLanes;
    // bf16: the lane's 32 dims of K as floats, each row's q.k taken in
    // the row loop; int8: 64 or 32 dims, so each row's partial q.k is
    // taken here, 16 dims a load, to keep the converted K out of registers
    float kf[Q8 ? 1 : kKDims], dq[Q8 ? kMaxRows : 1];
    if constexpr (Q8) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) dq[r] = 0.f;
#pragma unroll
      for (int i = 0; i < G::kKLoads; ++i) {
        float kc[16];
        unpack4_i8(cur.k[i].x, kc);
        unpack4_i8(cur.k[i].y, kc + 4);
        unpack4_i8(cur.k[i].z, kc + 8);
        unpack4_i8(cur.k[i].w, kc + 12);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < R) {
            const float4* qr = reinterpret_cast<const float4*>(
                &qs[r][sub * kKDims + i * 16]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 qv = qr[c];
              dq[r] = fmaf(qv.x, kc[4 * c], dq[r]);
              dq[r] = fmaf(qv.y, kc[4 * c + 1], dq[r]);
              dq[r] = fmaf(qv.z, kc[4 * c + 2], dq[r]);
              dq[r] = fmaf(qv.w, kc[4 * c + 3], dq[r]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack8(cur.k[i], kf + 8 * i);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < R) {
        float d = 0.f;
        if constexpr (Q8) {
          d = dq[r];
        } else {
          const float4* qr =
              reinterpret_cast<const float4*>(&qs[r][sub * kKDims]);
#pragma unroll
          for (int i = 0; i < kKDims / 4; ++i) {
            const float4 qv = qr[i];
            d = fmaf(qv.x, kf[4 * i], d);
            d = fmaf(qv.y, kf[4 * i + 1], d);
            d = fmaf(qv.z, kf[4 * i + 2], d);
            d = fmaf(qv.w, kf[4 * i + 3], d);
          }
        }
#pragma unroll
        for (int o = 1; o < kLanes; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
        const int lim = pos + (rows_per_step > 0 ? r / rows_per_step : 0);
        const bool valid = key <= lim;
        float s = d * scale;
        if constexpr (Q8) s = s * cur.ks;
        float gmax = valid ? s : -1e30f;
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, o));
        const float m_new = fmaxf(m[r], gmax);
        const float alpha = __expf(m[r] - m_new);
        const float p = valid ? __expf(s - m_new) : 0.f;
        lsum[r] = lsum[r] * alpha + warp_sum(sub ? 0.f : p);
        // p (times the key's V scale) is rounded to bf16 before the V
        // product and summed unrounded, as in the Pallas kernel
        float pv = p;
        if constexpr (Q8) pv = valid ? p * cur.vs : 0.f;
        const float pr = __bfloat162float(__float2bfloat16(pv));
        float a[kDims];
#pragma unroll
        for (int e = 0; e < kDims; ++e) a[e] = acc[r][e] * alpha;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const float pj = __shfl_sync(kFull, pr, j * kLanes);
          float vf[kDims];
          if constexpr (Q8) {
            float w4[4];
            unpack4_i8(cur.v[j][0], w4);
#pragma unroll
            for (int e = 0; e < kDims; ++e) vf[e] = w4[e];
          } else {
#pragma unroll
            for (int w = 0; w < G::kVWords; ++w) {
              vf[2 * w] = __uint_as_float(cur.v[j][w] << 16);
              vf[2 * w + 1] = __uint_as_float(cur.v[j][w] & 0xffff0000u);
            }
          }
#pragma unroll
          for (int e = 0; e < kDims; ++e) a[e] = fmaf(pj, vf[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[r][e] = a[e];
        m[r] = m_new;
      }
    }
    cur = nxt;
  }

  // merge the warps' states; a warp that saw no key holds m = -1e30 and
  // weighs exp(-1e30 - M) = 0 (key 0 is valid for every row, so M is real)
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < R) {
      if (lane == 0) {
        part_m[warp][r] = m[r];
        part_l[warp][r] = lsum[r];
      }
#pragma unroll
      for (int e = 0; e < kDims; ++e)
        part_acc[warp][r][kDims * lane + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npair; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    float M = -1e30f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) M = fmaxf(M, part_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) {
      const float f = __expf(part_m[w][r] - M);
      L = fmaf(f, part_l[w][r], L);
      A = fmaf(f, part_acc[w][r][d], A);
    }
    ob[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

template <int D, bool Q8>
cudaError_t launch_attn(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* pos,
                        int pos_stride, const void* pt, const void* layer_ptr,
                        void* out, int B, int H, int R, int NB, int page,
                        int maxp, int rows_per_step, float scale,
                        cudaStream_t st) {
  using T = typename KVGroup<D, Q8>::T;
  decode_attn_kernel<D, Q8><<<dim3(H, B), kAttnThreads, 0, st>>>(
      (const bf16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)pos, pos_stride, (const int*)pt,
      (const int*)layer_ptr, (bf16*)out, H, R, NB, page, maxp,
      rows_per_step, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- kv_quant_int8

// One warp per row t of the 2*B*H new K and V rows (K rows first); lane i
// holds the C = D/32 values from i*C. The codes go to row ((l*NB + blk)*H
// + h)*L + row of the [.., L, D] destination, the scale to the same index
// of the [.., 1, L] scales; null layer, blocks or rows read as 0, b and 0.
template <int C>
__global__ void __launch_bounds__(256) kv_quant_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v, int k_stride,
    int v_stride, int8_t* __restrict__ kq, float* __restrict__ ks,
    int8_t* __restrict__ vq, float* __restrict__ vs,
    const int* __restrict__ layer_ptr, const int* __restrict__ blocks,
    const int* __restrict__ rows, int rows_stride, int B, int H, int NB,
    int L) {
  constexpr int D = 32 * C;
  const int t = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (t >= 2 * B * H) return;
  const bool is_v = t >= B * H;
  const int bh = is_v ? t - B * H : t, b = bh / H, h = bh % H;
  const bf16* src = (is_v ? v + (size_t)b * v_stride : k + (size_t)b * k_stride)
                    + (size_t)h * D + lane * C;
  float x[C], amax = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = __bfloat162float(src[c]);
    amax = fmaxf(amax, fabsf(x[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  // XLA compiles amax / 127.0 as amax * fl(1/127); the codes take an IEEE
  // division, rounded half to even as jnp.round(t / sc)
  const float sc = fmaxf(amax * (1.f / 127.f), 1e-12f);
  const int l = layer_ptr ? *layer_ptr : 0;
  const int blk = blocks ? blocks[b] : b;
  const int row = rows ? rows[b * rows_stride] : 0;
  const size_t srow = ((size_t)(l * NB + blk) * H + h) * L + row;
  int8_t* dst = (is_v ? vq : kq) + srow * D + lane * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    dst[c] = (int8_t)(int)fminf(fmaxf(rintf(x[c] / sc), -127.f), 127.f);
  if (lane == 0) (is_v ? vs : ks)[srow] = sc;
}

// GPT-2's out_ffn (fuse_proj, LayerNorm, gelu_tanh): three launches
template <typename TW>
cudaError_t out_ffn_gelu(const void* ctx, const void* x, const TW* wp,
                         const float* sp, const float* bp, const float* ln_w,
                         const float* ln_b, const TW* w1, const float* s1,
                         const float* b1, const TW* w2, const float* s2,
                         const float* b2, const int* lp, bf16* x1, float* x1f,
                         bf16* h, bf16* out, int B, int E, int F, float eps,
                         cudaStream_t st) {
  cudaError_t e = matvec<PRO_COPY, EPI_RESID_X1, false, TW>(
      ctx, nullptr, nullptr, wp, sp, bp, lp, (const bf16*)x, x1, x1f, B, E,
      E, eps, st);
  if (e != cudaSuccess) return e;
  e = matvec<PRO_LN_F32, EPI_GELU, false, TW>(
      x1f, ln_w, ln_b, w1, s1, b1, lp, nullptr, h, nullptr, B, E, F, eps,
      st);
  if (e != cudaSuccess) return e;
  return matvec<PRO_COPY, EPI_RESID, false, TW>(
      h, nullptr, nullptr, w2, s2, b2, lp, x1, out, nullptr, B, F, E, eps,
      st);
}

template <typename TW>
cudaError_t out_ffn_glu(const void* x1, const float* ln_w, const TW* wg,
                        const float* sg, const TW* wu, const float* su,
                        const TW* wd, const float* sd, const int* lp, bf16* h,
                        bf16* out, int B, int E, int F, float eps,
                        cudaStream_t st) {
  cudaError_t e = matvec<PRO_RMS_BF16, EPI_SWIGLU, true, TW>(
      x1, ln_w, nullptr, wg, sg, nullptr, lp, nullptr, h, nullptr, B, E, F,
      eps, st, wu, su);
  if (e != cudaSuccess) return e;
  return matvec<PRO_COPY, EPI_RESID, false, TW>(
      h, nullptr, nullptr, wd, sd, nullptr, lp, (const bf16*)x1, out,
      nullptr, B, F, E, eps, st);
}

}  // namespace

extern "C" {

// out [B, N] = norm(x) . W[layer] * s[layer] (+ b[layer]); rms != 0 takes
// RMSNorm (ln_w only, no bias: pass null ln_b and b); w8 != 0: W holds
// int8 codes. A null layer_ptr reads layer 0 (ln_qkv_int8).
int dstpu_ln_qkv_stacked(const void* x, const void* ln_w, const void* ln_b,
                         const void* w, const void* s, const void* b,
                         const void* layer_ptr, void* out,
                         int B, int E, int N, int rms, int w8, float eps,
                         void* stream) {
  if (rms && w8)
    return (int)matvec<PRO_RMS_BF16, EPI_BIAS, false, int8_t>(
        x, (const float*)ln_w, nullptr, (const int8_t*)w, (const float*)s,
        nullptr, (const int*)layer_ptr, nullptr, (bf16*)out, nullptr, B, E,
        N, eps, (cudaStream_t)stream);
  if (w8)
    return (int)matvec<PRO_LN_BF16, EPI_BIAS, false, int8_t>(
        x, (const float*)ln_w, (const float*)ln_b, (const int8_t*)w,
        (const float*)s, (const float*)b, (const int*)layer_ptr, nullptr,
        (bf16*)out, nullptr, B, E, N, eps, (cudaStream_t)stream);
  if (rms)
    return (int)matvec<PRO_RMS_BF16, EPI_BIAS>(
        x, (const float*)ln_w, nullptr, (const bf16*)w, (const float*)s,
        nullptr, (const int*)layer_ptr, nullptr, (bf16*)out, nullptr, B, E,
        N, eps, (cudaStream_t)stream);
  return (int)matvec<PRO_LN_BF16, EPI_BIAS>(
      x, (const float*)ln_w, (const float*)ln_b, (const bf16*)w,
      (const float*)s, (const float*)b, (const int*)layer_ptr, nullptr,
      (bf16*)out, nullptr, B, E, N, eps, (cudaStream_t)stream);
}

// out [B, N] = x . W[layer] * s[layer]; w8 != 0: W holds int8 codes
int dstpu_matvec_stacked(const void* x, const void* w, const void* s,
                         const void* layer_ptr, void* out, int B, int K,
                         int N, int w8, void* stream) {
  if (w8)
    return (int)matvec<PRO_COPY, EPI_BIAS, false, int8_t>(
        x, nullptr, nullptr, (const int8_t*)w, (const float*)s, nullptr,
        (const int*)layer_ptr, nullptr, (bf16*)out, nullptr, B, K, N, 0.f,
        (cudaStream_t)stream);
  return (int)matvec<PRO_COPY, EPI_BIAS>(
      x, nullptr, nullptr, (const bf16*)w, (const float*)s, nullptr,
      (const int*)layer_ptr, nullptr, (bf16*)out, nullptr, B, K, N, 0.f,
      (cudaStream_t)stream);
}

// Three launches on one stream: x1 (bf16 + fp32 copies), h, then out;
// w8 != 0: Wp, W1 and W2 hold int8 codes. A null layer_ptr reads layer 0
// (out_ffn_int8).
int dstpu_out_ffn_stacked(const void* ctx, const void* x, const void* wp,
                          const void* sp, const void* bp, const void* ln_w,
                          const void* ln_b, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, const void* layer_ptr,
                          void* x1, void* x1f, void* h,
                          void* out, int B, int E, int F, int w8, float eps,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lp = (const int*)layer_ptr;
  if (w8)
    return (int)out_ffn_gelu<int8_t>(
        ctx, x, (const int8_t*)wp, (const float*)sp, (const float*)bp,
        (const float*)ln_w, (const float*)ln_b, (const int8_t*)w1,
        (const float*)s1, (const float*)b1, (const int8_t*)w2,
        (const float*)s2, (const float*)b2, lp, (bf16*)x1, (float*)x1f,
        (bf16*)h, (bf16*)out, B, E, F, eps, st);
  return (int)out_ffn_gelu<bf16>(
      ctx, x, (const bf16*)wp, (const float*)sp, (const float*)bp,
      (const float*)ln_w, (const float*)ln_b, (const bf16*)w1,
      (const float*)s1, (const float*)b1, (const bf16*)w2, (const float*)s2,
      (const float*)b2, lp, (bf16*)x1, (float*)x1f, (bf16*)h, (bf16*)out, B,
      E, F, eps, st);
}

// out [B, N] = act(x . W * s + b) over int8 codes W [K, N] and one fp32
// scale s on the card (matvec_int8); act 0: none, 1: gelu_tanh, 2: gelu
int dstpu_matvec_int8(const void* x, const void* w, const void* s,
                      const void* b, void* out, int B, int K, int N, int act,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  if (act == 1)
    return (int)matvec<PRO_COPY, EPI_GELU, false, int8_t>(
        x, nullptr, nullptr, wq, (const float*)s, (const float*)b, nullptr,
        nullptr, (bf16*)out, nullptr, B, K, N, 0.f, st);
  if (act == 2)
    return (int)matvec<PRO_COPY, EPI_GELU_ERF, false, int8_t>(
        x, nullptr, nullptr, wq, (const float*)s, (const float*)b, nullptr,
        nullptr, (bf16*)out, nullptr, B, K, N, 0.f, st);
  return (int)matvec<PRO_COPY, EPI_BIAS, false, int8_t>(
      x, nullptr, nullptr, wq, (const float*)s, (const float*)b, nullptr,
      nullptr, (bf16*)out, nullptr, B, K, N, 0.f, st);
}

// LLaMA's out_ffn with fuse_proj=False, two launches on one stream:
// h = silu(RMS(x1).Wg.sg) * (RMS(x1).Wu.su), then out = x1 + h.Wd.sd;
// w8 != 0: Wg, Wu and Wd hold int8 codes
int dstpu_out_ffn_glu_stacked(const void* x1, const void* ln_w,
                              const void* wg, const void* sg,
                              const void* wu, const void* su,
                              const void* wd, const void* sd,
                              const void* layer_ptr, void* h, void* out,
                              int B, int E, int F, int w8, float eps,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lp = (const int*)layer_ptr;
  if (w8)
    return (int)out_ffn_glu<int8_t>(x1, (const float*)ln_w,
                                    (const int8_t*)wg, (const float*)sg,
                                    (const int8_t*)wu, (const float*)su,
                                    (const int8_t*)wd, (const float*)sd, lp,
                                    (bf16*)h, (bf16*)out, B, E, F, eps, st);
  return (int)out_ffn_glu<bf16>(x1, (const float*)ln_w, (const bf16*)wg,
                                (const float*)sg, (const bf16*)wu,
                                (const float*)su, (const bf16*)wd,
                                (const float*)sd, lp, (bf16*)h, (bf16*)out, B,
                                E, F, eps, st);
}

// q [B, H, R, D] bf16 over a bf16 cache or an int8 one with fp32 scales
// [.., 1, page], D 64 or 128; R <= 8, page % 16 == 0. With a page table
// [B, maxp] the cache is the pool [Lyr, NB, H, page, D]; without, the
// stacked cache [Lyr, B, H, page, D] (maxp 1, NB = B; a null layer_ptr
// reads layer 0: decode_attention_int8's [B, H, L, D] cache). The wrapper
// checks the geometry.
int dstpu_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* pos, const void* page_table,
                           const void* layer_ptr, void* out, int B, int H,
                           int R, int D, int NB, int page, int maxp,
                           int rows_per_step, int pos_stride, float scale,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool q8 = k_scale != nullptr;
  if (D == 64 && !q8)
    return (int)launch_attn<64, false>(q, k, v, k_scale, v_scale, pos,
                                       pos_stride, page_table, layer_ptr, out,
                                       B, H, R, NB, page, maxp, rows_per_step,
                                       scale, st);
  if (D == 128 && !q8)
    return (int)launch_attn<128, false>(q, k, v, k_scale, v_scale, pos,
                                        pos_stride, page_table, layer_ptr,
                                        out, B, H, R, NB, page, maxp,
                                        rows_per_step, scale, st);
  if (D == 64 && q8)
    return (int)launch_attn<64, true>(q, k, v, k_scale, v_scale, pos,
                                      pos_stride, page_table, layer_ptr, out,
                                      B, H, R, NB, page, maxp, rows_per_step,
                                      scale, st);
  if (D == 128 && q8)
    return (int)launch_attn<128, true>(q, k, v, k_scale, v_scale, pos,
                                       pos_stride, page_table, layer_ptr, out,
                                       B, H, R, NB, page, maxp, rows_per_step,
                                       scale, st);
  return (int)cudaErrorInvalidValue;
}

// int8 codes and fp32 scales of the new rows k [B, H, D] (row stride
// k_stride elements) and v: into [NB, H, L, D] / [NB, H, 1, L] at layer
// *layer_ptr, block blocks[b] (null: b) and row rows[b * rows_stride]
// (null: 0). D 64 or 128.
int dstpu_kv_quant_int8(const void* k, const void* v, void* kq, void* ks,
                        void* vq, void* vs, const void* layer_ptr,
                        const void* blocks, const void* rows, int B, int H,
                        int D, int k_stride, int v_stride, int NB, int L,
                        int rows_stride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = (2 * B * H + 7) / 8;
  if (D == 64)
    kv_quant_kernel<2><<<n_blocks, 256, 0, st>>>(
        (const bf16*)k, (const bf16*)v, k_stride, v_stride, (int8_t*)kq,
        (float*)ks, (int8_t*)vq, (float*)vs, (const int*)layer_ptr,
        (const int*)blocks, (const int*)rows, rows_stride, B, H, NB, L);
  else if (D == 128)
    kv_quant_kernel<4><<<n_blocks, 256, 0, st>>>(
        (const bf16*)k, (const bf16*)v, k_stride, v_stride, (int8_t*)kq,
        (float*)ks, (int8_t*)vq, (float*)vs, (const int*)layer_ptr,
        (const int*)blocks, (const int*)rows, rows_stride, B, H, NB, L);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
