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
// - Every projection (ln_qkv, the out_ffn launches, matvec_stacked,
//   matvec_int8) is one kernel body, proj_tma_kernel, over a prologue
//   (PRO_*) and an epilogue (EPI_*). Its operands are swapped, y^T [64
//   columns, slots] = W^T u^T, so the products are wgmma m64n8k16
//   (m64n16k16 for 9-16 slots) on the tensor cores: A is W's [64 k][64 n]
//   box as stored (MN-major), B the slots' [NB][64 k] box of u (K-major;
//   slots past B are zeros). A producer warp streams the W boxes by TMA
//   from a 3-D map [L, K, N] at the layer read on the device into a ring
//   of stages, starting as soon as the ring's barriers exist (W does not
//   depend on u); two consumer warpgroups take the stages in turn. int8
//   codes come as [64 k][128 n] boxes, half the bytes, which the
//   consumers widen exactly into a swizzled bf16 stage (sm_90 has no
//   8-bit transposing ldmatrix); the sum is multiplied by s[layer], as
//   the Pallas kernels do (w.astype(bf16), a bf16 dot, then * s). (The
//   CUDA-core loop it replaced spent 8 fp32 FMAs and an unpack on every
//   weight at 8 slots, about 40 % (bf16) and 80 % (int8) of the card's fp32
//   issue at the byte rate, and kept its stream in registers; it remains
//   only as matvec_stacked_fma, for int8 rows TMA cannot describe.)
// - The TPU kernels carry state across a sequential grid in VMEM scratch
//   (the norm once at grid step 0, an fp32 accumulator revisited by every
//   F tile). CUDA blocks run in no order, so a block owns a column tile
//   and a slice of K outright, and the blocks that share a tile form a
//   thread-block cluster that sums their partials through distributed
//   shared memory in a fixed order (no atomics: a rerun is bit-equal).
//   As many clusters as two blocks an SM hold walk the column tiles
//   (persistent): the producer streams the next tile's W while the
//   consumers finish a tile's partials, so a tile's cluster barriers and
//   epilogue hide under the stream. The cluster barriers are split into
//   arrive and wait; the producer arrives a tile late and never waits on
//   the consumers of the tile it streams. The split, ring depth (even: a
//   slot then always serves one of the two consumer warpgroups) and the
//   cluster count are chosen on the host from the shapes and the SM count
//   (never from a device scalar, so a layer loop replays as a CUDA graph;
//   ops/cuda/decode.py matvec_tma_plan).
// - A norm prologue (LayerNorm or RMSNorm) stages no input row: each
//   row's statistic is computed by one warp straight from global memory
//   (L2 after the first block), in the replaced prologue's two-pass order and
//   arithmetic, by one block of the cluster for its share of the rows
//   and read by the others over distributed shared memory; then the
//   consumers write the block's K slice of u, rounded to bf16 as the
//   Pallas kernels round it, into the swizzled B boxes while the W ring
//   fills. A copy prologue loads its x (or h) boxes by TMA with each
//   stage. So 16 LLaMA-7B slots fit: the slice of u is NB x kslice x 2 B.
// - out_ffn needs the whole x1 row before its norm and the whole F row
//   before W2, so it is three launches (GPT-2): (a) x1 = x + ctx.Wp.sp +
//   bp, (b) h = gelu_tanh(LN(x1).W1.s1 + b1), (c) y = x1 + h.W2.s2 + b2;
//   or two (LLaMA, fuse_proj=False, x arrives as the bf16 x1): (b) h =
//   silu(RMS(x1).Wg.sg) * (RMS(x1).Wu.su), the gate and up tiles of a
//   column tile streamed by one cluster, (c) y = x1 + h.Wd.sd. Rounding
//   points follow the Pallas kernel: x1, u and h are rounded to bf16,
//   every product accumulates in fp32; the epilogue's bias and residual
//   are requested before the weight stream.
// - What chose it (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6): at
//   LLaMA-7B's 8 slots the CUDA-core loop took 106 / 96 us (ln_qkv
//   bf16 / int8) and 249 / 263 (out_ffn); this template 56 / 51 and
//   128 / 104. Non-persistent blocks paid ~20 us of fixed time in three
//   waves; bf16 gate/up streams both boxes a block (126 against 134 us
//   split over the cluster), int8 splits the cluster (both boxes and
//   their widened copies fit one block an SM: 134 against 102). What
//   bounds it now: the W stream at 1.4-2.3 TB/s (a box is 64 rows of 128
//   bytes, 12-24 KB apart) over a floor of handshakes and barriers.
// - Decode attention (paged pool, layer-stacked cache, one layer's int8
//   cache) is a stream of the live K/V rows: 4 flops a byte at R = 1, so
//   it is bound by bytes, and by how many are in flight. One block a
//   (KV head, slot) put 20 blocks on the 132 SMs at GPT-2's b1, each
//   streaming 2035 keys alone ("flash-decoding" fixes that): the grid is
//   (KV head, slot, split), the wrapper picking the split count from B,
//   H, the capacity and the SM count (never from pos, a device scalar:
//   the loop never syncs to the host and replays as a CUDA graph) so
//   that at least ~2 blocks an SM stream. A split past pos + max_step
//   reads nothing; a slot's splits are one thread-block cluster (at most
//   8, the portable size) and merge in split order through distributed
//   shared memory, so a rerun is bit for bit the same. (A first version
//   wrote the splits' states to global memory and merged them in the
//   last block to arrive, found by a counter: at GPT-2's b1 that fence,
//   atomic and round trip cost ~4.5 us of a ~13 us call.)
//   Inside a block a producer warp fills a ring of 64-key stages by
//   1-D bulk copies (cp.async.bulk) completing on mbarriers: a 16-key
//   group lies inside one page, so its K rows, V rows and (int8) scales
//   are one contiguous copy each (a stacked slot's stage: one copy each;
//   a paged stage: one lane a group, the page table read 32 entries at a
//   time ahead of the copies). Little's law: 3.35 TB/s x ~1 us of
//   loaded latency is ~3.4 MB in flight on the card, ~25 KiB an SM; a
//   block keeps up to its whole ring in flight (bf16 D 128: 2 or, one
//   query row, 3 stages of 32 KiB, 3 or 2 blocks an SM, 192 KiB; bf16 D
//   64 and int8 D 128: 4 of ~16 KiB, 3 blocks, ~200 KiB; int8 D 64: 4 of
//   8.5 KiB), so the splits, not the ring, limit what is in flight at
//   small B*H.
//   Eight consumer warps, in sets that take the stages in turn (two sets
//   of four on 16-key groups, so that a long split has twice the groups
//   in computation that a 4-group stage gives; one set on 8-key groups),
//   take one group each a stage, each with its own fp32 online softmax.
//   GQA / multi-query rows run on the tensor cores: S^T [16 keys, 8
//   rows] = K q^T by mma.sync m16n8k16 (the R <= 8 rows padded to N 8, D
//   as K; int8 codes widened exactly to bf16 in registers and the key's
//   scale applied to the score), then O^T [D, 8] += V^T P^T
//   with P^T moved into the B layout by movmatrix. The operands are read
//   from shared memory as 16-byte runs in an order both sides of a
//   product share (kdim_base, vdim): the bulk copies cannot pad rows, and
//   this keeps bank conflicts at 2-4 ways. p (times the V scale) is
//   rounded to bf16 before the V product and summed unrounded, and row r
//   masks keys past pos + r / rows_per_step, as in the Pallas kernels.
//   One query row a KV head (MHA: GPT-2, LLaMA-7B) wastes 7/8 of the
//   mma's N, so it takes the CUDA cores instead (2 or 4 lanes a key for
//   the score, a lane's D / 32 head dims for P.V), in the arithmetic and
//   order of the one-block-a-(head, slot) kernel this replaced: a slot
//   of one split gives that kernel's bits. (The tensor-core path, as
//   accurate against fp64 on random data, moved the LLaMA-7B int8
//   serve's teacher-forced tokens onto another trajectory whose largest
//   gap, 3.29 bf16 units, broke chip_smoke's 3-unit check.)
// - The int8 KV cache: the order of operations is the Pallas kernel's
//   (decode.py:964-991): s = q.k * scale * ks[row], the softmax sum takes
//   the unscaled p, P.V takes bf16(p * vs[row]).
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
//   The decode paths run it inside the attention kernel instead, as the
//   cache append (new_k / new_v): a launch a layer saved, and on a bf16
//   cache the two row copies. In the one block whose split holds the
//   write row, consumer warp 0 quantizes (or copies) the K and V rows in
//   the same arithmetic at its start, while the first stages are in
//   flight, fences the async proxy and arrives on a barrier that the
//   producer waits on before it bulk-copies the stage holding the row.
//   (The producer writing the row itself, just before that stage, put
//   the append's ~1 us chain on the last stage's path: 1.14 us more a
//   call on an H100 at LLaMA-7B's b8 int8 fast path.) The standalone
//   kernel stays for the JAX signature (codes and scales returned).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"

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

// PRO_COPY: u = x (bf16, by TMA); PRO_LN_BF16 / PRO_LN_F32: u =
// bf16(LayerNorm(x) * w + b) over bf16 / fp32 rows; PRO_RMS_BF16: u =
// bf16(x * rsqrt(mean(x^2) + eps) * w)
enum { PRO_COPY = 0, PRO_LN_BF16 = 1, PRO_LN_F32 = 2, PRO_RMS_BF16 = 3 };
// EPI_BIAS: a*s (+ b); EPI_RESID: resid + a*s (+ b); EPI_RESID_X1: the
// same, also written in fp32; EPI_GELU / EPI_GELU_ERF: gelu_tanh / gelu
// of a*s (+ b); EPI_SWIGLU (paired gate/up launches only):
// silu(a_gate*s_gate) * (a_up*s_up). A null bias adds nothing.
enum { EPI_BIAS = 0, EPI_RESID_X1 = 1, EPI_GELU = 2, EPI_RESID = 3,
       EPI_SWIGLU = 4, EPI_GELU_ERF = 5 };
// the gate/up pairing: PAIR_SPLIT, the cluster's first half streams the
// gate matrix and its second half the up matrix; PAIR_BOTH, every block
// streams both boxes of its columns and K slice, two accumulators
enum { PAIR_NONE = 0, PAIR_SPLIT = 1, PAIR_BOTH = 2 };

constexpr int kMaxSplit = 8;             // blocks a cluster (portable limit)

// ------------------------------------ matvec_stacked_fma: the CUDA cores

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

// 8 values at p (16-byte aligned) from global memory, as floats
__device__ __forceinline__ void ldg8(const bf16* p, float f[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

__device__ __forceinline__ void ldg8(const float* p, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
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

// out[b, n] = bf16(sum_k x[b, k] * W[layer, k, n] * s[layer]): the
// CUDA-core stream, kept for the int8 rows TMA cannot describe (N % 16).
//
// Grid (N / kCols column tiles, S): the S blocks of a column tile form one
// thread-block cluster and split K into S slices. In a block, kLanes lanes
// cover one 128-byte line of a W row (kCols = 64 bf16 or 128 int8
// columns), so every load takes whole lines; each thread keeps a [MAXB x
// 8] fp32 accumulator, streaming its rows kBatch at a time with the next
// batch in flight. The block folds its warps through shared memory into a
// [B x kCols] partial; after a cluster barrier each block sums its share
// of the outputs over the S partials (distributed shared memory, fixed
// order) and scales them.
//
// Shared memory: red [kWarps][MAXB][kCols] f32, part [MAXB][kCols] f32, ut
// [kslice][MAXB] bf16 (x transposed: one 16-byte load gives a row's B
// values).
template <int MAXB, typename TW>
__global__ void __launch_bounds__(kThreads, MAXB <= 8 ? 2 : 1)
    stacked_matvec_kernel(const bf16* __restrict__ x,
                          const TW* __restrict__ W,
                          const float* __restrict__ scales,
                          const int* __restrict__ layer_ptr,
                          bf16* __restrict__ out, int B, int K, int N,
                          int kslice) {
  using G = WGeom<TW>;
  constexpr int kCols = G::kCols, kLanesPerRow = G::kLanes;
  constexpr int kRowGroups = G::kRowGroups;
  constexpr int kStageBatch = 8;   // 16-byte loads in flight a thread
  // the same bytes in flight a thread for either weight type
  constexpr int kBatch = (MAXB <= 8 ? 4 : 2) * (sizeof(TW) == 2 ? 1 : 2);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nblk = (int)cluster.num_blocks();
  const int k_lo = rank * kslice, k_hi = min(K, k_lo + kslice);
  const int klen = max(k_hi - k_lo, 0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [kWarps][MAXB][kCols]
  float* part = red + kWarps * MAXB * kCols;         // [MAXB][kCols]
  bf16* ut = reinterpret_cast<bf16*>(part + MAXB * kCols);  // [kslice][MAXB]
  const int l = layer_ptr ? *layer_ptr : 0;
  const float s = scales[l];
  const int n_out = B * kCols, per = (n_out + nblk - 1) / nblk;
  const int o_lo = rank * per, o_hi = min(n_out, o_lo + per);

  // the slice of the input rows, transposed into ut
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
  __syncthreads();

  const int cgi = threadIdx.x % kLanesPerRow, rg = threadIdx.x / kLanesPerRow;
  const int n0 = blockIdx.x * kCols + cgi * 8;
  float acc[MAXB][8];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[b][c] = 0.f;

  if (n0 < N) {
    const TW* Wl = W + (size_t)l * K * N + n0;
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
            unpack8(*reinterpret_cast<const uint4*>(ut + (k - k_lo) * MAXB +
                                                    b0),
                    ub + b0);
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

  for (int i = o_lo + threadIdx.x; i < o_hi; i += kThreads) {
    const int b = i / kCols, n = blockIdx.x * kCols + i % kCols;
    if (n >= N) continue;
    float a = 0.f;
    for (int q = 0; q < nblk; ++q) a += cluster.map_shared_rank(part, q)[i];
    out[(size_t)b * N + n] = __float2bfloat16(a * s);
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// Splits K over a cluster of S blocks: the smallest power of two that puts
// at least 160 blocks on the card (H100: 132 SMs, 2 blocks each), at most
// kMaxSplit blocks a cluster; each slice a multiple of 8 rows.
inline int fma_split(int n_tiles) {
  int S = 1;
  while (S < kMaxSplit && n_tiles * S < 160) S *= 2;
  return S;
}

// shared memory of a block; ops/cuda/decode.py fma_smem mirrors it
template <int MAXB, typename TW>
size_t fma_smem(int kslice) {
  return (size_t)(kWarps + 1) * MAXB * WGeom<TW>::kCols * sizeof(float) +
         (size_t)kslice * MAXB * sizeof(bf16);
}

template <int MAXB, typename TW>
cudaError_t launch_fma(const bf16* x, const TW* W, const float* scales,
                       const int* layer_ptr, bf16* out, int B, int K, int N,
                       cudaStream_t st) {
  auto kern = stacked_matvec_kernel<MAXB, TW>;
  const int n_tiles = (N + WGeom<TW>::kCols - 1) / WGeom<TW>::kCols;
  const int S = fma_split(n_tiles);
  const int kslice = ((K + S - 1) / S + 7) / 8 * 8;
  const size_t smem = fma_smem<MAXB, TW>(kslice);
  // raise the kernel's dynamic shared-memory limit once per size, so a
  // launch inside CUDA-graph capture makes no attribute call
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, S, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, x, W, scales, layer_ptr, out, B, K,
                            N, kslice);
}

// ------------------------- the projections: TMA-fed, on the tensor cores

// y^T [column tile, slots] = W[layer]^T u^T per block: wgmma m64nNBk16 with
// A = a [64 k][64 n] box of W (MN-major, as stored) and B = the [NB slots]
// [64 k] box of u (K-major); NB is 8 (B <= 8) or 16. A block is two
// consumer warpgroups (warps 0-7), which take the stages in turn, and one
// producer warp (warp 8), whose lane 0 streams the K slice's W boxes (and
// a copy prologue's x boxes) by TMA into a ring of stages. int8 codes: a
// stage holds a [64 k][128 n] box of codes, which the consumers widen
// (exactly) into two swizzled bf16 boxes of their own before the product;
// two warpgroups keep two of these chains (load, widen, product) going a
// block. The blocks of a column tile split K as a cluster and sum their
// fp32 partials over distributed shared memory in a fixed order.
constexpr int MV_THREADS = 288;
constexpr int MV_KB = 64;            // k rows a stage
constexpr int MV_BOX = MV_KB * 128;  // one [64 k][128 bytes] box: 8 KB
constexpr int MV_BAR_U = 5;          // named barriers: u, then the partial
constexpr int MV_BAR_PART = 6;

// Shared memory of a block (ops/cuda/decode.py matvec_tma_plan mirrors
// it): 1024 of alignment slack, `stages` stages (MATS W boxes, then a copy
// prologue's x box), the slice of u (a norm prologue: NB x kslice bf16 in
// [NB][64 k] boxes), int8's two widened bf16 boxes a warpgroup, the
// block's fp32 partial [MATS][COLS][NB], two mbarriers a stage and the
// rows' statistics.
template <bool I8, int NB, int PRO, int PAIR>
struct ProjCfg {
  static constexpr int MATS = PAIR == PAIR_BOTH ? 2 : 1;  // W boxes a stage
  static constexpr bool NORM = PRO != PRO_COPY;
  static constexpr int COLS = I8 ? 128 : 64;          // columns a block
  static constexpr int PARTS = COLS / 64;             // m64 tiles of them
  static constexpr int STAGE = MATS * MV_BOX + (NORM ? 0 : NB * 128);
  static constexpr int CVT = I8 ? 2 * 2 * MV_BOX : 0;
  static constexpr int PART = MATS * COLS * NB;       // floats
  static constexpr int U_BOX = NB * 128;              // [NB][64 k] bf16
  static size_t smem(int kslice, int stages) {
    return 1024 + (size_t)stages * STAGE + (NORM ? kslice / MV_KB * U_BOX : 0)
           + CVT + PART * 4 + 16 * (size_t)stages + 8 * NB;
  }
};

struct ProjParams {
  CUtensorMap w;    // [L, K, N] bf16 or int8, boxes [64 k][128 bytes of n]
  CUtensorMap w2;   // the up matrix of a paired launch, the same boxes
  CUtensorMap x;    // [B, K] bf16, boxes [NB][64 k] (copy prologue)
  const void* xin;  // a norm prologue's rows [B, K], bf16 or fp32
  const float* ln_w;      // [L, K]
  const float* ln_b;      // [L, K] (LayerNorm)
  const float* scales;    // [L]
  const float* scales2;   // [L] (the up matrix)
  const float* bias;      // [L, N] or null
  const int* layer_ptr;   // null: layer 0
  const bf16* resid;      // [B, N] (EPI_RESID*)
  bf16* out;              // [B, N]
  float* out_f32;         // [B, N] (EPI_RESID_X1)
  int B, K, N, kslice, stages;
  float eps;
};

// 4 int8 codes -> 4 bf16 values (2 words), exactly: unpack4_i8's trick
// (byte ^ 0x80 is c + 128, 2^23 + (c + 128) - (2^23 + 128) = c) with one
// byte_perm a code, and a float that is an integer of at most 8 bits is a
// bf16 in its upper half
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  w ^= 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440 + i)) -
        8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// a warpgroup widens a stage's [64 k][128 n] codes into `cb`: two MN-major
// [64 k][64 n] bf16 boxes, both in the 128-byte swizzle
__device__ __forceinline__ void widen_stage(const unsigned char* st,
                                            unsigned char* cb) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * 128 + (threadIdx.x & 127);   // 512 16-byte chunks
    const int k = idx >> 3, c = idx & 7, sw = k & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(st + k * 128 +
                                                    ((c ^ sw) << 4));
    const uint2 a = widen4(v.x), b = widen4(v.y), d = widen4(v.z),
                e = widen4(v.w);
    unsigned char* row = cb + (c >> 2) * MV_BOX + k * 128;
    const int q = 2 * (c & 3);   // the two bf16 chunks of these 16 codes
    *reinterpret_cast<uint4*>(row + ((q ^ sw) << 4)) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((q + 1) ^ sw) << 4)) =
        make_uint4(d.x, d.y, e.x, e.y);
  }
}

// (mean, rstd) of row xr [K] by one warp, in the order and arithmetic of
// the row-staging prologue it replaced (a row's statistic keeps its
// bits): lane j sums the 8-value runs at 8j, 8j + 256, ..., then a
// butterfly. LayerNorm takes two passes as _ln (decode.py:217); RMSNorm
// (mean 0) the mean of squares as _rms (:425).
template <bool RMS, typename Tin>
__device__ __forceinline__ float2 row_stats(const Tin* __restrict__ xr, int K,
                                            float eps) {
  const int lane = threadIdx.x & 31;
  float f[8], s = 0.f;
  if (RMS) {
#pragma unroll 4
    for (int k = lane * 8; k < K; k += 256) {
      ldg8(xr + k, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i] * f[i];
    }
    return make_float2(0.f, rsqrtf(warp_sum(s) / K + eps));
  }
#pragma unroll 4
  for (int k = lane * 8; k < K; k += 256) {
    ldg8(xr + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / K;
  float v = 0.f;
#pragma unroll 4
  for (int k = lane * 8; k < K; k += 256) {
    ldg8(xr + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
  }
  return make_float2(mu, rsqrtf(warp_sum(v) / K + eps));
}

// 8 values of a row in registers as loaded (16 bytes of bf16, 32 of fp32),
// so a batch of loads in flight costs few registers
template <typename T>
struct Vec8 {
  uint4 v;
  __device__ __forceinline__ void load(const T* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float f[8]) const { unpack8(v, f); }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float f[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// The consumers (threads 0-255) write u = bf16(norm(x)) at the block's K
// slice [k_lo, k_lo + kslice) into `u`: box t = kk / 64 at u + t * NB *
// 128, row b at b * 128, its 16-byte chunk c at (c ^ b % 8) * 16 (the
// 128-byte swizzle TMA gives a copy prologue's x box); rows past B and k
// past K are zeros. stat[b] = (mean, rstd) of row b.
template <int NB, int PRO>
__device__ __forceinline__ void norm_slice(const ProjParams& p,
                                           const float2* stat,
                                           unsigned char* u, int l,
                                           int k_lo) {
  using Tin = typename std::conditional<PRO == PRO_LN_F32, float, bf16>::type;
  constexpr bool RMS = PRO == PRO_RMS_BF16;
  constexpr int kB = 2;   // chunks in flight a thread
  const int ch = p.kslice / 8, total = NB * ch;
  const Tin* x = reinterpret_cast<const Tin*>(p.xin);
  const float* w = p.ln_w + (size_t)l * p.K;
  const float* bb = RMS ? nullptr : p.ln_b + (size_t)l * p.K;
  for (int base = threadIdx.x; base < total; base += kB * kThreads) {
    Vec8<Tin> xv[kB];
    Vec8<float> gv[kB], hv[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + j * kThreads, r = i / ch;
      const int k = k_lo + (i % ch) * 8;
      if (i < total && r < p.B && k < p.K) {
        xv[j].load(x + (size_t)r * p.K + k);
        gv[j].load(w + k);
        if constexpr (!RMS) hv[j].load(bb + k);
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + j * kThreads, r = i / ch, c = i % ch;
      const int k = k_lo + c * 8;
      if (i >= total) break;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (r < p.B && k < p.K) {
        const float mu = stat[r].x, rstd = stat[r].y;
        float f[8], g[8], h[8], o[8];
        xv[j].get(f);
        gv[j].get(g);
        if constexpr (!RMS) hv[j].get(h);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if constexpr (RMS)
            o[e] = f[e] * rstd * g[e];
          else
            o[e] = (f[e] - mu) * rstd * g[e] + h[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 t2 = __floats2bfloat162_rn(o[2 * e],
                                                          o[2 * e + 1]);
          v[e] = *reinterpret_cast<const uint32_t*>(&t2);
        }
      }
      *reinterpret_cast<uint4*>(u + (c >> 3) * (NB * 128) + r * 128 +
                                (((c & 7) ^ (r & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// d = one k16 step's product of the MN-major [64 k][64 n] box at `a` (A:
// its k16 rows) and the K-major u box of descriptor db, a fresh sum
template <int NB>
__device__ __forceinline__ void mv_product(float (&d)[NB / 2],
                                           const unsigned char* a,
                                           uint64_t db) {
  sm90::wgmma_ss<NB, 1, 0>(d, sm90::wgmma_desc(a, MV_BOX, 1024), db, 0);
}

// acc += s in fp32, round to nearest, once the product that wrote s is done
template <int P, int R>
__device__ __forceinline__ void add_sums(float (&acc)[P][R],
                                         float (&s)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    sm90::fence_regs(s[p]);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[p][i] += s[p][i];
  }
}

// out [B, N] = EPI(PRO(x) [B, K] . W[layer] [K, N] * s[layer]): grid
// (clusters, S x (PAIR_SPLIT ? 2 : 1)), each block over `kslice` rows of
// K; cluster c walks the column tiles c, c + gridDim.x, ... (persistent:
// the W stream runs on across tiles while the consumers finish a tile)
template <bool I8, int NB, int PRO, int EPI, int PAIR>
__global__ void __launch_bounds__(MV_THREADS, 2)
    proj_tma_kernel(const __grid_constant__ ProjParams p) {
  using C = ProjCfg<I8, NB, PRO, PAIR>;
  constexpr int MATS = C::MATS, PARTS = C::PARTS, COLS = C::COLS;
  constexpr bool NORM = C::NORM;
  constexpr bool kResid = EPI == EPI_RESID_X1 || EPI == EPI_RESID;
  // the outputs a consumer thread finishes (a block's share of COLS x NB)
  constexpr int kOut = (COLS * NB + kThreads - 1) / kThreads;
  constexpr int KSTEPS = MV_KB / 16;                  // k16 steps a stage
  constexpr int NBUF = I8 && NB == 16 ? 1 : 2;        // step sums in flight
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nblk = (int)cluster.num_blocks();
  const int nsplit = PAIR == PAIR_SPLIT ? nblk / 2 : nblk;  // K slices
  const bool up = PAIR == PAIR_SPLIT && rank >= nsplit;     // streams w2
  const int k_lo = (up ? rank - nsplit : rank) * p.kslice;
  const int k_hi = min(p.K, k_lo + p.kslice);
  const int T = k_hi > k_lo ? (k_hi - k_lo + MV_KB - 1) / MV_KB : 0;
  const int ST = p.stages;     // even: a slot always serves one warpgroup
  const int n_tiles = (p.N + COLS - 1) / COLS;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* u = stages + (size_t)ST * C::STAGE;
  unsigned char* cvt = u + (NORM ? p.kslice / MV_KB * C::U_BOX : 0);
  float* part = reinterpret_cast<float*>(cvt + C::CVT);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + C::PART);
  uint64_t* empty = full + ST;
  float2* stat = reinterpret_cast<float2*>(empty + ST);   // [NB]
  const int l = p.layer_ptr ? *p.layer_ptr : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);    // the producer's expect_tx
      sm90::mbar_init(&empty[s], 4);   // lane 0 of each consuming warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 8) {
    // the producer: W first (it does not depend on u). The cluster
    // barriers are the statistics' (a norm prologue), then two a tile: A
    // (its partials are written) and B (they have been read; the
    // consumers arrive after reading and wait before they write the next
    // tile's). The producer takes part in each, a thread alternating
    // arrive and wait, a tile late: at the start of tile i (and after the
    // last) it arrives at B of tile i - 2 and at A of tile i - 1, whose
    // stages it has all issued; so the stream runs on across the
    // barriers
    bool pending = false;
    auto phase = [&]() {
      if (pending) sm90::cluster_wait();
      sm90::cluster_arrive();
      pending = true;
    };
    if (NORM) phase();
    int i = 0;                   // tiles issued
    const CUtensorMap* wm = up ? &p.w2 : &p.w;
    if (lane == 0) {
      sm90::tma_prefetch_map(wm);
      if (MATS == 2) sm90::tma_prefetch_map(&p.w2);
      if (!NORM) sm90::tma_prefetch_map(&p.x);
    }
    int g = 0;                   // stages issued, over the block's tiles
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      if (i >= 2) phase();       // B of tile i - 2
      if (i >= 1) phase();       // A of tile i - 1
      const int n0 = tile * COLS;
      for (int t = 0; t < T; ++t, ++g) {
        if (lane == 0) {
          const int s = g % ST, k = k_lo + t * MV_KB;
          unsigned char* st = stages + (size_t)s * C::STAGE;
          sm90::mbar_wait(&empty[s], ((g / ST) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], C::STAGE);
          sm90::tma_load_3d(st, wm, n0, k, l, &full[s]);
          if (MATS == 2)
            sm90::tma_load_3d(st + MV_BOX, &p.w2, n0, k, l, &full[s]);
          if (!NORM)
            sm90::tma_load_2d(st + MATS * MV_BOX, &p.x, k, 0, &full[s]);
        }
      }
      __syncwarp();
    }
    if (i >= 2) phase();         // B of tile i - 2
    phase();                     // A of the last tile
    phase();                     // B of the last tile
    sm90::cluster_wait();
  } else {
    const int tid = threadIdx.x;   // 0..255
    const float sl = p.scales[l];
    const float sl2 = PAIR != PAIR_NONE ? p.scales2[l] : 0.f;
    if constexpr (NORM) {
      // the statistics of rows rank, rank + nblk, ...: one warp a row
      using Tin =
          typename std::conditional<PRO == PRO_LN_F32, float, bf16>::type;
      for (int r = rank + warp * nblk; r < p.B; r += kWarps * nblk) {
        const float2 ms = row_stats<PRO == PRO_RMS_BF16>(
            reinterpret_cast<const Tin*>(p.xin) + (size_t)r * p.K, p.K,
            p.eps);
        if (lane == 0) stat[r] = ms;
      }
      sm90::cluster_arrive();
      sm90::cluster_wait();          // every row's statistic is computed
      // the other rows' statistics from the blocks that computed them
      // (slot r is read remotely only in block r % nblk)
      if (tid < p.B && tid % nblk != rank)
        stat[tid] = *cluster.map_shared_rank(stat + tid, tid % nblk);
      sm90::bar_sync(MV_BAR_U, kThreads);
      norm_slice<NB, PRO>(p, stat, u, l, k_lo);
      sm90::fence_proxy_async();     // u is read by the async proxy
      sm90::bar_sync(MV_BAR_U, kThreads);
    }

    const int cw = warp >> 2, w4 = warp & 3;   // warpgroup, its warp
    const int g4 = lane >> 2, t4 = lane & 3;
    unsigned char* cb = cvt + cw * 2 * MV_BOX;
    // this block's share of a tile's COLS x NB outputs (index n * NB + b)
    const int n_out = COLS * NB, per = (n_out + nblk - 1) / nblk;
    const int o_lo = rank * per, o_hi = min(n_out, o_lo + per);
    int g0 = 0;                  // stages taken
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, g0 += T) {
      const int n0 = tile * COLS;
      // the epilogue's operands, requested into L2 now so they arrive
      // during the weight stream, and read in the epilogue (registers are
      // the scarce resource at two blocks an SM: 96 a thread)
#pragma unroll
      for (int t = 0; t < kOut; ++t) {
        const int i = o_lo + tid + t * kThreads;
        const int b = i % NB, n = n0 + i / NB;
        if (i < o_hi && b < p.B && n < p.N) {
          if (p.bias != nullptr)
            sm90::prefetch_l2(p.bias + (size_t)l * p.N + n);
          if (kResid) sm90::prefetch_l2(p.resid + (size_t)b * p.N + n);
        }
      }
      // acc: the tile's sums; sacc: one k16 step's, a fresh sum of the
      // tensor cores, added to acc in fp32 rounded to nearest (the tensor
      // cores truncate as they accumulate: sums over a whole K slice, or
      // over a 64-row stage, put LLaMA-7B serving's teacher-forced gaps
      // past 3 units; PERF.md §6). Two sacc buffers let a step's product
      // run while the previous step's sums are added (one for int8 codes
      // at 16 slots: their registers)
      float acc[MATS][PARTS][NB / 2], sacc[NBUF][MATS][PARTS][NB / 2];
#pragma unroll
      for (int m = 0; m < MATS; ++m)
#pragma unroll
        for (int q = 0; q < PARTS; ++q)
#pragma unroll
          for (int i = 0; i < NB / 2; ++i) acc[m][q][i] = 0.f;
      // warpgroup cw takes the stages g with g % 2 == cw
      for (int t = (g0 & 1) == cw ? 0 : 1; t < T; t += 2) {
        const int g = g0 + t, s = g % ST;
        const unsigned char* st = stages + (size_t)s * C::STAGE;
        const unsigned char* xb =
            NORM ? u + (size_t)t * C::U_BOX : st + MATS * MV_BOX;
        sm90::mbar_wait(&full[s], (g / ST) & 1);
        if constexpr (I8) {
          // one box of codes at a time through the warpgroup's bf16 boxes
#pragma unroll
          for (int m = 0; m < MATS; ++m) {
            widen_stage(st + m * MV_BOX, cb);
            sm90::fence_proxy_async();
            sm90::bar_sync(1 + cw, 128);
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
              const uint64_t db = sm90::wgmma_desc(xb + kk * 32, 16, 1024);
              float(&cur)[PARTS][NB / 2] = sacc[kk % NBUF][m];
#pragma unroll
              for (int q = 0; q < PARTS; ++q) sm90::fence_regs(cur[q]);
              sm90::wgmma_fence();
#pragma unroll
              for (int q = 0; q < PARTS; ++q)
                mv_product<NB>(cur[q], cb + q * MV_BOX + kk * 2048, db);
              sm90::wgmma_commit();
              if constexpr (NBUF == 1) {
                sm90::wgmma_wait<0>();
                add_sums(acc[m], cur);
              } else if (kk > 0) {
                sm90::wgmma_wait<1>();   // the previous step's sums
                add_sums(acc[m], sacc[(kk - 1) % NBUF][m]);
              }
            }
            if constexpr (NBUF == 2) {
              sm90::wgmma_wait<0>();
              add_sums(acc[m], sacc[(KSTEPS - 1) % NBUF][m]);
            }
            // the widened boxes are rewritten next: every warp's part of
            // this product must be done (a warp's wait covers its own
            // part only); after the last box the stage is free
            if (m == MATS - 1 && lane == 0) sm90::mbar_arrive(&empty[s]);
            sm90::bar_sync(3 + cw, 128);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const uint64_t db = sm90::wgmma_desc(xb + kk * 32, 16, 1024);
            float(&cur)[MATS][PARTS][NB / 2] = sacc[kk % NBUF];
#pragma unroll
            for (int m = 0; m < MATS; ++m) sm90::fence_regs(cur[m][0]);
            sm90::wgmma_fence();
#pragma unroll
            for (int m = 0; m < MATS; ++m)
              mv_product<NB>(cur[m][0], st + m * MV_BOX + kk * 2048, db);
            sm90::wgmma_commit();
            if constexpr (NBUF == 1) {
              sm90::wgmma_wait<0>();
#pragma unroll
              for (int m = 0; m < MATS; ++m) add_sums(acc[m], cur[m]);
            } else if (kk > 0) {
              sm90::wgmma_wait<1>();     // the previous step's sums
#pragma unroll
              for (int m = 0; m < MATS; ++m)
                add_sums(acc[m], sacc[(kk - 1) % NBUF][m]);
            }
          }
          if constexpr (NBUF == 2) {
            sm90::wgmma_wait<0>();
#pragma unroll
            for (int m = 0; m < MATS; ++m)
              add_sums(acc[m], sacc[(KSTEPS - 1) % NBUF][m]);
          }
          // the stage's products are done: the stage is free (the other
          // warpgroup's products run meanwhile; carrying the last product
          // into the next stage, freeing the stage later, was slower:
          // PERF.md §6)
          if (lane == 0) sm90::mbar_arrive(&empty[s]);
        }
      }
      // acc[m][q][4j + 2h + e]: column q * 64 + 16 w4 + lane / 4 + 8h,
      // slot 8j + 2 (lane % 4) + e. Warpgroup 1 stores its partial,
      // warpgroup 0 adds its own to it: the block's partial is wg0 + wg1,
      // written once every block has read the last tile's (B)
      if (tile != (int)blockIdx.x) sm90::cluster_wait();
      if (cw == 1) {
#pragma unroll
        for (int m = 0; m < MATS; ++m)
#pragma unroll
          for (int q = 0; q < PARTS; ++q)
#pragma unroll
            for (int j = 0; j < NB / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = q * 64 + 16 * w4 + g4 + 8 * (e >> 1);
                part[(m * COLS + n) * NB + 8 * j + 2 * t4 + (e & 1)] =
                    acc[m][q][4 * j + e];
              }
      }
      sm90::bar_sync(MV_BAR_PART, kThreads);
      if (cw == 0) {
#pragma unroll
        for (int m = 0; m < MATS; ++m)
#pragma unroll
          for (int q = 0; q < PARTS; ++q)
#pragma unroll
            for (int j = 0; j < NB / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = q * 64 + 16 * w4 + g4 + 8 * (e >> 1);
                float* d =
                    part + (m * COLS + n) * NB + 8 * j + 2 * t4 + (e & 1);
                *d = acc[m][q][4 * j + e] + *d;
              }
      }
      sm90::cluster_arrive();
      sm90::cluster_wait();   // A: every block's partial of the tile is written

#pragma unroll 2
      for (int t = 0; t < kOut; ++t) {
        const int i = o_lo + tid + t * kThreads;
        const int b = i % NB, n = n0 + i / NB;
        if (i >= o_hi || b >= p.B || n >= p.N) continue;
        // the operands prefetched into L2 above
        const float bn =
            p.bias != nullptr ? p.bias[(size_t)l * p.N + n] : 0.f;
        const float rs =
            kResid ? __bfloat162float(p.resid[(size_t)b * p.N + n]) : 0.f;
        float a = 0.f, a2 = 0.f;
        if constexpr (PAIR == PAIR_SPLIT) {
          for (int q = 0; q < nsplit; ++q)
            a += cluster.map_shared_rank(part, q)[i];
          for (int q = nsplit; q < nblk; ++q)
            a2 += cluster.map_shared_rank(part, q)[i];
        } else {
          for (int q = 0; q < nblk; ++q) {
            const float* pq = cluster.map_shared_rank(part, q);
            a += pq[i];
            if (PAIR == PAIR_BOTH) a2 += pq[COLS * NB + i];
          }
        }
        const size_t o = (size_t)b * p.N + n;
        if constexpr (EPI == EPI_BIAS) {
          p.out[o] = __float2bfloat16(a * sl + bn);
        } else if constexpr (EPI == EPI_RESID_X1) {
          const float x1 = rs + (a * sl + bn);
          p.out_f32[o] = x1;
          p.out[o] = __float2bfloat16(x1);
        } else if constexpr (EPI == EPI_GELU) {
          p.out[o] = __float2bfloat16(gelu_tanh(a * sl + bn));
        } else if constexpr (EPI == EPI_GELU_ERF) {
          p.out[o] = __float2bfloat16(gelu_erf(a * sl + bn));
        } else if constexpr (EPI == EPI_SWIGLU) {
          p.out[o] = __float2bfloat16(silu_f32(a * sl) * (a2 * sl2));
        } else {
          p.out[o] = __float2bfloat16((rs + a * sl) + bn);
        }
      }
      sm90::cluster_arrive();   // B: this block has read the partials
    }
    // no block leaves while another still reads its shared memory
    sm90::cluster_wait();
  }
}

// A launch's plan, chosen on the host (ops/cuda/decode.py matvec_tma_plan):
// the K split (blocks a matrix in a cluster), the ring's stages (even)
// and the clusters, which walk the column tiles
struct ProjPlan {
  int split, stages, clusters;
};

template <bool I8, int NB, int PRO, int EPI, int PAIR>
cudaError_t launch_proj_nb(ProjParams& p, const void* w, const void* w2,
                           const void* x, int L, ProjPlan plan,
                           cudaStream_t st) {
  using C = ProjCfg<I8, NB, PRO, PAIR>;
  const int mats = PAIR == PAIR_SPLIT ? 2 : 1;   // blocks a K slice
  const int n_tiles = (p.N + C::COLS - 1) / C::COLS;
  if (plan.split < 1 || plan.split * mats > kMaxSplit || plan.stages < 2 ||
      (plan.split & (plan.split - 1)) || plan.stages % 2 ||
      plan.clusters < 1 || plan.clusters > n_tiles)
    return cudaErrorInvalidValue;
  p.kslice = ((p.K + plan.split - 1) / plan.split + MV_KB - 1) / MV_KB *
             MV_KB;
  p.stages = plan.stages;
  const size_t smem = C::smem(p.kslice, plan.stages);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cuuint64_t wdims[3] = {(cuuint64_t)p.N, (cuuint64_t)p.K,
                               (cuuint64_t)L};
  const int wb = I8 ? 1 : 2;
  const cuuint64_t wstr[2] = {(cuuint64_t)p.N * wb,
                              (cuuint64_t)p.K * p.N * wb};
  const cuuint32_t wbox[3] = {I8 ? 128u : 64u, (cuuint32_t)MV_KB, 1};
  const CUtensorMapDataType wt = I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e =
      sm90::encode_tiled_cached(&p.w, wt, 3, w, wdims, wstr, wbox);
  if (e == cudaSuccess && PAIR != PAIR_NONE)
    e = sm90::encode_tiled_cached(&p.w2, wt, 3, w2, wdims, wstr, wbox);
  if (e == cudaSuccess && PRO == PRO_COPY) {
    const cuuint64_t xdims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.B};
    const cuuint64_t xstr[1] = {(cuuint64_t)p.K * 2};
    const cuuint32_t xbox[2] = {64, (cuuint32_t)NB};
    e = sm90::encode_tiled_cached(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                  x, xdims, xstr, xbox);
  }
  if (e != cudaSuccess) return e;
  auto kern = proj_tma_kernel<I8, NB, PRO, EPI, PAIR>;
  static bool allowed = false;     // one attribute call a kernel a process
  if (!allowed) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  const int cluster = plan.split * mats;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.clusters, cluster, 1);
  cfg.blockDim = dim3(MV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

// The launch at the slot width of B (8 or 16), over bf16 weights or int8
// codes; TMA needs every base 16-byte aligned and K, N multiples of 8 (N
// of 16 for int8 codes: a row of codes is then a multiple of 16 bytes)
template <int PRO, int EPI, int PAIR = PAIR_NONE>
cudaError_t launch_proj(ProjParams p, bool i8, const void* w, const void* w2,
                        const void* x, int L, ProjPlan plan,
                        cudaStream_t st) {
  if (p.B < 1 || p.B > 16 || p.K % 8 || p.N % (i8 ? 16 : 8) || L < 1)
    return cudaErrorInvalidValue;
  if (i8) {
    // int8 codes pair by splitting the cluster: both boxes a stage, with
    // the widened copies, fit no two blocks an SM (and ran 1.3x slower at
    // one block an SM; PERF.md)
    if constexpr (PAIR == PAIR_BOTH) return cudaErrorInvalidValue;
    else
      return p.B <= 8
                 ? launch_proj_nb<true, 8, PRO, EPI, PAIR>(p, w, w2, x, L,
                                                           plan, st)
                 : launch_proj_nb<true, 16, PRO, EPI, PAIR>(p, w, w2, x, L,
                                                            plan, st);
  }
  return p.B <= 8
             ? launch_proj_nb<false, 8, PRO, EPI, PAIR>(p, w, w2, x, L, plan,
                                                        st)
             : launch_proj_nb<false, 16, PRO, EPI, PAIR>(p, w, w2, x, L, plan,
                                                         st);
}

// a ProjParams with the fields every launch sets
inline ProjParams proj_params(const void* xin, const float* scales,
                              const float* bias, const int* layer_ptr,
                              bf16* out, int B, int K, int N) {
  ProjParams p;
  memset(&p, 0, sizeof(p));
  p.xin = xin;
  p.scales = scales;
  p.bias = bias;
  p.layer_ptr = layer_ptr;
  p.out = out;
  p.B = B;
  p.K = K;
  p.N = N;
  return p;
}

// ------------------------------------------------------- decode attention

constexpr int kAttnRows = 8;    // R <= 8 query rows a KV head: the mma's N
constexpr int kAttnWarps = 8;   // consumer warps; one producer warp more
constexpr int kAttnThreads = (kAttnWarps + 1) * 32;
constexpr int kGroup = 16;      // keys a warp takes at a time: the mma's M
constexpr int kStageGroups = 4; // 16-key groups (page pieces) a stage holds
constexpr int kStageKeys = kStageGroups * kGroup;
constexpr int kMaxSplits = 8;   // a slot's splits: one portable cluster

// A stage of the K/V ring for head dim D and a bf16 (Q8 false) or int8
// cache: the K rows of its four 16-key groups, then their V rows, then
// (int8) their 16 K scales and 16 V scales each. A group lies inside one
// page (pages are multiples of 16 rows), so each part of it is one
// contiguous run that one bulk copy fetches.
template <int D, bool Q8, bool FMA>
struct AttnCfg {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using T = typename std::conditional<Q8, int8_t, bf16>::type;
  static constexpr int ROW = D * (int)sizeof(T);
  static constexpr int GROUP = kGroup * ROW;        // K (or V) of a group
  static constexpr int SCALES = Q8 ? kGroup * 4 : 0;
  static constexpr int GROUP_BYTES = 2 * GROUP + 2 * SCALES;
  static constexpr int STAGE = kStageGroups * GROUP_BYTES;
  // the keys a consumer warp takes at a time: 16 (the mma's M), or on
  // the CUDA-core path (one query row) 32 / LANES, LANES lanes a key with
  // KDIMS head dims each; a stage's GPS groups go to one set of GPS warps
  // and the SETS sets take the stages in turn
  static constexpr int KDIMS = Q8 && D == 128 ? 64 : 32;
  static constexpr int LANES = D / KDIMS;
  static constexpr int GK = FMA ? 32 / LANES : kGroup;
  static constexpr int GPS = kStageKeys / GK;
  static constexpr int SETS = kAttnWarps / GPS;
  // with two sets an even count: each set then keeps to its own slots.
  // (With an odd one a set's slot follows the other set's use of it, and
  // a parity wait cannot tell whether that use's stage or its own has
  // landed: one took the wrong stage, a double wait deadlocked.)
  static constexpr int NST =
      STAGE > 16 * 1024 + 1024 ? (SETS == 1 ? 3 : 2) : 4;
  static_assert(NST % SETS == 0, "each slot serves one warp set");
  static constexpr int RING = NST * STAGE;
  // the block's merge reuses the ring: (m, l, acc[8][D]) of each warp
  static_assert((kAttnWarps * kAttnRows * (D + 2) + 2 * kAttnRows +
                 kAttnRows * D) * 4 <= RING,
                "the warps' merge area and the block's state");
  // the ring's full and empty barriers, then the append's
  static constexpr int SMEM = RING + (2 * NST + 1) * 8 + 16;
  static constexpr int KS = D / 16;    // k16 steps of a score, m16 tiles of P.V
  // 32-bit words of V a thread reads of each of its 4 keys: D/8 dims
  static constexpr int VW = Q8 ? D / 32 : D / 16;
};

// The first of the four head dims that a thread's A and B fragments take
// at k16 step s of the score S^T = K q^T (lane l: t4 = l % 4). A score
// sums over the dims, so the k16 steps may visit them in any order the
// two operands share: thread (g, t4) reads 16-byte pieces t4, t4 + 4, ...
// of its two K rows, which puts a quarter-warp's loads on two rows only
// (at most a 2-way bank conflict, none at int8 head dim 64), and each
// piece feeds 2 (bf16) or 4 (int8) steps: a0/a1 take dims base, base + 1
// and a2/a3 base + 2, base + 3 of rows g and g + 8.
template <int D, bool Q8>
__device__ __forceinline__ int kdim_base(int s, int t4) {
  if constexpr (Q8) return 16 * (t4 + 4 * (s / 4)) + 4 * (s % 4);
  return 8 * (t4 + 4 * (s / 2)) + 4 * (s % 2);
}

// The head dim of value t (0 .. D/8 - 1) of the D/8 that thread g owns in
// P.V (O^T = V^T P^T, head dims as M): m16 tile j holds dims dim(2j) in
// row g and dim(2j + 1) in row g + 8, so a thread reads each of its keys'
// V values as one contiguous run (8 bf16 or 16 int8 at a time)
template <int D, bool Q8>
__device__ __forceinline__ int vdim(int g, int t) {
  if constexpr (Q8) return (D / 8) * g + t;
  return 64 * (t / 8) + 8 * g + t % 8;
}

__device__ __forceinline__ void mma_m16n8k16(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8 x 8 b16 matrix a warp holds in the mma accumulator layout (lane l:
// row l / 4, columns 2 (l % 4), + 1), transposed in the same layout
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block per (KV head, slot, split of the keys): the split's keys
// [split * chunk, ..) up to pos + max_step stream through a ring of
// 64-key stages, filled by bulk copies from a producer warp; consumer warp
// w takes the split's 16-key groups w, w + 8, ... (group w % 4 of every
// other stage) with its own fp32 online softmax for the R rows on the
// tensor cores. The warps' states merge in warp order; a slot's only live
// split writes the output. Otherwise the slot's splits are one thread-
// block cluster (grid z, at most 8): each leaves its (m, l, acc) in its
// shared memory, and after a cluster barrier block z merges output
// elements z, z + n_split, ... over the live splits' states in split
// order, read through distributed shared memory (no workspace, no
// atomics: a rerun is bit for bit the same).
// Addressing: row ((l*NB + blk)*H + h)*page + key % page of the cache,
// blk = pt[b][key / page] (the paged pool), or with no page table blk = b
// and page = the cache length (the layer-stacked cache [Lyr, B, H, L, D]).
// Slot b's position is pos_arr[b * pos_stride].
template <int D, bool Q8, bool FMA>
__global__ void __launch_bounds__(kAttnThreads) decode_attn_kernel(
    const bf16* __restrict__ q, typename AttnCfg<D, Q8, FMA>::T* kc,
    typename AttnCfg<D, Q8, FMA>::T* vc, float* ks, float* vs,
    const int* __restrict__ pos_arr, int pos_stride,
    const int* __restrict__ pt, const int* __restrict__ layer_ptr,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, int nk_stride,
    int nv_stride, bf16* __restrict__ out, int H, int R, int NB, int page,
    int maxp,
    int rows_per_step, int chunk, float scale) {
  using C = AttnCfg<D, Q8, FMA>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING);
  uint64_t* empty = full + C::NST;
  uint64_t* appended = empty + C::NST;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int bh = b * H + h;
  const int pos = pos_arr[b * pos_stride];
  const int npair = R * D;
  bf16* ob = out + (size_t)bh * npair;

  // idle slot: zeros, and no page is touched (decode.py:959-961 — even a
  // multi-query window must not pull page 0 in); every block of the
  // cluster leaves here alike
  if (pos < 0) {
    if (split == 0)
      for (int i = threadIdx.x; i < npair; i += kAttnThreads)
        ob[i] = __float2bfloat16(0.f);
    return;
  }
  // keys past pos + max_step are masked for every row, as are pages past
  // the table: the Pallas grid visits page p iff p*page <= pos + max_step.
  // A split that starts past them reads nothing; with one live split the
  // others leave at once (the cluster takes no barrier then)
  const int max_step = rows_per_step > 0 ? R / rows_per_step - 1 : 0;
  const int n_keys = min(pos + max_step + 1, maxp * page);
  const int n_live = (n_keys + chunk - 1) / chunk;
  if (n_live == 1 && split > 0) return;
  // this block's (m[8], l[8], acc[R * D]) for the cluster's merge, past
  // the warps' merge area in the (then idle) ring
  float* res = reinterpret_cast<float*>(smem) + kAttnWarps * kAttnRows *
                                                    (D + 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (split < n_live) {
    const int k0 = split * chunk, k1 = min(k0 + chunk, n_keys);
    const int n_stages = (k1 - k0 + kStageKeys - 1) / kStageKeys;
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::NST; ++s) {
        sm90::mbar_init(&full[s], 1);        // the producer's expect_tx
        sm90::mbar_init(&empty[s], C::GPS);  // its consumers' lane 0
      }
      sm90::mbar_init(appended, 1);          // consumer warp 0's lane 0
      sm90::mbar_fence_init();
    }
    __syncthreads();
    const int l = layer_ptr ? *layer_ptr : 0;
    const int* ptb = pt ? pt + (size_t)b * maxp : nullptr;
    // the cache append (nk: the slot's new K rows, this head's at nk + b *
    // nk_stride + h * D; nv likewise): the row goes to block pt[b][min(pos
    // / page, maxp - 1)], row pos % page of a paged pool, or row min(pos,
    // L - 1) of a stacked cache (as dynamic_update_slice clamps). The
    // block whose split holds that key writes it: consumer warp 0 at its
    // start, while the first stages are in flight; the producer waits for
    // it before it copies the stage that holds the row (stage wstage). No
    // other block reads the row.
    int wstage = -1;
    size_t wrow = 0;
    if (nk && (warp == 0 || warp == kAttnWarps)) {
      int wkey, wblk = b;
      if (ptb) {
        const int p = min(pos / page, maxp - 1);
        wblk = ptb[p];
        wkey = p * page + pos % page;
      } else {
        wkey = min(pos, page - 1);
      }
      if (wkey >= k0 && wkey < k1) {
        wstage = (wkey - k0) / kStageKeys;
        wrow = ((size_t)(l * NB + wblk) * H + h) * page + (wkey % page);
      }
    }
    if (warp == 0 && wstage >= 0) {
      // kv_quant_kernel's arithmetic for an int8 cache (amax * fl(1/127),
      // an IEEE division, rintf: the same codes and scale), the rows as
      // they are for a bf16 one; then the proxy fence, so that the bulk
      // copy (the async proxy) sees these generic-proxy writes
      constexpr int kC = D / 32;           // a lane's head dims of the row
      const size_t head = (size_t)h * D + lane * kC;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const bf16* src = kv ? nv + (size_t)b * nv_stride + head
                             : nk + (size_t)b * nk_stride + head;
        typename C::T* dst = (kv ? vc : kc) + wrow * D + lane * kC;
        if constexpr (Q8) {
          float x[kC], amax = 0.f;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            x[c] = __bfloat162float(src[c]);
            amax = fmaxf(amax, fabsf(x[c]));
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
          const float sc = fmaxf(amax * (1.f / 127.f), 1e-12f);
#pragma unroll
          for (int c = 0; c < kC; ++c)
            dst[c] = (int8_t)(int)fminf(fmaxf(rintf(x[c] / sc), -127.f),
                                        127.f);
          if (lane == 0) (kv ? vs : ks)[wrow] = sc;
        } else {
#pragma unroll
          for (int c = 0; c < kC; ++c) dst[c] = src[c];
        }
      }
      sm90::fence_proxy_async_global();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(appended);
    }

    if (warp == kAttnWarps) {   // the producer warp
      // the page table 32 entries at a time, one a lane, read ahead of
      // the copies that need them (a dependent load a page would
      // serialise the stream)
      int pbase = -32, tab = 0;
      for (int t = 0; t < n_stages; ++t) {
        const int s = t % C::NST;
        const int key = k0 + t * kStageKeys;
        const int ng = min(kStageGroups, (k1 - key + kGroup - 1) / kGroup);
        unsigned char* st = smem + s * C::STAGE;
        if (t == wstage) {            // the append has landed
          if (lane == 0) sm90::mbar_wait(appended, 0);
          __syncwarp();
        }
        if (ptb && (key + ng * kGroup - 1) / page >= pbase + 32) {
          pbase = key / page;
          tab = pbase + lane < maxp ? ptb[pbase + lane] : 0;
        }
        if (lane == 0) {
          sm90::mbar_wait(&empty[s], ((t / C::NST) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], ng * C::GROUP_BYTES);
        }
        // the stacked cache: one copy each of K, V and the scales, by lane
        // 0; a paged pool: lane g copies group g (its page's rows), so the
        // small copies of a stage are issued together
        __syncwarp();
        const int g0 = ptb ? lane : 0;
        const int kg = key + g0 * kGroup, p = kg / page;
        const int blk = ptb ? __shfl_sync(kFull, tab, p - pbase) : b;
        if (ptb ? lane < ng : lane == 0) {
          const size_t row =
              ((size_t)(l * NB + blk) * H + h) * page + (kg - p * page);
          const int n = ptb ? 1 : ng;
          sm90::bulk_load(st + g0 * C::GROUP, kc + row * D, n * C::GROUP,
                          &full[s]);
          sm90::bulk_load(st + (kStageGroups + g0) * C::GROUP, vc + row * D,
                          n * C::GROUP, &full[s]);
          if constexpr (Q8) {
            unsigned char* sc = st + 2 * kStageGroups * C::GROUP;
            sm90::bulk_load(sc + g0 * C::SCALES, ks + row, n * C::SCALES,
                            &full[s]);
            sm90::bulk_load(sc + (kStageGroups + g0) * C::SCALES, vs + row,
                            n * C::SCALES, &full[s]);
          }
        }
      }
    } else {
      // each warp leaves its (m, l, acc) here, in the (then idle) ring, for
      // the block's merge; a warp that saw no key of a row holds m =
      // -1e30, l = 0, acc = 0
      float* wm = reinterpret_cast<float*>(smem);              // [8][8]
      float* wl = wm + kAttnWarps * kAttnRows;                 // [8][8]
      float* wacc = wl + kAttnWarps * kAttnRows;               // [8][8][D]
      if constexpr (FMA) {
        // the CUDA-core path (one query row): LANES lanes a key, KDIMS
        // head dims each, for the score; a lane's D / 32 head dims for
        // P.V, p broadcast by shuffles; the arithmetic and its order are
        // those of the one-block-a-(head, slot) kernel this replaced, so
        // a slot of one split gives its bits
        using T = typename C::T;
        constexpr int kL = C::LANES, kKD = C::KDIMS, kDims = D / 32;
        const int sub = lane % kL;
        float qv[kKD];
        const bf16* qb = q + (size_t)bh * npair + sub * kKD;
#pragma unroll
        for (int i = 0; i < kKD; ++i) qv[i] = __bfloat162float(qb[i]);
        float m = -1e30f, lsum = 0.f, acc[kDims];
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
        const int wg = warp % C::GPS;
        for (int t = warp / C::GPS; t < n_stages; t += C::SETS) {
          const int s = t % C::NST;
          sm90::mbar_wait(&full[s], (t / C::NST) & 1);
          const int kin = wg * C::GK;                 // in the stage
          const int key0 = k0 + t * kStageKeys + kin;
          if (key0 < k1) {
            const unsigned char* st = smem + s * C::STAGE;
            const T* kt = reinterpret_cast<const T*>(st) + kin * D;
            const T* vt = reinterpret_cast<const T*>(st + kStageGroups *
                                                     C::GROUP) + kin * D;
            const float* sk = reinterpret_cast<const float*>(
                st + 2 * kStageGroups * C::GROUP) + kin;
            const float* sv = sk + kStageKeys;
            const int kr = lane / kL;                // this lane's key
            const uint4* kp = reinterpret_cast<const uint4*>(
                kt + kr * D + sub * kKD);
            float d = 0.f;
            if constexpr (Q8) {
#pragma unroll
              for (int i = 0; i < kKD / 16; ++i) {
                const uint4 w = kp[i];
                float kf[16];
                unpack4_i8(w.x, kf);
                unpack4_i8(w.y, kf + 4);
                unpack4_i8(w.z, kf + 8);
                unpack4_i8(w.w, kf + 12);
#pragma unroll
                for (int c = 0; c < 16; ++c)
                  d = fmaf(qv[16 * i + c], kf[c], d);
              }
            } else {
              float kf[kKD];
#pragma unroll
              for (int i = 0; i < kKD / 8; ++i) unpack8(kp[i], kf + 8 * i);
#pragma unroll
              for (int c = 0; c < kKD; ++c) d = fmaf(qv[c], kf[c], d);
            }
#pragma unroll
            for (int o = 1; o < kL; o <<= 1)
              d += __shfl_xor_sync(kFull, d, o);
            const int key = key0 + kr;
            const bool valid = key <= pos;
            float sc = d * scale;
            if constexpr (Q8) sc = sc * sk[kr];
            float gmax = valid ? sc : -1e30f;
#pragma unroll
            for (int o = kL; o < 32; o <<= 1)
              gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, o));
            const float m_new = fmaxf(m, gmax);
            const float alpha = __expf(m - m_new);
            const float p = valid ? __expf(sc - m_new) : 0.f;
            lsum = lsum * alpha + warp_sum(sub ? 0.f : p);
            // p (times the key's V scale) rounded to bf16 before P.V
            float pv = p;
            if constexpr (Q8) pv = valid ? p * sv[kr] : 0.f;
            const float pr = __bfloat162float(__float2bfloat16(pv));
            float a[kDims];
#pragma unroll
            for (int e = 0; e < kDims; ++e) a[e] = acc[e] * alpha;
#pragma unroll
            for (int j = 0; j < C::GK; ++j) {
              const float pj = __shfl_sync(kFull, pr, j * kL);
              float vf[4];
              if constexpr (Q8) {
                uint32_t w;
                if constexpr (D == 128)
                  w = reinterpret_cast<const uint32_t*>(vt + j * D)[lane];
                else
                  w = reinterpret_cast<const unsigned short*>(vt + j * D)
                      [lane];
                unpack4_i8(w, vf);
              } else {
#pragma unroll
                for (int x = 0; x < kDims / 2; ++x) {
                  const uint32_t w = reinterpret_cast<const uint32_t*>(
                      vt + j * D)[lane * (kDims / 2) + x];
                  vf[2 * x] = __uint_as_float(w << 16);
                  vf[2 * x + 1] = __uint_as_float(w & 0xffff0000u);
                }
              }
#pragma unroll
              for (int e = 0; e < kDims; ++e) a[e] = fmaf(pj, vf[e], a[e]);
            }
#pragma unroll
            for (int e = 0; e < kDims; ++e) acc[e] = a[e];
            m = m_new;
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[s]);
        }
        sm90::bar_sync(1, kAttnWarps * 32);
        if (lane == 0) {
          wm[warp * kAttnRows] = m;
          wl[warp * kAttnRows] = lsum;
        }
#pragma unroll
        for (int e = 0; e < kDims; ++e)
          wacc[warp * kAttnRows * D + kDims * lane + e] = acc[e];
      } else {
        const int g = lane / 4, t4 = lane % 4;
        // q^T as the score's B operand: row g's dims in kdim_base's order
        uint32_t qf[C::KS][2];
        const bf16* qb = q + (size_t)bh * npair;
#pragma unroll
        for (int s = 0; s < C::KS; ++s) {
          uint2 v = make_uint2(0u, 0u);
          if (g < R)
            v = *reinterpret_cast<const uint2*>(qb + g * D +
                                                kdim_base<D, Q8>(s, t4));
          qf[s][0] = v.x;
          qf[s][1] = v.y;
        }
        // this thread's rows r = 2 t4 + i: the key limit (-1: a padding row)
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * t4 + i;
          lim[i] = r < R ? pos + (rows_per_step > 0 ? r / rows_per_step : 0)
                         : -1;
        }
        float m[2] = {-1e30f, -1e30f}, lsum[2] = {0.f, 0.f};
        float acc[C::KS][4];
#pragma unroll
        for (int j = 0; j < C::KS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

        const int wg = warp % C::GPS;
        for (int t = warp / C::GPS; t < n_stages; t += C::SETS) {
          const int s = t % C::NST;
          sm90::mbar_wait(&full[s], (t / C::NST) & 1);
          const int key = k0 + t * kStageKeys + wg * kGroup;
          if (key < k1) {
            const unsigned char* st = smem + s * C::STAGE;
            const auto* kt = reinterpret_cast<const typename C::T*>(
                st + wg * C::GROUP);
            const auto* vt = reinterpret_cast<const typename C::T*>(
                st + (kStageGroups + wg) * C::GROUP);
            // S^T [16 keys, 8 rows] = K q^T, as two chains of products
            float sc[4] = {0.f, 0.f, 0.f, 0.f}, sd[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (Q8) {
#pragma unroll
              for (int c = 0; c < D / 64; ++c) {
                const uint4 ka = *reinterpret_cast<const uint4*>(
                    kt + g * D + 16 * (t4 + 4 * c));
                const uint4 kb = *reinterpret_cast<const uint4*>(
                    kt + (g + 8) * D + 16 * (t4 + 4 * c));
                const uint32_t wa[4] = {ka.x, ka.y, ka.z, ka.w};
                const uint32_t wb[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const uint2 xa = widen4(wa[j]), xb = widen4(wb[j]);
                  const uint32_t a[4] = {xa.x, xb.x, xa.y, xb.y};
                  mma_m16n8k16(j % 2 ? sd : sc, a, qf[4 * c + j][0],
                               qf[4 * c + j][1]);
                }
              }
            } else {
#pragma unroll
              for (int c = 0; c < D / 32; ++c) {
                const uint4 ka = *reinterpret_cast<const uint4*>(
                    kt + g * D + 8 * (t4 + 4 * c));
                const uint4 kb = *reinterpret_cast<const uint4*>(
                    kt + (g + 8) * D + 8 * (t4 + 4 * c));
                const uint32_t a0[4] = {ka.x, kb.x, ka.y, kb.y};
                const uint32_t a1[4] = {ka.z, kb.z, ka.w, kb.w};
                mma_m16n8k16(sc, a0, qf[2 * c][0], qf[2 * c][1]);
                mma_m16n8k16(sd, a1, qf[2 * c + 1][0], qf[2 * c + 1][1]);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[e] += sd[e];
            // sc[e]: key g + 8 (e / 2), row 2 t4 + e % 2
            float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
            if constexpr (Q8) {
              const float* sk = reinterpret_cast<const float*>(
                  st + 2 * kStageGroups * C::GROUP + wg * C::SCALES);
              const float* sv = sk + kStageGroups * kGroup;
              ksc[0] = sk[g];
              ksc[1] = sk[g + 8];
              vsc[0] = sv[g];
              vsc[1] = sv[g + 8];
            }
            float p[4], alpha[2];
            bool ok[4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float mx = -1e30f;
#pragma unroll
              for (int hk = 0; hk < 2; ++hk) {
                const int e = 2 * hk + i;
                ok[e] = key + g + 8 * hk <= lim[i];
                float v = sc[e] * scale;
                if constexpr (Q8) v = v * ksc[hk];
                sc[e] = v;
                if (ok[e]) mx = fmaxf(mx, v);
              }
              mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
              mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
              mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
              const float m_new = fmaxf(m[i], mx);
              alpha[i] = __expf(m[i] - m_new);
              m[i] = m_new;
              p[i] = ok[i] ? __expf(sc[i] - m_new) : 0.f;
              p[i + 2] = ok[i + 2] ? __expf(sc[i + 2] - m_new) : 0.f;
              lsum[i] = lsum[i] * alpha[i] + (p[i] + p[i + 2]);
            }
            // P^T as the B operand of O^T += V^T P^T: p (times the key's V
            // scale) rounded to bf16, as in the Pallas kernel, and transposed
            // in registers
            float pv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pv[e] = p[e];
              if constexpr (Q8) pv[e] = ok[e] ? p[e] * vsc[e / 2] : 0.f;
            }
            const uint32_t b0 = movmatrix_t(pack_bf16(pv[0], pv[1]));
            const uint32_t b1 = movmatrix_t(pack_bf16(pv[2], pv[3]));
            // V^T's A fragments: keys 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 (k),
            // this thread's head dims (m)
            uint32_t vw[4][C::VW];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int row = 2 * t4 + (kk & 1) + 8 * (kk >> 1);
              if constexpr (Q8) {
                const auto* vr = vt + row * D + (D / 8) * g;
                if constexpr (D == 128) {
                  const uint4 x = *reinterpret_cast<const uint4*>(vr);
                  vw[kk][0] = x.x; vw[kk][1] = x.y; vw[kk][2] = x.z;
                  vw[kk][3] = x.w;
                } else {
                  const uint2 x = *reinterpret_cast<const uint2*>(vr);
                  vw[kk][0] = x.x; vw[kk][1] = x.y;
                }
              } else {
#pragma unroll
                for (int c = 0; c < D / 64; ++c) {
                  const uint4 x = *reinterpret_cast<const uint4*>(
                      vt + row * D + 64 * c + 8 * g);
                  vw[kk][4 * c] = x.x; vw[kk][4 * c + 1] = x.y;
                  vw[kk][4 * c + 2] = x.z; vw[kk][4 * c + 3] = x.w;
                }
              }
            }
#pragma unroll
            for (int j = 0; j < C::KS; ++j) {
              acc[j][0] *= alpha[0];
              acc[j][1] *= alpha[1];
              acc[j][2] *= alpha[0];
              acc[j][3] *= alpha[1];
              uint32_t a[4];
              if constexpr (Q8) {
                const int w = j / 2;
                const uint32_t sel = j % 2 ? 0x7362u : 0x5140u;
                const uint2 x = widen4(__byte_perm(vw[0][w], vw[1][w], sel));
                const uint2 y = widen4(__byte_perm(vw[2][w], vw[3][w], sel));
                a[0] = x.x; a[1] = x.y; a[2] = y.x; a[3] = y.y;
              } else {
                a[0] = __byte_perm(vw[0][j], vw[1][j], 0x5410);
                a[1] = __byte_perm(vw[0][j], vw[1][j], 0x7632);
                a[2] = __byte_perm(vw[2][j], vw[3][j], 0x5410);
                a[3] = __byte_perm(vw[2][j], vw[3][j], 0x7632);
              }
              mma_m16n8k16(acc[j], a, b0, b1);
            }
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[s]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lsum[i] += __shfl_xor_sync(kFull, lsum[i], 4);
          lsum[i] += __shfl_xor_sync(kFull, lsum[i], 8);
          lsum[i] += __shfl_xor_sync(kFull, lsum[i], 16);
        }

        sm90::bar_sync(1, kAttnWarps * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * t4 + i;
          if (g == 0) {
            wm[warp * kAttnRows + r] = m[i];
            wl[warp * kAttnRows + r] = lsum[i];
          }
          float* wr = wacc + (warp * kAttnRows + r) * D;
#pragma unroll
          for (int j = 0; j < C::KS; ++j) {
            wr[vdim<D, Q8>(g, 2 * j)] = acc[j][i];
            wr[vdim<D, Q8>(g, 2 * j + 1)] = acc[j][2 + i];
          }
        }
      }
      // the block's merge, in warp order
      sm90::bar_sync(1, kAttnWarps * 32);
      for (int i = threadIdx.x; i < npair; i += kAttnWarps * 32) {
        const int r = i / D, d = i % D;
        float M = -1e30f;
#pragma unroll
        for (int w = 0; w < kAttnWarps; ++w)
          M = fmaxf(M, wm[w * kAttnRows + r]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < kAttnWarps; ++w) {
          const float f = __expf(wm[w * kAttnRows + r] - M);
          L = fmaf(f, wl[w * kAttnRows + r], L);
          A = fmaf(f, wacc[(w * kAttnRows + r) * D + d], A);
        }
        if (n_live == 1) {
          ob[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
        } else {
          res[2 * kAttnRows + i] = A;
          if (d == 0) {
            res[r] = M;
            res[kAttnRows + r] = L;
          }
        }
      }
    }
  }
  if (n_live == 1) return;

  // the cluster's merge: block `split` takes output elements split,
  // split + n_split, ..., each over the live splits in split order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every live block's state is in its shared memory
  for (int i = split + n_split * threadIdx.x; i < npair;
       i += n_split * kAttnThreads) {
    const int r = i / D;
    float mv[kMaxSplits], M = -1e30f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      mv[s] = s < n_live ? cluster.map_shared_rank(res, s)[r] : -1e30f;
      M = fmaxf(M, mv[s]);
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < n_live) {
        const float* rs = cluster.map_shared_rank(res, s);
        const float f = __expf(mv[s] - M);
        L = fmaf(f, rs[kAttnRows + r], L);
        A = fmaf(f, rs[2 * kAttnRows + i], A);
      }
    }
    ob[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();   // no block leaves while another still reads its state
}

template <int D, bool Q8, bool FMA>
cudaError_t launch_attn(const void* q, void* k, void* v, void* ks, void* vs,
                        const void* pos, int pos_stride, const void* pt,
                        const void* layer_ptr, const void* nk,
                        const void* nv, int nk_stride, int nv_stride,
                        void* out, int B, int H, int R, int NB, int page,
                        int maxp, int rows_per_step, int chunk, int n_split,
                        float scale, cudaStream_t st) {
  using C = AttnCfg<D, Q8, FMA>;
  using T = typename C::T;
  auto kern = decode_attn_kernel<D, Q8, FMA>;
  static bool allowed = false;     // one attribute call a kernel a process
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, n_split);
  cfg.blockDim = dim3(kAttnThreads, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;   // a slot's splits: one cluster
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, (const bf16*)q, (T*)k, (T*)v,
                            (float*)ks, (float*)vs, (const int*)pos,
                            pos_stride, (const int*)pt, (const int*)layer_ptr,
                            (const bf16*)nk, (const bf16*)nv, nk_stride,
                            nv_stride, (bf16*)out, H, R, NB, page, maxp,
                            rows_per_step, chunk, scale);
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
cudaError_t out_ffn_gelu(bool i8, const void* ctx, const void* x,
                         const void* wp, const float* sp, const float* bp,
                         const float* ln_w, const float* ln_b, const void* w1,
                         const float* s1, const float* b1, const void* w2,
                         const float* s2, const float* b2, const int* lp,
                         bf16* x1, float* x1f, bf16* h, bf16* out, int B,
                         int E, int F, int L, const int* plan, float eps,
                         cudaStream_t st) {
  ProjParams pa = proj_params(nullptr, sp, bp, lp, x1, B, E, E);
  pa.resid = (const bf16*)x;
  pa.out_f32 = x1f;
  cudaError_t e = launch_proj<PRO_COPY, EPI_RESID_X1>(
      pa, i8, wp, nullptr, ctx, L, {plan[0], plan[1], plan[2]}, st);
  if (e != cudaSuccess) return e;
  ProjParams pb = proj_params(x1f, s1, b1, lp, h, B, E, F);
  pb.ln_w = ln_w;
  pb.ln_b = ln_b;
  pb.eps = eps;
  e = launch_proj<PRO_LN_F32, EPI_GELU>(pb, i8, w1, nullptr, nullptr, L,
                                        {plan[3], plan[4], plan[5]}, st);
  if (e != cudaSuccess) return e;
  ProjParams pc = proj_params(nullptr, s2, b2, lp, out, B, F, E);
  pc.resid = x1;
  return launch_proj<PRO_COPY, EPI_RESID>(pc, i8, w2, nullptr, h, L,
                                          {plan[6], plan[7], plan[8]}, st);
}

}  // namespace

extern "C" {

// out [B, N] = norm(x) . W[layer] * s[layer] (+ b[layer]) over W [L, E, N];
// rms != 0 takes RMSNorm (ln_w only, no bias: pass null ln_b and b); w8 !=
// 0: W holds int8 codes. A null layer_ptr reads layer 0 (ln_qkv_int8).
// plan: the launch's (split, stages, clusters), a host array
// (ops/cuda/decode.py matvec_tma_plan)
int dstpu_ln_qkv_stacked(const void* x, const void* ln_w, const void* ln_b,
                         const void* w, const void* s, const void* b,
                         const void* layer_ptr, void* out, int B, int E,
                         int N, int L, int rms, int w8, const void* plan,
                         float eps, void* stream) {
  ProjParams p = proj_params(x, (const float*)s, (const float*)b,
                             (const int*)layer_ptr, (bf16*)out, B, E, N);
  p.ln_w = (const float*)ln_w;
  p.ln_b = (const float*)ln_b;
  p.eps = eps;
  const int* pl = (const int*)plan;
  const ProjPlan pp = {pl[0], pl[1], pl[2]};
  cudaStream_t st = (cudaStream_t)stream;
  if (rms)
    return (int)launch_proj<PRO_RMS_BF16, EPI_BIAS>(p, w8, w, nullptr,
                                                    nullptr, L, pp, st);
  return (int)launch_proj<PRO_LN_BF16, EPI_BIAS>(p, w8, w, nullptr, nullptr,
                                                 L, pp, st);
}

// out [B, N] = x . W[layer] * s[layer] over W [L, K, N]; w8 != 0: W holds
// int8 codes. fma == 0: proj_tma_kernel at the plan (split, stages,
// clusters: a host array), which needs every base 16-byte aligned and K, N
// multiples of 8 (of 16 for int8 codes); fma != 0: the CUDA-core kernel,
// which takes every shape the wrapper takes (plan unused)
int dstpu_matvec_stacked(const void* x, const void* w, const void* s,
                         const void* layer_ptr, void* out, int B, int K,
                         int N, int L, int w8, int fma, const void* plan,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* pl = (const int*)plan;
  if (!fma)
    return (int)launch_proj<PRO_COPY, EPI_BIAS>(
        proj_params(nullptr, (const float*)s, nullptr,
                    (const int*)layer_ptr, (bf16*)out, B, K, N),
        w8, w, nullptr, x, L, {pl[0], pl[1], pl[2]}, st);
  if (B < 1 || B > 16) return (int)cudaErrorInvalidValue;
#define FMA_LAUNCH(MAXB, TW)                                                \
  return (int)launch_fma<MAXB, TW>((const bf16*)x, (const TW*)w,           \
                                   (const float*)s, (const int*)layer_ptr, \
                                   (bf16*)out, B, K, N, st)
  if (w8 && B <= 8) FMA_LAUNCH(8, int8_t);
  if (w8) FMA_LAUNCH(16, int8_t);
  if (B <= 8) FMA_LAUNCH(8, bf16);
  FMA_LAUNCH(16, bf16);
#undef FMA_LAUNCH
}

// Three launches on one stream: x1 (bf16 + fp32 copies), h, then out;
// w8 != 0: Wp, W1 and W2 hold int8 codes. A null layer_ptr reads layer 0
// (out_ffn_int8). plan: (split, stages, clusters) of each launch, in order
int dstpu_out_ffn_stacked(const void* ctx, const void* x, const void* wp,
                          const void* sp, const void* bp, const void* ln_w,
                          const void* ln_b, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, const void* layer_ptr,
                          void* x1, void* x1f, void* h,
                          void* out, int B, int E, int F, int L, int w8,
                          const void* plan, float eps, void* stream) {
  return (int)out_ffn_gelu(
      w8, ctx, x, wp, (const float*)sp, (const float*)bp, (const float*)ln_w,
      (const float*)ln_b, w1, (const float*)s1, (const float*)b1, w2,
      (const float*)s2, (const float*)b2, (const int*)layer_ptr, (bf16*)x1,
      (float*)x1f, (bf16*)h, (bf16*)out, B, E, F, L, (const int*)plan, eps,
      (cudaStream_t)stream);
}

// out [B, N] = act(x . W * s + b) over int8 codes W [K, N] and one fp32
// scale s on the card (matvec_int8); act 0: none, 1: gelu_tanh, 2: gelu
int dstpu_matvec_int8(const void* x, const void* w, const void* s,
                      const void* b, void* out, int B, int K, int N, int act,
                      const void* plan_, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ProjParams p = proj_params(nullptr, (const float*)s, (const float*)b,
                                   nullptr, (bf16*)out, B, K, N);
  const int* pl = (const int*)plan_;
  const ProjPlan plan = {pl[0], pl[1], pl[2]};
  if (act == 1)
    return (int)launch_proj<PRO_COPY, EPI_GELU>(p, true, w, nullptr, x, 1,
                                                plan, st);
  if (act == 2)
    return (int)launch_proj<PRO_COPY, EPI_GELU_ERF>(p, true, w, nullptr, x,
                                                    1, plan, st);
  return (int)launch_proj<PRO_COPY, EPI_BIAS>(p, true, w, nullptr, x, 1,
                                              plan, st);
}

// LLaMA's out_ffn with fuse_proj=False, two launches on one stream:
// h = silu(RMS(x1).Wg.sg) * (RMS(x1).Wu.su), then out = x1 + h.Wd.sd;
// w8 != 0: Wg, Wu and Wd hold int8 codes. plan: (split, stages, clusters)
// of each launch; pair: the gate/up pairing (PAIR_SPLIT or PAIR_BOTH)
int dstpu_out_ffn_glu_stacked(const void* x1, const void* ln_w,
                              const void* wg, const void* sg,
                              const void* wu, const void* su,
                              const void* wd, const void* sd,
                              const void* layer_ptr, void* h, void* out,
                              int B, int E, int F, int L, int w8,
                              const void* plan, int pair, float eps,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* pl = (const int*)plan;
  const int* lp = (const int*)layer_ptr;
  ProjParams pa = proj_params(x1, (const float*)sg, nullptr, lp, (bf16*)h, B,
                              E, F);
  pa.ln_w = (const float*)ln_w;
  pa.scales2 = (const float*)su;
  pa.eps = eps;
  cudaError_t e =
      pair == PAIR_BOTH
          ? launch_proj<PRO_RMS_BF16, EPI_SWIGLU, PAIR_BOTH>(
                pa, w8, wg, wu, nullptr, L, {pl[0], pl[1], pl[2]}, st)
      : pair == PAIR_SPLIT
          ? launch_proj<PRO_RMS_BF16, EPI_SWIGLU, PAIR_SPLIT>(
                pa, w8, wg, wu, nullptr, L, {pl[0], pl[1], pl[2]}, st)
          : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  ProjParams pb = proj_params(nullptr, (const float*)sd, nullptr, lp,
                              (bf16*)out, B, F, E);
  pb.resid = (const bf16*)x1;
  return (int)launch_proj<PRO_COPY, EPI_RESID>(pb, w8, wd, nullptr, h, L,
                                               {pl[3], pl[4], pl[5]}, st);
}

// q [B, H, R, D] bf16 over a bf16 cache or an int8 one with fp32 scales
// [.., 1, page], D 64 or 128; R <= 8, page % 16 == 0. With a page table
// [B, maxp] the cache is the pool [Lyr, NB, H, page, D]; without, the
// stacked cache [Lyr, B, H, page, D] (maxp 1, NB = B; a null layer_ptr
// reads layer 0: decode_attention_int8's [B, H, L, D] cache). The keys
// are split into n_split <= 8 runs of chunk keys (a multiple of 16,
// chunk * n_split >= maxp * page), a slot's runs one cluster. With new_k
// and new_v ([B, H, D] bf16, batch strides k_stride and v_stride
// elements, heads and dims contiguous) the kernel
// first appends each live slot's new row at its position (one row a
// slot: the R rows one step). The wrapper checks the geometry.
int dstpu_decode_attention(const void* q, void* k, void* v, void* k_scale,
                           void* v_scale, const void* pos,
                           const void* page_table, const void* layer_ptr,
                           const void* new_k, const void* new_v,
                           int k_stride, int v_stride, void* out, int B,
                           int H, int R,
                           int D, int NB, int page, int maxp,
                           int rows_per_step, int pos_stride, int chunk,
                           int n_split, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool q8 = k_scale != nullptr;
  if (chunk <= 0 || chunk % kGroup || page % kGroup || n_split < 1 ||
      n_split > kMaxSplits ||
      (long long)chunk * n_split < (long long)maxp * page ||
      (new_k != nullptr) != (new_v != nullptr) ||
      (new_k != nullptr && rows_per_step > 0 && R / rows_per_step > 1))
    return (int)cudaErrorInvalidValue;
  // one query row a KV head (MHA decode): the CUDA-core path
#define DECODE_ATTN(DIM, Q8)                                                 \
  return (int)(R == 1 ? launch_attn<DIM, Q8, true>(                          \
                            q, k, v, k_scale, v_scale, pos, pos_stride,      \
                            page_table, layer_ptr, new_k, new_v, k_stride,   \
                            v_stride, out, B, H, R, NB, page, maxp,          \
                            rows_per_step, chunk, n_split, scale, st)        \
                      : launch_attn<DIM, Q8, false>(                         \
                            q, k, v, k_scale, v_scale, pos, pos_stride,      \
                            page_table, layer_ptr, new_k, new_v, k_stride,   \
                            v_stride, out, B, H, R, NB, page, maxp,          \
                            rows_per_step, chunk, n_split, scale, st))
  if (D == 64 && !q8) DECODE_ATTN(64, false);
  if (D == 128 && !q8) DECODE_ATTN(128, false);
  if (D == 64 && q8) DECODE_ATTN(64, true);
  if (D == 128 && q8) DECODE_ATTN(128, true);
#undef DECODE_ATTN
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
