// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the Pallas forward of deepspeed_tpu/ops/pallas/flash_attention.py:
// flash_attention (:580) -> _flash_fwd (:149) -> _fwd_kernel (:122). It
// covers the chunked long-S forward's contract too (_flash_fwd_chunked,
// :336): K/V are streamed in tiles for any S, so no VMEM-budget split is
// needed.
//
// What bounds it on the H100: the tensor cores, and the K/V tiles' trips
// out of L2. A causal head does 4 S^2 D / 2 flops over 8 S D bytes of
// memory, S / 4 flops a byte (the ridge is 295), but every 128-row q tile
// reads its K/V prefix again from L2: 128 flops a byte at any D, 7.7 TB/s
// at the tensor cores' rate, where the loads alone reached ~4.5 TB/s on an
// H100. The exp of every score runs on the SFU (16 a clock an SM), at D 64
// about as long as a tile's two products.
//
// What the design does about it (flash_fwd_tma_kernel, entry
// dstpu_flash_fwd):
// - Only wgmma reaches the card's bf16 rate. A block of 384 threads, one
//   an SM, walks (128-row q tile, b*h) tiles: warpgroup 0 is the producer
//   (one thread issues TMA loads; setmaxnreg gives its registers to the
//   others), warpgroups 1 and 2 each own 64 q rows and keep S (64 x 128
//   keys) and O (64 x D) in fp32 registers.
// - TMA feeds shared memory: Q, then K and V tiles of 128 keys into rings
//   of 4 stages (D 64; at D 128 2 for K and 3 for V), each stage a
//   full/empty mbarrier pair (expect_tx bytes in, 8 consumer-warp
//   arrivals out). The tensor maps are 3-D, [B*H, S, D] for q/o and
//   [B*Hkv, S, D] for k/v, so a ragged tail reads TMA's zeros, never the
//   next head's rows; a row of D 128 is two 64-element boxes. GQA: the kv
//   head is picked by index.
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//   K-major (csrc/sm90.cuh's 128-byte swizzle contract). The online
//   softmax runs in fp32 on the accumulator layout, in raw-score units
//   (p = exp2(s * scale log2 e - m * scale log2 e)); only the last tile,
//   the diagonal one or the one holding the ragged tail, is masked (to
//   the reference's -1e30), and causal tiles above the diagonal are never
//   loaded. P is rounded to bf16 and re-packed in registers as the A
//   operand of O += P V (wgmma with A from registers); V is read as stored,
//   [keys][D] with D contiguous, as the MN-major operand (the transpose
//   bit, no copies).
// - Each warpgroup issues S of the next tile together with O += P V of
//   this one, and runs the next tile's softmax (max, exp, sums) while the
//   P V product is in flight; only the O rescale and the P packing wait
//   for it. The two warpgroups may also take turns issuing (named
//   barriers, `pingpong`), so that one's softmax runs under the other's
//   products: the wrapper turns this on at D 64, where it measured
//   faster, and off at D 128, where it measured slower.
// - Persistence: the producer loads the next tile's Q once both
//   consumers are past their last S product of this one, and its K/V as
//   stages free up, so a tile's start and its epilogue are hidden. The
//   tiles are walked by heads in groups whose K/V fit in half the L2
//   (24 MiB), in a group the q tiles longest first across its heads;
//   block b takes the walk's rounds in a snake (b, then 2G - 1 - b, ..),
//   so a long causal tile is paired with a short one, and the heads' K/V
//   are read from memory about once.
// - The epilogue writes O / l in bf16 into the warpgroup's rows of an O
//   buffer (swizzled, bank-conflict free) and one TMA store per 64-wide
//   box writes them out (rows past S are not written); lse = m + log l
//   goes out in fp32.
// - TMA needs 16-byte aligned bases: the wrapper copies an input that is
//   not (a view at an odd offset) into a fresh tensor.
//
// Flash-attention backward for Hopper (sm_90a): one single-pass kernel
// (flash_bwd_tma_kernel, entry dstpu_flash_bwd) and the delta reduction
// before it (flash_bwd_delta_kernel, entry dstpu_flash_bwd_delta).
//
// Replaces the Pallas backward of the same file: _flash_bwd (:257) ->
// _bwd_fused_kernel (:192), whose structure it computes, and the chunked
// long-S form _flash_bwd_chunked (:457) -> _bwd_dkv_kernel_chunked (:405)
// and _bwd_dq_kernel_chunked (:367): K/V and Q stream in tiles for any S.
// Per score tile it follows _bwd_ds_block (:96): fp32 scores,
// p = exp(scale*q.k - lse), dp = do.v^T, ds = p*(dp - delta), p and ds
// rounded to bf16 before their products. delta = rowsum(do*o) is computed
// outside, as in JAX (:260), by the delta kernel: one pass over the two
// bf16 tensors, 16 bytes a thread, fp32 sums.
//
// What bounds it on the H100: the tensor cores. Each (q, key) pair of a
// head costs 5 products of 2*D flops (S^T, dP^T, dV, dK, dQ) when its
// score and exp are computed once; at GPT-2 large's training shape
// (B*H = 160, S = 1024, D = 64, causal) that is 54 us of bf16 tensor time
// against ~30 us of bytes. Around it: each q tile's Q and dO are read
// again by every key tile's item, and each (q tile, key tile) pair adds a
// 64 x D fp32 dq part in L2 (2 bytes a pair each at 128-key items); on an
// H100 those two streams, not the products, set the kernel's time
// (tests/perf/torch_kernel_ablate.py, PERF.md).
//
// What the design does about it:
// - One pass per (b*h, 128-key tile) work item: the scores and their exp
//   are computed once (5 products a tile pair, where a split into a
//   dk/dv and a dq kernel needs 7 and two exps). A block of 384 threads,
//   one an SM (persistent), walks the items in groups of heads whose Q,
//   dO and fp32 dq sums fit in half the L2 (24 MiB), in a group key tile
//   by key tile across its heads, so under causal masking the longest
//   items (key tile 0) come first; block b takes the walk's rounds in a
//   snake, as the forward does. An item visits its q tiles from the last down to the
//   diagonal (tiles above it are never loaded).
// - Warpgroup 0: warp 0 loads by TMA the item's K and V tile once (3-D
//   maps over [B*H, S, D]: rows past S read zeros) and, into a ring, the
//   q tiles' Q and dO (64 rows), its 32 lanes copying the tile's lse and
//   delta beside them (cp.async, completing on the same mbarrier); warps
//   1 .. 3 write dQ (below). setmaxnreg hands their registers to the
//   consumers.
// - Warpgroups 1 and 2 own 64 keys each and keep dK and dV (64 x D fp32)
//   in registers over the item. S^T = K Q^T and dP^T = V dO^T are wgmma
//   m64n64 products with both operands K-major in shared memory, so P^T
//   and dS^T come out in the accumulator layout, which is the A layout of
//   dV += P^T dO and dK += dS^T Q (wgmma with A from registers; dO and Q
//   are the MN-major B operands as stored, like V in the forward). Only
//   the diagonal tiles and the ragged tails are masked, to the
//   reference's -1e30 (p = 0).
// - dQ = dS K: both warpgroups also write dS^T into a swizzled shared
//   buffer ([128 keys][64 q], double-buffered), where it is the MN-major A
//   operand; the q tile's dQ boxes of 64 columns are split between the
//   warpgroups (box b of the block's t-th tile to warpgroup (t + b) % 2),
//   so no partial is summed in registers. Each writes its fp32 box into
//   one of 3 (D 64) or 2 (D 128) staging tiles, in its accumulator order.
// - dq is fp32 and deterministic: a (b*h, q tile) has an fp32 accumulator
//   in global memory and a counter (zeroed by the wrapper), and its key
//   tiles add to it in ascending order. Warp 1 + s serves staging tile s:
//   it waits until the counter equals its key tile, then the first key
//   tile stores (no memset of the accumulators) and the others add by a
//   bulk fp32 reduce; once the add is complete the counter is released
//   (bulk operations are per thread, so the writers' adds overlap). The
//   last contributor (the diagonal key tile under causal masking, else
//   the last one) loads the sum back into its staging tile and its warp
//   writes dq = scale * sum in bf16: no post-pass, and no consumer ever
//   waits on another block. A wait only points to an item of smaller walk
//   index, so the persistent grid cannot deadlock (ops/cuda/
//   flash_attention.py bwd_dq_waits, CPU-tested); descending q tiles let
//   a key tile's item follow its predecessor's step for step when both
//   run at once.
// - dK (times scale) and dV go out in bf16 from registers at the item's
//   end, rows past S not written.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- the forward: TMA-fed, warp-specialised wgmma ---------------------------

constexpr int FQ = 128;       // q rows a block: two consumer warpgroups of 64
constexpr int FN = 128;       // keys a K/V tile
constexpr int F_THREADS = 384;
constexpr int BOX_ROW = 128;  // bytes of one row of a 64-wide bf16 box
// named barriers: the consumers' turns (1, 2), each one's epilogue (3, 4)
constexpr int BAR_TURN = 1, BAR_EPI = 3;
// the K/V bytes of the heads whose q tiles are walked together (half the
// H100's 50 MB L2)
constexpr long long L2_GROUP_BYTES = 24LL << 20;

// shared memory of the forward at head dim D: Q, the epilogue's O, then
// KST K tiles and VST V tiles, each a row of D / 64 boxes of [rows][64],
// then the mbarriers; ops/cuda/flash_attention.py fwd_geometry mirrors it.
// At D 128 the V ring is the deeper one: V of tile j + 2 waits for the
// P V product of tile j, K of tile j + 2 only for S of tile j.
template <int D>
struct FwdCfg {
  static constexpr int DB = D / 64;
  static constexpr int Q_BYTES = FQ * D * 2;
  static constexpr int KV_BYTES = FN * D * 2;
  static constexpr int KST = D == 64 ? 4 : 2, VST = D == 64 ? 4 : 3;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + (KST + VST) * KV_BYTES + 256;
};

struct FwdMaps {
  CUtensorMap q, k, v, o;   // [B*H, S, D] q and o, [B*Hkv, S, D] k and v
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online softmax for this thread's two rows r0, r0 + 8 over
// the S accumulator s (raw q.k, the wgmma layout), in place: masked scores
// to -1e30 (MASK: the diagonal or tail tile), the running max m (raw
// units), alpha = the old sum's rescale, s = exp(scale (s - m)) and the
// partial sums l. It touches neither O nor P, so it runs while the
// previous tile's P.V product is in flight.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[FN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int r0, int S, int causal,
                                             float c) {
  const int t4 = threadIdx.x & 3;
  if (MASK) {
#pragma unroll
    for (int j = 0; j < FN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = r0 + (e & 2) * 4;
        if (key >= S || (causal && key > row)) s[4 * j + e] = -1e30f;
      }
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < FN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  alpha[0] = ex2((m[0] - mx0) * c);
  alpha[1] = ex2((m[1] - mx1) * c);
  m[0] = mx0;
  m[1] = mx1;
  const float mc0 = mx0 * c, mc1 = mx1 * c;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < FN / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, -mc0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mc0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mc1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mc1));
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l[0] = l[0] * alpha[0] + ps0;
  l[1] = l[1] * alpha[1] + ps1;
}

// once the previous P.V is done: O *= alpha, and P = the tile's exp values
// rounded to bf16, re-packed as the A fragments of the next P.V (k16 step
// kk is S columns 16 kk .. + 15: accumulators 8 kk .. 8 kk + 7)
template <int D>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2],
                                             uint32_t (&p)[FN / 16][4],
                                             const float (&s)[FN / 2],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < FN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_f32(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// S = Q K^T: D / 16 k16 steps over Q's (this warpgroup's 64 rows) and a K
// tile's boxes, both K-major
template <int D>
__device__ __forceinline__ void issue_s(float (&sacc)[FN / 2],
                                        const unsigned char* qa,
                                        const unsigned char* kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    sm90::wgmma_ss<FN, 0, 0>(
        sacc, sm90::wgmma_desc(qa + box * FQ * BOX_ROW + off, 16, 1024),
        sm90::wgmma_desc(kb + box * FN * BOX_ROW + off, 16, 1024), kk > 0);
  }
}

// O += P V: FN / 16 k16 steps over the keys, P from registers, V
// MN-major ([keys][64 d] boxes FN * 128 bytes apart)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&p)[FN / 16][4],
                                         const unsigned char* vb) {
#pragma unroll
  for (int kk = 0; kk < FN / 16; ++kk)
    sm90::wgmma_rs<D, 1>(
        o, p[kk], sm90::wgmma_desc(vb + kk * 2048, FN * BOX_ROW, 1024), 1);
}

template <int D>
__device__ __forceinline__ void fence_all(float (&sacc)[FN / 2],
                                          float (&o)[D / 2],
                                          uint32_t (&p)[FN / 16][4]) {
  sm90::fence_regs(sacc);
  sm90::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < FN / 16; ++kk) sm90::fence_regs(p[kk]);
}

__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(bar);
}

// the walk's tile w: groups of `group` heads whose K/V stay in L2
// together, in each group the q tiles longest first across its heads
struct FwdTile {
  int bh, q0, n_kt;
};

__device__ __forceinline__ FwdTile fwd_tile(int w, int BH, int S, int group,
                                            int causal) {
  const int n_qt = (S + FQ - 1) / FQ;
  const int gi = w / (group * n_qt), j = w % (group * n_qt);
  const int gsize = min(group, BH - gi * group);
  FwdTile t;
  t.bh = gi * group + j % gsize;
  t.q0 = (n_qt - 1 - j / gsize) * FQ;
  const int kv_end = causal ? min(S, t.q0 + FQ) : S;
  t.n_kt = (kv_end + FN - 1) / FN;
  return t;
}

// the walk index of block b's r-th tile: rounds of gridDim.x tiles, every
// other round in reverse, so that a block that took a long tile in one
// round takes a short one in the next
__device__ __forceinline__ int snake(int r) {
  const int G = gridDim.x, b = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - b : b);
}

// o [B, H, S, D] bf16 and lse [B, H, S] fp32, persistent: block b takes the
// walk's tiles snake(0), snake(1), .. (a tile is 128 q rows of one b*h).
// Warpgroup 0 is the producer, warpgroups 1 and 2 the consumers of q rows
// q0 .. q0 + 63 and q0 + 64 .. q0 + 127. The producer loads the next
// tile's Q once both consumers are past their last S product of this one,
// and its K/V as ring stages free up, while they finish the tile. PP: the
// consumers take turns issuing their products (named barriers BAR_TURN +
// h), so that one's softmax runs under the other's products.
template <int D, bool PP>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_fwd_tma_kernel(const __grid_constant__ FwdMaps maps,
                         float* __restrict__ lse, int BH, int H, int Hkv,
                         int S, int group, float scale, int causal) {
  using C = FwdCfg<D>;
  constexpr int KST = C::KST, VST = C::VST, DB = C::DB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* os = qs + C::Q_BYTES;
  unsigned char* ks = os + C::Q_BYTES;
  unsigned char* vs = ks + KST * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + VST * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;
  uint64_t* v_empty = v_full + VST;
  const int tiles = (S + FQ - 1) / FQ * BH;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);          // the producer's expect_tx
    sm90::mbar_init(q_empty, 8);         // lane 0 of each consumer warp
    for (int s = 0; s < KST; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);
    }
    for (int s = 0; s < VST; ++s) {
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    sm90::tma_prefetch_map(&maps.q);
    sm90::tma_prefetch_map(&maps.k);
    sm90::tma_prefetch_map(&maps.v);
    int it = 0;                // K/V tiles loaded so far
    for (int qi = 0; snake(qi) < tiles; ++qi) {
      const FwdTile t = fwd_tile(snake(qi), BH, S, group, causal);
      const int b = t.bh / H, h = t.bh % H;
      const int kvh = b * Hkv + h / (H / Hkv);
      sm90::mbar_wait(q_empty, (qi & 1) ^ 1);
      sm90::mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < DB; ++j)
        sm90::tma_load_3d(qs + j * FQ * BOX_ROW, &maps.q, 64 * j, t.q0,
                          t.bh, q_full);
      for (int kt = 0; kt < t.n_kt; ++kt, ++it) {
        const int ks_ = it % KST, vs_ = it % VST;
        sm90::mbar_wait(&k_empty[ks_], ((it / KST) & 1) ^ 1);
        sm90::mbar_expect_tx(&k_full[ks_], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < DB; ++j)
          sm90::tma_load_3d(ks + ks_ * C::KV_BYTES + j * FN * BOX_ROW,
                            &maps.k, 64 * j, kt * FN, kvh, &k_full[ks_]);
        sm90::mbar_wait(&v_empty[vs_], ((it / VST) & 1) ^ 1);
        sm90::mbar_expect_tx(&v_full[vs_], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < DB; ++j)
          sm90::tma_load_3d(vs + vs_ * C::KV_BYTES + j * FN * BOX_ROW,
                            &maps.v, 64 * j, kt * FN, kvh, &v_full[vs_]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int half = wg - 1;                 // q rows q0 + 64 half ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const float c = scale * 1.4426950408889634f;   // scale * log2(e)
  const unsigned char* qa = qs + half * 64 * BOX_ROW;
  float sacc[FN / 2], o[D / 2], alpha[2];
  uint32_t p[FN / 16][4];
  // the turns (PP): warpgroup 0 first; each passes the turn on after its
  // products are issued, but for warpgroup 1's very last
  if (PP && half == 1) sm90::bar_arrive(BAR_TURN, 256);
  auto pass_turn = [&](bool last) {
    if (PP && !(half == 1 && last))
      sm90::bar_arrive(BAR_TURN + 1 - half, 256);
  };

  int it = 0;
  for (int qi = 0; snake(qi) < tiles; ++qi) {
    const FwdTile t = fwd_tile(snake(qi), BH, S, group, causal);
    const bool last_tile = snake(qi + 1) >= tiles;
    const int n_kt = t.n_kt;
    const int r0 = t.q0 + 64 * half + 16 * warp + g;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    sm90::mbar_wait(q_full, qi & 1);
    sm90::mbar_wait(&k_full[it % KST], (it / KST) & 1);
    if (PP) sm90::bar_sync(BAR_TURN + half, 256);
    fence_all<D>(sacc, o, p);
    sm90::wgmma_fence();
    issue_s<D>(sacc, qa, ks + (it % KST) * C::KV_BYTES);
    sm90::wgmma_commit();
    pass_turn(false);
    sm90::wgmma_wait<0>();
    fence_all<D>(sacc, o, p);
    release(&k_empty[it % KST]);
    if (n_kt == 1) release(q_empty);      // this tile's last S product
    if (n_kt == 1)
      softmax_tile<true>(sacc, m, l, alpha, 0, r0, S, causal, c);
    else
      softmax_tile<false>(sacc, m, l, alpha, 0, r0, S, causal, c);
    rescale_pack<D>(o, p, sacc, alpha);

    // key tile kt: S of kt + 1 and O += P V of kt issued together; the
    // softmax of kt + 1 runs while the P V product is in flight
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const bool more = kt + 1 < n_kt;
      const int s = it % VST, s1 = (it + 1) % KST;
      sm90::mbar_wait(&v_full[s], (it / VST) & 1);
      if (more) sm90::mbar_wait(&k_full[s1], ((it + 1) / KST) & 1);
      if (PP) sm90::bar_sync(BAR_TURN + half, 256);
      fence_all<D>(sacc, o, p);
      sm90::wgmma_fence();
      if (more) {
        issue_s<D>(sacc, qa, ks + s1 * C::KV_BYTES);
        sm90::wgmma_commit();
      }
      issue_pv<D>(o, p, vs + s * C::KV_BYTES);
      sm90::wgmma_commit();
      pass_turn(last_tile && !more);
      if (more) {
        sm90::wgmma_wait<1>();     // S of kt + 1 (P V may still run)
        sm90::fence_regs(sacc);
        release(&k_empty[s1]);
        if (kt + 2 == n_kt) {
          release(q_empty);        // this tile's last S product
          softmax_tile<true>(sacc, m, l, alpha, (kt + 1) * FN, r0, S, causal,
                             c);
        } else {
          softmax_tile<false>(sacc, m, l, alpha, (kt + 1) * FN, r0, S,
                              causal, c);
        }
      }
      sm90::wgmma_wait<0>();
      fence_all<D>(sacc, o, p);
      release(&v_empty[s]);
      if (more) rescale_pack<D>(o, p, sacc, alpha);
    }

    // epilogue: O / l in bf16 into this warpgroup's rows of the O boxes,
    // in the 128-byte swizzle the o map's TMA store reads (bank-conflict
    // free), once the previous tile's store has read them; lse in fp32
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
    }
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
    if (leader) sm90::tma_store_wait_read();
    sm90::bar_sync(BAR_EPI + half, 128);
    const int rr = half * 64 + 16 * warp + g;   // row in the O boxes
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* row = os + (j / 8) * FQ * BOX_ROW + rr * BOX_ROW + 4 * t4;
      const int chunk = ((j % 8) ^ g) << 4;   // rr and rr + 8 share rr & 7
      *reinterpret_cast<uint32_t*>(row + chunk) =
          pack_f32(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(row + 8 * BOX_ROW + chunk) =
          pack_f32(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (t4 == 0) {
      float* lp = lse + (size_t)t.bh * S;
      if (r0 < S) lp[r0] = m[0] * scale + logf(l[0]);
      if (r0 + 8 < S) lp[r0 + 8] = m[1] * scale + logf(l[1]);
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(BAR_EPI + half, 128);
    if (leader && t.q0 + 64 * half < S) {
#pragma unroll
      for (int j = 0; j < DB; ++j)
        sm90::tma_store_3d(&maps.o,
                           os + j * FQ * BOX_ROW + half * 64 * BOX_ROW,
                           64 * j, t.q0 + 64 * half, t.bh);
      sm90::tma_store_commit();
    }
  }
  if (leader) sm90::tma_store_wait_read();
}

// q/o [BH, S, D] and k/v [BHkv, S, D] as 3-D maps: a box past S reads
// zeros (and a store writes nothing there), never the next head's rows
template <int D>
cudaError_t encode_fwd(FwdMaps* maps, const void* q, const void* k,
                       const void* v, const void* o, int BH, int BHkv,
                       int S) {
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint64_t dq[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t dkv[3] = {(cuuint64_t)D, (cuuint64_t)S,
                             (cuuint64_t)BHkv};
  const cuuint32_t box_q[3] = {64, FQ, 1}, box_kv[3] = {64, FN, 1},
                   box_o[3] = {64, 64, 1};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = sm90::encode_tiled(&maps->q, bf, 3, q, dq, strides, box_q);
  if (e == cudaSuccess)
    e = sm90::encode_tiled(&maps->k, bf, 3, k, dkv, strides, box_kv);
  if (e == cudaSuccess)
    e = sm90::encode_tiled(&maps->v, bf, 3, v, dkv, strides, box_kv);
  if (e == cudaSuccess)
    e = sm90::encode_tiled(&maps->o, bf, 3, o, dq, strides, box_o);
  return e;
}

template <int D, bool PP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int BH, int H, int Hkv, int S, float scale,
                       int causal, cudaStream_t st) {
  FwdMaps maps;
  cudaError_t e = encode_fwd<D>(&maps, q, k, v, o, BH, BH / H * Hkv, S);
  if (e != cudaSuccess) return e;
  auto kernel = flash_fwd_tma_kernel<D, PP>;
  static bool allowed = false;     // one attribute call a kernel a process
  if (!allowed) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FwdCfg<D>::SMEM);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  // heads a group: all when their K/V fit in L2_GROUP_BYTES, else the
  // most that fit and are a multiple of grid / gcd(grid, q tiles), so that
  // each group spans whole rounds of the snake (ops/cuda/
  // flash_attention.py fwd_geometry mirrors it)
  const int n_qt = (S + FQ - 1) / FQ, tiles = n_qt * BH;
  const int sms = sm90::sm_count(), grid = tiles < sms ? tiles : sms;
  const long long kv_head = 4LL * S * D * Hkv / H;
  const long long fit = L2_GROUP_BYTES / (kv_head > 0 ? kv_head : 1);
  int a = grid, b = n_qt;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int unit = grid / a;
  const int group = fit >= BH ? BH
                    : fit >= unit ? (int)(fit / unit * unit)
                    : (int)(fit < 1 ? 1 : fit);
  kernel<<<grid, F_THREADS, FwdCfg<D>::SMEM, st>>>(
      maps, lse, BH, H, Hkv, S, group, scale, causal);
  return cudaGetLastError();
}

// -- the backward: one pass, TMA-fed, warp-specialised wgmma ---------------

constexpr int BQ = 64;          // q rows a q tile
constexpr int BN = 128;         // keys a work item: two consumer warpgroups
constexpr int B_THREADS = 384;
// named barrier: both consumers' dS^T written
constexpr int BAR_DS = 1;
// registers a thread after setmaxnreg: warpgroup 0, the consumers
constexpr int BWD_P_REGS = 40, BWD_C_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of the backward at head dim D: KVST (K, V) tile pairs,
// QST (Q, dO) tile pairs, two dS^T buffers, DQST dQ staging tiles, QST
// (lse, delta) rows of 64, then the mbarriers (256 bytes); every tile a
// row
// of D / 64 boxes of [rows][64], 1024-byte aligned. ops/cuda/
// flash_attention.py bwd_geometry mirrors it.
template <int D>
struct BwdCfg {
  static constexpr int DB = D / 64;
  static constexpr int KV_BYTES = BN * D * 2;   // one K or V tile
  static constexpr int QT_BYTES = BQ * D * 2;   // one Q or dO tile
  static constexpr int DS_BYTES = BN * BQ * 2;  // dS^T, [128 keys][64 q]
  static constexpr int DQ_BYTES = BQ * D * 4;   // a q tile's fp32 dQ part
  static constexpr int LD_BYTES = 2 * BQ * 4;   // lse, delta
  static constexpr int KVST = D == 64 ? 2 : 1, QST = D == 64 ? 4 : 2;
  static constexpr int DQST = D == 64 ? 3 : 2;
  static constexpr int SMEM = 1024 + KVST * 2 * KV_BYTES +
                              QST * 2 * QT_BYTES + 2 * DS_BYTES +
                              DQST * DQ_BYTES + QST * LD_BYTES + 256;
};

struct BwdMaps {
  CUtensorMap q, k, v, dout;   // [B*H, S, D] each
};

// p = exp(scale q.k - lse) and ds = p (dp - delta) in place over this
// thread's part of a tile pair: s holds S^T (raw q.k), dp holds dP^T, both
// [64 keys x 64 q] in the wgmma accumulator layout; lsd the q tile's lse
// (0 .. 63) and delta (64 .. 127); c = scale * log2 e. MASK: p = 0 where the key
// is past S, the query is past S, or (causal) the key is past the query.
template <bool MASK>
__device__ __forceinline__ void bwd_p_ds(float (&s)[32], float (&dp)[32],
                                         const float* lsd, int key0, int q0,
                                         int S, int causal, float c) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 ls = *reinterpret_cast<const float2*>(lsd + col);
    const float2 dl = *reinterpret_cast<const float2*>(lsd + BQ + col);
    const float l0 = ls.x * LOG2E, l1 = ls.y * LOG2E;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * h + e;
        float p = ex2(fmaf(s[x], c, -(e ? l1 : l0)));
        if (MASK) {
          const int key = key0 + 8 * h, q = q0 + col + e;
          if (key >= S || q >= S || (causal && key > q)) p = 0.f;
        }
        s[x] = p;
        dp[x] = p * (dp[x] - (e ? dl.y : dl.x));
      }
  }
}

// S^T = K Q^T and dP^T = V dO^T over warpgroup `half`'s 64 keys of the K
// and V tiles (kb, vb) and a Q and dO tile (qb, dob): both operands
// K-major, D / 16 k16 steps, 64-wide boxes of 128 (K/V) or 64 (Q/dO) rows
template <int D>
__device__ __forceinline__ void bwd_issue_sdp(float (&s)[32], float (&dp)[32],
                                              const unsigned char* kb,
                                              const unsigned char* vb,
                                              const unsigned char* qb,
                                              const unsigned char* dob,
                                              int half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off =
        (kk / 4) * BN * BOX_ROW + 64 * half * BOX_ROW + (kk % 4) * 32;
    const int qoff = (kk / 4) * BQ * BOX_ROW + (kk % 4) * 32;
    sm90::wgmma_ss<64, 0, 0>(s, sm90::wgmma_desc(kb + off, 16, 1024),
                             sm90::wgmma_desc(qb + qoff, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off =
        (kk / 4) * BN * BOX_ROW + 64 * half * BOX_ROW + (kk % 4) * 32;
    const int qoff = (kk / 4) * BQ * BOX_ROW + (kk % 4) * 32;
    sm90::wgmma_ss<64, 0, 0>(dp, sm90::wgmma_desc(vb + off, 16, 1024),
                             sm90::wgmma_desc(dob + qoff, 16, 1024), kk > 0);
  }
}

// dV += P^T dO and dK += dS^T Q: A from registers (4 k16 steps over the
// 64 q), dO and Q MN-major ([64 q][64 d] boxes BQ * 128 bytes apart)
template <int D>
__device__ __forceinline__ void bwd_issue_dkv(float (&dk)[D / 2],
                                              float (&dv)[D / 2],
                                              uint32_t (&pf)[4][4],
                                              uint32_t (&df)[4][4],
                                              const unsigned char* qb,
                                              const unsigned char* dob) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D, 1>(
        dv, pf[kk], sm90::wgmma_desc(dob + kk * 2048, BQ * BOX_ROW, 1024), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D, 1>(
        dk, df[kk], sm90::wgmma_desc(qb + kk * 2048, BQ * BOX_ROW, 1024), 1);
}

// a dQ box (64 q x 64 d) = dS K[:, box] over the 128 keys: A is dS^T
// ([128 keys][64 q]) read MN-major, B the K tile's box, MN-major
__device__ __forceinline__ void bwd_issue_dq(float (&dq)[32],
                                             const unsigned char* dsb,
                                             const unsigned char* kbox) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    sm90::wgmma_ss<64, 1, 1>(
        dq, sm90::wgmma_desc(dsb + kk * 2048, 8192, 1024),
        sm90::wgmma_desc(kbox + kk * 2048, BN * BOX_ROW, 1024), kk > 0);
}

// wait until the q tile's counter says key tiles 0 .. kt - 1 have added
// their dq parts (the walk proves this finite; a wait that outlasts
// seconds traps, a launch failure the wrapper raises, not a hang)
__device__ __forceinline__ void wait_count(const int* cnt, int kt) {
  for (long long n = 0; sm90::ld_acquire(cnt) != kt; ++n) {
    if (n > (1LL << 26)) __trap();
    __nanosleep(64);
  }
}

// the walk's item w: heads in groups of `group` whose Q, dO and dq sums
// stay in L2 together, in a group key tile by key tile across its heads,
// so that under causal masking the longest items (key tile 0) come first
// and an item's dq predecessor (the same head's previous key tile) is the
// group's size earlier in the walk
__device__ __forceinline__ void bwd_item(int w, int BH, int n_kt, int group,
                                         int& bh, int& kt) {
  const int gi = w / (group * n_kt), j = w - gi * group * n_kt;
  const int gsize = min(group, BH - gi * group);
  kt = j / gsize;
  bh = gi * group + j - kt * gsize;
}

// dq [B*H, S, D], dk and dv [B*H, S, D] bf16 from q, k, v, do (maps), lse
// and delta [B*H, S] fp32; dq_acc [B*H, q tiles, 64 * D] fp32 scratch and
// counters [B*H, q tiles] int32, zero at launch. Persistent: block b takes
// the walk's items (bwd_item, heads in groups of `group`) snake(0),
// snake(1), ..
template <int D>
__global__ void __launch_bounds__(B_THREADS, 1)
    flash_bwd_tma_kernel(const __grid_constant__ BwdMaps maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ dq_acc,
                         int* __restrict__ counters, int BH, int S,
                         int group, float scale, int causal) {
  using C = BwdCfg<D>;
  constexpr int DB = C::DB, KVST = C::KVST, QST = C::QST, DQST = C::DQST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kvs = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* qs = kvs + KVST * 2 * C::KV_BYTES;
  unsigned char* dss = qs + QST * 2 * C::QT_BYTES;
  unsigned char* dqs = dss + 2 * C::DS_BYTES;
  float* lds = reinterpret_cast<float*>(dqs + DQST * C::DQ_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(lds) + QST * C::LD_BYTES);
  uint64_t* kv_empty = kv_full + KVST;
  uint64_t* q_full = kv_empty + KVST;
  uint64_t* q_empty = q_full + QST;
  uint64_t* dq_full = q_empty + QST;
  uint64_t* dq_empty = dq_full + DQST;
  uint64_t* dq_sum = dq_empty + DQST;
  static_assert((2 * (KVST + QST) + 3 * DQST) * 8 <= 256, "mbarriers");
  const int n_qt = (S + BQ - 1) / BQ, n_kt = (S + BN - 1) / BN;
  const int items = n_kt * BH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KVST; ++s) {
      sm90::mbar_init(&kv_full[s], 1);    // the producer's expect_tx
      sm90::mbar_init(&kv_empty[s], 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < QST; ++s) {
      sm90::mbar_init(&q_full[s], 33);    // expect_tx + warp 0's copies
      sm90::mbar_init(&q_empty[s], 8);
    }
    for (int s = 0; s < DQST; ++s) {
      sm90::mbar_init(&dq_full[s], 8);    // lane 0 of each consumer warp
      sm90::mbar_init(&dq_empty[s], 1);   // its dQ writer
      sm90::mbar_init(&dq_sum[s], 1);     // its writer's expect_tx
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    sm90::setmaxnreg_dec<BWD_P_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0) {
      // the loads: K, V once an item; Q, dO, lse, delta a q tile
      if (lane == 0) {
        sm90::tma_prefetch_map(&maps.q);
        sm90::tma_prefetch_map(&maps.k);
        sm90::tma_prefetch_map(&maps.v);
        sm90::tma_prefetch_map(&maps.dout);
      }
      int it = 0, kit = 0;
      for (int r = 0; snake(r) < items; ++r, ++kit) {
        int bh, kt;
        bwd_item(snake(r), BH, n_kt, group, bh, kt);
        const int ks_ = kit % KVST;
        unsigned char* kb = kvs + ks_ * 2 * C::KV_BYTES;
        if (lane == 0) {
          sm90::mbar_wait(&kv_empty[ks_], ((kit / KVST) & 1) ^ 1);
          sm90::mbar_expect_tx(&kv_full[ks_], 2 * C::KV_BYTES);
#pragma unroll
          for (int j = 0; j < DB; ++j) {
            sm90::tma_load_3d(kb + j * BN * BOX_ROW, &maps.k, 64 * j,
                              kt * BN, bh, &kv_full[ks_]);
            sm90::tma_load_3d(kb + C::KV_BYTES + j * BN * BOX_ROW, &maps.v,
                              64 * j, kt * BN, bh, &kv_full[ks_]);
          }
        }
        for (int i = n_qt - 1; i >= (causal ? 2 * kt : 0); --i, ++it) {
          const int st = it % QST;
          unsigned char* qb = qs + st * 2 * C::QT_BYTES;
          sm90::mbar_wait(&q_empty[st], ((it / QST) & 1) ^ 1);
          if (lane == 0) {
            sm90::mbar_expect_tx(&q_full[st], 2 * C::QT_BYTES);
#pragma unroll
            for (int j = 0; j < DB; ++j) {
              sm90::tma_load_3d(qb + j * BQ * BOX_ROW, &maps.q, 64 * j,
                                i * BQ, bh, &q_full[st]);
              sm90::tma_load_3d(qb + C::QT_BYTES + j * BQ * BOX_ROW,
                                &maps.dout, 64 * j, i * BQ, bh, &q_full[st]);
            }
          }
          // lse and delta by asynchronous copies that complete on q_full
          // too (zeros past S), so this warp never waits on their loads
          float* ld = lds + st * (2 * BQ);
          const size_t row = (size_t)bh * S;
#pragma unroll
          for (int e = lane; e < BQ; e += 32) {
            const int q = i * BQ + e;
            const size_t at = row + (q < S ? q : 0);
            const uint32_t bytes = q < S ? 4 : 0;
            sm90::cp_async_4(ld + e, lse + at, bytes);
            sm90::cp_async_4(ld + BQ + e, delta + at, bytes);
          }
          sm90::cp_async_arrive(&q_full[st]);
        }
      }
      return;
    }
    // warps 1 .. DQST: the dQ writers, warp 1 + s taking the (item, q
    // tile) contributions that the consumers stage in tile s. Lane 0 adds
    // the tile once the key tiles before it have added theirs (bulk
    // operations are per thread, so the writers' adds are in flight
    // together) and releases the counter as soon as its add is complete.
    // The q tile's last contributor then loads the sum back into its
    // staging tile and the warp writes dq = scale * sum in bf16.
    if (warp > DQST) return;
    const int s = warp - 1;
    unsigned char* part = dqs + s * C::DQ_BYTES;
    int dit = 0, sums = 0;
    for (int r = 0; snake(r) < items; ++r) {
      int bh, kt;
      bwd_item(snake(r), BH, n_kt, group, bh, kt);
      for (int i = n_qt - 1; i >= (causal ? 2 * kt : 0); --i, ++dit) {
        if (dit % DQST != s) continue;
        sm90::mbar_wait(&dq_full[s], (dit / DQST) & 1);
        const bool last = kt == (causal ? i / 2 : n_kt - 1);
        float* acc = dq_acc + ((size_t)bh * n_qt + i) * (BQ * D);
        int* cnt = counters + (size_t)bh * n_qt + i;
        if (lane == 0 && (kt > 0 || !last)) {
          if (kt > 0) {
            wait_count(cnt, kt);
            sm90::fence_proxy_async_global();
            sm90::bulk_reduce_add_f32(acc, part, C::DQ_BYTES);
          } else {
            sm90::bulk_store(acc, part, C::DQ_BYTES);
          }
          sm90::tma_store_commit();
          sm90::bulk_wait();
          if (last) {
            sm90::mbar_expect_tx(&dq_sum[s], C::DQ_BYTES);
            sm90::bulk_load(part, acc, C::DQ_BYTES, &dq_sum[s]);
          } else {
            __threadfence();
            sm90::st_release(cnt, kt + 1);
          }
        }
        if (last) {
          if (kt > 0) sm90::mbar_wait(&dq_sum[s], sums++ & 1);
          // float4 c of the tile is (box, warp, fragment j, lane) of the
          // consumers' accumulators: rows 16 warp + lane / 4 (+ 8),
          // columns 64 box + 8 j + 2 (lane % 4)
          const float4* p4 = reinterpret_cast<const float4*>(part);
          const size_t base = (size_t)bh * S + (size_t)i * BQ;
          for (int c = lane; c < BQ * D / 4; c += 32) {
            const float4 x = p4[c];
            const int l = c & 31;
            const int row = 16 * ((c >> 8) & 3) + (l >> 2);
            const int col = 64 * (c >> 10) + 8 * ((c >> 5) & 7) + 2 * (l & 3);
            if (i * BQ + row < S)
              *reinterpret_cast<uint32_t*>(dq + (base + row) * D + col) =
                  pack_f32(x.x * scale, x.y * scale);
            if (i * BQ + row + 8 < S)
              *reinterpret_cast<uint32_t*>(dq + (base + row + 8) * D + col) =
                  pack_f32(x.z * scale, x.w * scale);
          }
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&dq_empty[s]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<BWD_C_REGS>();
  const int half = wg - 1;                 // keys k0 + 64 half ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float c = scale * LOG2E;
  float dka[D / 2], dva[D / 2], sacc[32], dpa[32], dqa[32];
  uint32_t pf[4][4], df[4][4];
  int it = 0, kit = 0, dit = 0;
  for (int r = 0; snake(r) < items; ++r, ++kit) {
    int bh, kt;
    bwd_item(snake(r), BH, n_kt, group, bh, kt);
    const int i0 = causal ? 2 * kt : 0;
    const int ks_ = kit % KVST;
    const unsigned char* kb = kvs + ks_ * 2 * C::KV_BYTES;
    const unsigned char* vb = kb + C::KV_BYTES;
    const int key0 = kt * BN + 64 * half + 16 * warp + g;  // and key0 + 8
    const bool tail_keys = (kt + 1) * BN > S;
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dka[x] = dva[x] = 0.f;
    sm90::mbar_wait(&kv_full[ks_], (kit / KVST) & 1);

    for (int i = n_qt - 1; i >= i0; --i, ++it, ++dit) {
      const int st = it % QST;
      const unsigned char* qb = qs + st * 2 * C::QT_BYTES;
      const unsigned char* dob = qb + C::QT_BYTES;
      const int q0 = i * BQ;
      sm90::mbar_wait(&q_full[st], (it / QST) & 1);

      sm90::fence_regs(sacc);
      sm90::fence_regs(dpa);
      sm90::wgmma_fence();
      bwd_issue_sdp<D>(sacc, dpa, kb, vb, qb, dob, half);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpa);

      const float* lsd = lds + st * (2 * BQ);
      if (tail_keys || (causal && i < i0 + 2) || q0 + BQ > S)
        bwd_p_ds<true>(sacc, dpa, lsd, key0, q0, S, causal, c);
      else
        bwd_p_ds<false>(sacc, dpa, lsd, key0, q0, S, causal, c);
      // P^T and dS^T in bf16 as A fragments (k16 step kk: q columns
      // 16 kk .. + 15, accumulators 8 kk .. 8 kk + 7)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pf[kk][x] = pack_f32(sacc[8 * kk + 2 * x], sacc[8 * kk + 2 * x + 1]);
          df[kk][x] = pack_f32(dpa[8 * kk + 2 * x], dpa[8 * kk + 2 * x + 1]);
        }

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::fence_regs(pf[kk]);
        sm90::fence_regs(df[kk]);
      }
      sm90::fence_regs(dka);
      sm90::fence_regs(dva);
      sm90::wgmma_fence();
      bwd_issue_dkv<D>(dka, dva, pf, df, qb, dob);
      sm90::wgmma_commit();

      // dS^T into its buffer: key row 64 half + 16 warp + g (+ 8), q
      // chunk j swizzled with the row (rows r and r + 8 share r & 7)
      // (buffers and dQ boxes alternate with the running tile count it,
      // so consecutive tiles never share a buffer, across items too)
      unsigned char* dsb = dss + (it & 1) * C::DS_BYTES;
      unsigned char* drow = dsb + (64 * half + 16 * warp + g) * BOX_ROW +
                            4 * t4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 2 * kk + (x >> 1);
          *reinterpret_cast<uint32_t*>(drow + (x & 1) * 8 * BOX_ROW +
                                       ((j ^ g) << 4)) = df[kk][x];
        }
      sm90::fence_proxy_async();
      sm90::bar_sync(BAR_DS, 256);   // both halves of dS^T are written

      // this warpgroup's dQ box of the tile, if any
      const int qbox = (half + it) & 1;
      if (qbox < DB) {
        sm90::fence_regs(dqa);
        sm90::wgmma_fence();
        bwd_issue_dq(dqa, dsb, kb + qbox * BN * BOX_ROW);
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::fence_regs(pf[kk]);
        sm90::fence_regs(df[kk]);
      }
      sm90::fence_regs(dka);
      sm90::fence_regs(dva);
      sm90::fence_regs(dqa);
      release(&q_empty[st]);
      if (i == i0) release(&kv_empty[ks_]);

      // the dQ box into the staging tile for the writer, in accumulator
      // order: float4 j of lane l of warp w of box b at (b, w, j, l)
      const int s = dit % DQST;
      sm90::mbar_wait(&dq_empty[s], ((dit / DQST) & 1) ^ 1);
      if (qbox < DB) {
        float4* dst = reinterpret_cast<float4*>(dqs + s * C::DQ_BYTES) +
                      qbox * 1024 + warp * 256 + lane;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[32 * j] = make_float4(dqa[4 * j], dqa[4 * j + 1],
                                    dqa[4 * j + 2], dqa[4 * j + 3]);
        sm90::fence_proxy_async();
      }
      __syncwarp();
      release(&dq_full[s]);
    }

    // dK = scale * sum dS^T Q and dV in bf16, rows past S not written
    const size_t kbase = (size_t)bh * S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= S) continue;
      bf16* dkr = dk + (kbase + key) * D + 2 * t4;
      bf16* dvr = dv + (kbase + key) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
            pack_f32(dka[4 * j + 2 * h] * scale,
                     dka[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j) =
            pack_f32(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// q, k, v, do [BH, S, D] as 3-D maps: a box past S reads zeros
template <int D>
cudaError_t encode_bwd(BwdMaps* maps, const void* q, const void* k,
                       const void* v, const void* dout, int BH, int S) {
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint32_t box_q[3] = {64, BQ, 1}, box_kv[3] = {64, BN, 1};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = sm90::encode_tiled(&maps->q, bf, 3, q, dims, strides, box_q);
  if (e == cudaSuccess)
    e = sm90::encode_tiled(&maps->k, bf, 3, k, dims, strides, box_kv);
  if (e == cudaSuccess)
    e = sm90::encode_tiled(&maps->v, bf, 3, v, dims, strides, box_kv);
  if (e == cudaSuccess)
    e = sm90::encode_tiled(&maps->dout, bf, 3, dout, dims, strides, box_q);
  return e;
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, bf16* dq, bf16* dk, bf16* dv,
                       float* dq_acc, int* counters, int BH, int S,
                       float scale, int causal, cudaStream_t st) {
  BwdMaps maps;
  cudaError_t e = encode_bwd<D>(&maps, q, k, v, dout, BH, S);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_tma_kernel<D>;
  static bool allowed = false;     // one attribute call a kernel a process
  if (!allowed) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BwdCfg<D>::SMEM);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  // heads a group: all when their Q, dO, lse, delta and fp32 dq sums fit
  // in L2_GROUP_BYTES, else the most that fit and are a multiple of
  // unit = grid / gcd(grid, key tiles), so that a group spans whole rounds
  // of the snake; unit heads if fewer fit but unit heads still fit in
  // twice that (the L2), else as many as fit (ops/cuda/
  // flash_attention.py bwd_geometry mirrors it)
  const int n_kt = (S + BN - 1) / BN, items = n_kt * BH;
  const int sms = sm90::sm_count(), grid = items < sms ? items : sms;
  const long long head = 8LL * S * D + 8LL * S;
  const long long fit = L2_GROUP_BYTES / head;
  int a = grid, b = n_kt;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int unit = grid / a;
  const int group = fit >= BH ? BH
                    : fit >= unit ? (int)(fit / unit * unit)
                    : unit * head <= 2 * L2_GROUP_BYTES ? unit
                    : (int)(fit < 1 ? 1 : fit);
  kernel<<<grid, B_THREADS, BwdCfg<D>::SMEM, st>>>(
      maps, lse, delta, dq, dk, dv, dq_acc, counters, BH, S, group, scale,
      causal);
  return cudaGetLastError();
}

// delta[r] = sum over d of do[r, d] o[r, d] in fp32, rows of D bf16: D / 8
// threads a row, 16 bytes each, summed across them by shuffles
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ dout,
                           float* __restrict__ delta, long long rows) {
  constexpr int T = D / 8;
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / T;
  const int part = threadIdx.x % T;
  float sum = 0.f;
  if (r < rows) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + r * D) + part);
    const uint4 b =
        __ldg(reinterpret_cast<const uint4*>(dout + r * D) + part);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 fa = __bfloat1622float2(a2[x]);
      const float2 fb = __bfloat1622float2(b2[x]);
      sum = fmaf(fa.x, fb.x, sum);
      sum = fmaf(fa.y, fb.y, sum);
    }
  }
#pragma unroll
  for (int m = T / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(kFull, sum, m);
  if (r < rows && part == 0) delta[r] = sum;
}

}  // namespace

// head dim D 64 or 128, every base 16-byte aligned (the wrapper checks);
// pingpong != 0: the consumer warpgroups take turns issuing their products
extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int BH, int H, int Hkv,
                               int S, int D, float scale, int causal,
                               int pingpong, void* stream) {
  if (BH < 1 || H < 1 || Hkv < 1 || H % Hkv || BH % H || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return pingpong ? (int)launch_fwd<64, true>(q, k, v, o, l, BH, H, Hkv, S,
                                                scale, causal, st)
                    : (int)launch_fwd<64, false>(q, k, v, o, l, BH, H, Hkv,
                                                 S, scale, causal, st);
  if (D == 128)
    return pingpong ? (int)launch_fwd<128, true>(q, k, v, o, l, BH, H, Hkv,
                                                 S, scale, causal, st)
                    : (int)launch_fwd<128, false>(q, k, v, o, l, BH, H, Hkv,
                                                  S, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// head dim D 64 or 128; q, k, v, do [BH, S, D] bf16 with 16-byte aligned
// bases, lse and delta [BH, S] fp32, dq_acc [BH, ceil(S / 64), 64 * D]
// fp32 scratch, counters [BH, ceil(S / 64)] int32 zeroed (the wrapper
// allocates them)
extern "C" int dstpu_flash_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, void* dq_acc, void* counters, int BH,
                               int S, int D, float scale, int causal,
                               void* stream) {
  if (BH < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  int* cnt = static_cast<int*>(counters);
  if (D == 64)
    return (int)launch_bwd<64>(q, k, v, dout, l, dl, (bf16*)dq, (bf16*)dk,
                               (bf16*)dv, acc, cnt, BH, S, scale, causal, st);
  if (D == 128)
    return (int)launch_bwd<128>(q, k, v, dout, l, dl, (bf16*)dq, (bf16*)dk,
                                (bf16*)dv, acc, cnt, BH, S, scale, causal,
                                st);
  return (int)cudaErrorInvalidValue;
}

// delta [rows] fp32 from o and do [rows, D] bf16 (16-byte aligned bases)
extern "C" int dstpu_flash_bwd_delta(const void* o, const void* dout,
                                     void* delta, int rows, int D,
                                     void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long threads = (long long)rows * (D / 8);
  const int blocks = (int)((threads + 255) / 256);
  if (D == 64)
    flash_bwd_delta_kernel<64><<<blocks, 256, 0, st>>>(
        (const bf16*)o, (const bf16*)dout, (float*)delta, rows);
  else if (D == 128)
    flash_bwd_delta_kernel<128><<<blocks, 256, 0, st>>>(
        (const bf16*)o, (const bf16*)dout, (float*)delta, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
