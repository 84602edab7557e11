// Block-sparse attention for Hopper (sm_90a): the forward, the dq pass and
// the dk/dv pass, bf16 in, fp32 softmax, head dim 64.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/blocksparse.py:
// _bs_fwd (:325, _bs_fwd_kernel :107) and both halves of _bs_bwd (:374,
// _bs_dq_kernel :187 and _bs_dkv_kernel :250). A static [H, nb, nb] block
// layout is given as per-row tables (the wrapper's counterparts of
// _layout_tables :48): counts[th][r] active k-blocks of q-block row r and
// their indices cols[th][r][0 .. counts - 1]; the dk/dv pass reads the same
// tables of the transposed layout (per k-block column, the q-blocks that
// attend to it). th = bh % TH: TH = H tables, or 1 when every head shares
// one layout.
//
// What bounds them on the H100: per listed (row, column) block pair the
// forward computes 2 products of block^2 * 64 multiply-adds (S, P.V), dq 3
// (S, dP, dQ) and dk/dv 4 (S^T, dP^T, dV, dK), 4, 6 and 8 block^2 * 64
// flops, over one [block, 64] K and V tile (or Q and dO). Each key tile is
// read once for each row tile that lists it, out of L2; at 64 rows a tile
// that is 128 flops a byte of L2 traffic. Beside the tensor cores, every
// score takes one exp on the SFU (16 a clock an SM): at head dim 64 the
// exps of a 64 x 64 step take as long as its two forward products.
//
// What the design does about it:
// - The TPU kernels' lane padding to 128, block-major copies, DMA
//   semaphores and grouped-row union tables are Mosaic's constraints and
//   are not carried over.
// - The host (ops/cuda/blocksparse.py TileWork) cuts the work into 64-row
//   tiles: up to 64 / block lines (q-block rows for the forward and dq,
//   k-block columns for dk/dv) of one table whose lists are the same, or
//   half a line of 128, sorted longest first; a persistent grid walks that
//   list (tile by tile, each over the B*H / TH heads that read its table,
//   so blocks that run together share a head's K/V in L2). At BERT's
//   layout (Fixed, block 16, S 4096) every q-block row lists 67 k-blocks
//   and four consecutive rows share a list: 1024 full tiles of 17 steps.
// - Forward and dq (bs_rows_tma_kernel<DQ>): a producer warp gathers the
//   tile's Q (dq: and dO, lse, delta) once, box by box by TMA, into a
//   double-buffered slot, and each step's 64 keys of K and V (64 / block
//   listed k-blocks, or half a k-block of 128) into a ring of stages; the
//   padded boxes of a short last step are read out of bounds (zeros) and
//   their scores masked. A consumer warpgroup owns the tile's 64 rows:
//   S = Q K^T (and dP = dO V^T) by wgmma m64n64k16 from shared memory,
//   both operands K-major; then P (dS) is rounded to bf16 in registers as
//   the A operand of O += P V (dQ += dS K), V (K) MN-major as staged. Each
//   step issues the next step's S (and dP) together with this step's P V
//   (dQ), and runs the next step's softmax (exp and dS) while that
//   product is in flight, as flash_attention.cu's forward does.
// - What chose it (an H100 at 700 W, BERT-large's layer: B 4, H 16, S
//   4096, the Fixed layout at block 16; tests/perf/torch_kernel_ablate.py
//   bsrows, µs forward / dq): this kernel 260 / 344, with loads alone 178
//   / 249, products alone 226 / 310, sync alone 48 / 54; 128-key steps
//   644 / 864 (n128 scores, a 2-deep ring, dq spills); the forward at two
//   blocks an SM 331, dq at three 608 (spills at 128 registers, also
//   with its dS moved after the dQ product: 558); two consumer
//   warpgroups a block taking turns, each on its own tile, 566 / 583.
//   So one consumer warpgroup a block, three blocks an SM for the
//   forward (120 registers) and two for dq (168).
// - dk/dv (bs_dkv_tma_kernel): the transposed lists are badly unbalanced
//   (DeepSpeed's Fixed layout at block 16: 64 of a head's 256 columns
//   list all 256 q-blocks, the rest 4), so the same work list over the
//   transposed tables sorts its 64-key tiles longest first. A producer
//   warp gathers each 64-row q step (Q, dO, lse and delta of 64 / block
//   listed q-blocks) by TMA into a 4-stage ring and the tile's K and V
//   into a 2-deep ring. One consumer warpgroup runs all four products on
//   the tensor cores (wgmma m64n64k16): with 64 keys as M a Q/dO step is
//   read once for four columns.
// - Every key of an active block is valid (S is a multiple of the block),
//   so only the padding of a tile's last step is masked. A row with no
//   active block gets o = 0 and lse = +1e30 (_bs_fwd_kernel :178-182), so
//   the backward's exp(s - lse) is 0, and dq = 0.
// - No atomics on the outputs, deterministic: the forward and dq walk the
//   rows' lists and dk/dv the columns' lists, as the Pallas kernels split
//   them; one block computes a tile whole, so a rerun is bit-equal. dk/dv
//   computes S^T = K.Q^T and dP^T = V.dO^T so that P^T and dS^T come out
//   in the A layout of the next product, as the flash backward does.
// - o, dk and dv are written in fp32 (the Pallas outputs' type: backward's
//   delta = rowsum(do * o) reads the unrounded o); dq in bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr float POS_INF = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int KT = 64;                      // rows (keys) a tile
constexpr int TILE_BYTES = KT * 128;        // [64][64] bf16, 128B swizzle
// a tile (ops/cuda/blocksparse.py TileWork): its table, row (key) offset
// in its lines (block 128), lines (1 .. 64 / block, one list), the lines,
// the list's length
constexpr int TILE_INTS = 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------ forward and dq (TMA, wgmma)

constexpr int RW_KN = 64;                   // keys a step
constexpr int RW_THREADS = 160;             // a consumer warpgroup + a warp
constexpr int RW_KV_BYTES = RW_KN * 128;    // K or V of a step

// blocks an SM and K/V stages: the forward's consumer (120 registers)
// fits three blocks of 3 stages, dq's (168) two of 4. Shared memory: two
// Q slots (Q; dq: dO, then lse and delta of the tile's 64 rows), the
// K/V stages (K, then V), the mbarriers (Q full / empty of each slot,
// then each stage's full / empty).
template <bool DQ>
struct RowCfg {
  static constexpr int CTAS = DQ ? 2 : 3;
  static constexpr int NST = DQ ? 4 : 3;
  static constexpr int Q_SLOT = DQ ? 2 * TILE_BYTES + 1024 : TILE_BYTES;
  static constexpr int BARS = 4 + 2 * NST;
  static constexpr int SMEM =
      1024 + 2 * Q_SLOT + NST * 2 * RW_KV_BYTES + BARS * 8;
};

struct RowMaps {
  CUtensorMap q, k, v, dout;   // [BH * S, 64] bf16, boxes [piece][64]
};

// work item w: tile w / rep of the list, for head (w % rep) * TH + table,
// in steps of RW_KN keys of its list's blocks
struct RowItem {
  const int* tile;
  int bh, steps;
};

__device__ __forceinline__ RowItem row_item(const int* tiles, int w,
                                            int rep, int TH, int block) {
  RowItem it;
  it.tile = tiles + (w / rep) * TILE_INTS;
  it.bh = (w % rep) * TH + it.tile[0];
  it.steps = (it.tile[7] * block + RW_KN - 1) / RW_KN;
  return it;
}

// S = A B^T over head dim 64: 4 k16 steps, both operands K-major (64 rows
// of A, N rows of B)
template <int N>
__device__ __forceinline__ void rw_issue_abt(float (&acc)[N / 2],
                                             const unsigned char* a,
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss<N, 0, 0>(acc, sm90::wgmma_desc(a + kk * 32, 16, 1024),
                            sm90::wgmma_desc(b + kk * 32, 16, 1024), kk > 0);
}

// acc (64 x 64) += X B for X (64 x N) from registers and B an N-row [keys]
// [64] stage tile read MN-major: O += P V, dQ += dS K
template <int N>
__device__ __forceinline__ void rw_issue_xb(float (&acc)[32],
                                            uint32_t (&x)[N / 16][4],
                                            const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    sm90::wgmma_rs<64, 1>(acc, x[kk],
                          sm90::wgmma_desc(b + kk * 2048, N * 128, 1024), 1);
}

// the accumulator x (64 x N) rounded to bf16 as A operands (k16 step kk:
// columns 16 kk .. + 15, accumulators 8 kk .. 8 kk + 7)
template <int N>
__device__ __forceinline__ void rw_pack(uint32_t (&x)[N / 16][4],
                                        const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[kk][i] = pack_f32(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rw_fence(uint32_t (&x)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) sm90::fence_regs(x[kk]);
}

// One step's online softmax for this thread's rows over the S accumulator
// s (raw q.k), in place: keys at or past `valid` (the padding of a short
// last step) to -1e30, the running max m (raw units), alpha = the old
// sum's rescale, s = exp(scale (s - m)) and the partial sums l (c = scale
// log2 e)
template <int N>
__device__ __forceinline__ void rw_softmax(float (&s)[N / 2], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           int valid, float c) {
  const int t4 = threadIdx.x & 3;
  if (valid < N) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t4 + (e & 1) >= valid) s[4 * j + e] = -1e30f;
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
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
  for (int j = 0; j < N / 8; ++j) {
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

// One step's dS for this thread's rows, in place in dp: p = exp(scale s -
// lse) (ls = lse log2 e, 0 at keys at or past `valid`), dS = p (dp -
// delta)
template <int N>
__device__ __forceinline__ void rw_ds(const float (&s)[N / 2],
                                      float (&dp)[N / 2], const float (&ls)[2],
                                      const float (&dl)[2], int valid,
                                      float c) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = 8 * j + 2 * t4 + (e & 1) < valid
                          ? ex2(fmaf(s[4 * j + e], c, -ls[h]))
                          : 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dl[h]);
    }
}

__device__ __forceinline__ void rw_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(bar);
}

// The forward (DQ false: o fp32 and lse) or dq (DQ true: bf16, from lse
// and delta) of the row work list, persistent: block b takes work items
// b, b + gridDim.x, ..; its producer warp loads each item's Q slot, then
// its steps into the ring, and its consumer warpgroup computes the item.
template <bool DQ>
__global__ void __launch_bounds__(RW_THREADS, RowCfg<DQ>::CTAS)
    bs_rows_tma_kernel(const __grid_constant__ RowMaps maps, float* lse,
                       const float* delta, const int* __restrict__ cols,
                       const int* __restrict__ tiles, float* __restrict__ o,
                       bf16* __restrict__ dq, int TH, int S, int block,
                       int max_nnz, int n_work, int rep, float scale) {
  using C = RowCfg<DQ>;
  constexpr int NST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* stages = smem + 2 * C::Q_SLOT;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages +
                                                 NST * 2 * RW_KV_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + NST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = S / block, piece = block < KT ? block : KT;
  const int rows = rep * TH * S;        // past the last row: a box of zeros
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&q_full[i], 1);
      sm90::mbar_init(&q_empty[i], 4);
    }
    for (int i = 0; i < NST; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], 4);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp: one lane issues
    if (lane != 0) return;
    sm90::tma_prefetch_map(&maps.q);
    sm90::tma_prefetch_map(&maps.k);
    sm90::tma_prefetch_map(&maps.v);
    if (DQ) sm90::tma_prefetch_map(&maps.dout);
    int qi = 0, it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const RowItem item = row_item(tiles, w, rep, TH, block);
      if (item.steps == 0) continue;
      const int* t = item.tile;
      // the tile's rows: Q (dq: dO, lse, delta), box by box
      const int slot = qi % 2, per = KT / piece, nl = t[2];
      sm90::mbar_wait(&q_empty[slot], ((qi / 2) & 1) ^ 1);
      sm90::mbar_expect_tx(&q_full[slot], (DQ ? 2 : 1) * TILE_BYTES +
                                              (DQ ? 2 * nl * piece * 4 : 0));
      unsigned char* qb = smem + slot * C::Q_SLOT;
      float* lsd = reinterpret_cast<float*>(qb + 2 * TILE_BYTES);
      for (int i = 0; i < per; ++i) {
        const int row = i < nl ? item.bh * S + t[3 + i] * block + t[1] : rows;
        sm90::tma_load_2d(qb + i * piece * 128, &maps.q, 0, row,
                          &q_full[slot]);
        if (DQ) {
          sm90::tma_load_2d(qb + TILE_BYTES + i * piece * 128, &maps.dout, 0,
                            row, &q_full[slot]);
          if (i < nl) {
            sm90::bulk_load(lsd + i * piece, lse + row, piece * 4,
                            &q_full[slot]);
            sm90::bulk_load(lsd + KT + i * piece, delta + row, piece * 4,
                            &q_full[slot]);
          }
        }
      }
      ++qi;
      // the steps: RW_KN keys of the list's blocks, box by box
      const int* list = cols + ((size_t)t[0] * nb + t[3]) * max_nnz;
      for (int r = 0; r < item.steps; ++r, ++it) {
        const int st = it % NST;
        sm90::mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * RW_KV_BYTES);
        unsigned char* kb = stages + st * 2 * RW_KV_BYTES;
        for (int i = 0; i < RW_KN / piece; ++i) {
          const int key = r * RW_KN + i * piece;   // in the list's keys
          const int j = key / block;
          const int row =
              j < t[7] ? item.bh * S + list[j] * block + key % block : rows;
          sm90::tma_load_2d(kb + i * piece * 128, &maps.k, 0, row, &full[st]);
          sm90::tma_load_2d(kb + RW_KV_BYTES + i * piece * 128, &maps.v, 0,
                            row, &full[st]);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w holds rows 16 w + g (+ 8) of a tile
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp + g;
  const float cs = scale * LOG2E;
  float acc[32], sacc[RW_KN / 2];
  float dpa[RW_KN / 2];
  uint32_t x[RW_KN / 16][4];
  int qi = 0, it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const RowItem me = row_item(tiles, w, rep, TH, block);
    const int steps = me.steps;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2];
    float ls[2], dl[2];
    if (steps > 0) {
      const int slot = qi % 2;
      const unsigned char* qa = smem + slot * C::Q_SLOT;
      const unsigned char* da = qa + TILE_BYTES;
      // keys of the last step that belong to the list
      const int last = me.tile[7] * block - (steps - 1) * RW_KN;
      sm90::mbar_wait(&q_full[slot], (qi / 2) & 1);
      if (DQ) {
        const float* lsd = reinterpret_cast<const float*>(qa + 2 * TILE_BYTES);
        ls[0] = lsd[r0] * LOG2E;
        ls[1] = lsd[r0 + 8] * LOG2E;
        dl[0] = lsd[KT + r0];
        dl[1] = lsd[KT + r0 + 8];
      }
      const unsigned char* kb0 = stages + (it % NST) * 2 * RW_KV_BYTES;
      sm90::mbar_wait(&full[it % NST], (it / NST) & 1);
      sm90::fence_regs(sacc);
      if (DQ) sm90::fence_regs(dpa);
      sm90::wgmma_fence();
      rw_issue_abt<RW_KN>(sacc, qa, kb0);
      if (DQ) rw_issue_abt<RW_KN>(dpa, da, kb0 + RW_KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      if (DQ) {
        sm90::fence_regs(dpa);
        rw_ds<RW_KN>(sacc, dpa, ls, dl, steps == 1 ? last : RW_KN, cs);
        rw_pack<RW_KN>(x, dpa);
      } else {
        rw_softmax<RW_KN>(sacc, m, l, alpha, steps == 1 ? last : RW_KN, cs);
        rw_pack<RW_KN>(x, sacc);
      }
      // step j: the products of step j + 1's scores issued with step j's
      // P V (dS K); step j + 1's softmax (dS) runs while that is in flight
      for (int j = 0; j < steps; ++j, ++it) {
        const bool more = j + 1 < steps;
        const int s0 = it % NST, s1 = (it + 1) % NST;
        const unsigned char* kb = stages + s0 * 2 * RW_KV_BYTES;
        const unsigned char* kn = stages + s1 * 2 * RW_KV_BYTES;
        if (more) sm90::mbar_wait(&full[s1], ((it + 1) / NST) & 1);
        sm90::fence_regs(acc);
        sm90::fence_regs(sacc);
        if (DQ) sm90::fence_regs(dpa);
        rw_fence<RW_KN>(x);
        sm90::wgmma_fence();
        if (more) {
          rw_issue_abt<RW_KN>(sacc, qa, kn);
          if (DQ) rw_issue_abt<RW_KN>(dpa, da, kn + RW_KV_BYTES);
          sm90::wgmma_commit();
        }
        // O += P V (V of step j), dQ += dS K (K of step j)
        rw_issue_xb<RW_KN>(acc, x, DQ ? kb : kb + RW_KV_BYTES);
        sm90::wgmma_commit();
        const int valid = j + 2 == steps ? last : RW_KN;
        if (more) {
          sm90::wgmma_wait<1>();
          sm90::fence_regs(sacc);
          if (DQ) {
            sm90::fence_regs(dpa);
            rw_ds<RW_KN>(sacc, dpa, ls, dl, valid, cs);
          } else {
            rw_softmax<RW_KN>(sacc, m, l, alpha, valid, cs);
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        rw_fence<RW_KN>(x);
        rw_release(&empty[s0]);
        if (more) {
          if (DQ) {
            rw_pack<RW_KN>(x, dpa);
          } else {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              acc[4 * jj] *= alpha[0];
              acc[4 * jj + 1] *= alpha[0];
              acc[4 * jj + 2] *= alpha[1];
              acc[4 * jj + 3] *= alpha[1];
            }
            rw_pack<RW_KN>(x, sacc);
          }
        }
      }
      rw_release(&q_empty[slot]);
      ++qi;
    }

    // the tile's rows: slot rr -> line rr / piece, row rr % piece
    const int* t = me.tile;
    if (!DQ) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(kFull, l[h], 1);
        l[h] += __shfl_xor_sync(kFull, l[h], 2);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + 8 * h, li = rr / piece;
      if (li >= t[2]) continue;
      const size_t row =
          (size_t)me.bh * S + t[3 + li] * block + t[1] + rr % piece;
      if (DQ) {
        bf16* dr = dq + row * 64 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dr + 8 * j) =
              pack_f32(acc[4 * j + 2 * h] * scale,
                       acc[4 * j + 2 * h + 1] * scale);
      } else {
        // a row of no block: l = 0, o = 0, lse = +1e30
        const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
        float* orow = o + row * 64 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
              acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
        if (t4 == 0)
          lse[row] = l[h] > 0.f ? m[h] * scale + logf(l[h]) : POS_INF;
      }
    }
  }
}

// ------------------------------------------------------ dk/dv (TMA, wgmma)

constexpr int DKV_NST = 4;                  // stages of the Q/dO ring
constexpr int DKV_STAGE = 2 * TILE_BYTES + 1024;   // Q, dO, lse, delta
constexpr int DKV_KVST = 2;                 // key tiles in flight
constexpr int DKV_THREADS = 160;            // a consumer warpgroup + a warp
constexpr int DKV_SMEM =
    1024 + DKV_NST * DKV_STAGE + DKV_KVST * 2 * TILE_BYTES + 128;

struct DkvMaps {
  CUtensorMap q, k, v, dout;   // [BH * S, 64] bf16, boxes [piece][64]
};

// One persistent block per SM pair walks the (tile, head) work list,
// longest tiles first: a producer warp streams each tile's keys (K and V
// of its columns, 64 keys) and its 64-row q steps (Q, dO, lse and delta
// of the listed q-blocks, gathered box by box) by TMA into rings;
// the consumer warpgroup computes S^T = K Q^T and dP^T = V dO^T (wgmma
// m64n64k16, both operands K-major in shared memory), p^T = exp(scale
// s - lse), dS^T = p^T (dP^T - delta), and dV += P^T dO, dK += dS^T Q
// with P^T and dS^T rounded to bf16 as register A operands (dO and Q
// MN-major as staged), then writes dk (times scale) and dv.
__global__ void __launch_bounds__(DKV_THREADS) bs_dkv_tma_kernel(
    const __grid_constant__ DkvMaps maps, const float* lse,
    const float* delta, const int* __restrict__ rows_t,
    const int* __restrict__ tiles, float* __restrict__ dk,
    float* __restrict__ dv, int TH, int S, int block, int max_nnz_t,
    int n_work, int rep, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* stages = smem;
  unsigned char* kvs = smem + DKV_NST * DKV_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + DKV_KVST * 2 *
                                               TILE_BYTES);
  uint64_t* empty = full + DKV_NST;
  uint64_t* kv_full = empty + DKV_NST;
  uint64_t* kv_empty = kv_full + DKV_KVST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = S / block, piece = block < KT ? block : KT;
  const int per = KT / piece;      // columns a tile, q-blocks a step
  if (threadIdx.x == 0) {
    for (int s = 0; s < DKV_NST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);
    }
    for (int s = 0; s < DKV_KVST; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 4);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // a tile's steps of 64 q rows: per q-blocks a step, or 2 a q-block
  auto n_steps = [&](int nq) {
    return block > KT ? 2 * nq : (nq + per - 1) / per;
  };

  if (warp == 4) {   // the producer warp: one lane issues
    if (lane != 0) return;
    sm90::tma_prefetch_map(&maps.q);
    sm90::tma_prefetch_map(&maps.dout);
    int it = 0, kvi = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int* tile = tiles + (w / rep) * TILE_INTS;
      const int th = tile[0], ncols = tile[2];
      const int bh = (w % rep) * TH + th;
      const int nq = tile[7], steps = n_steps(nq);
      if (steps == 0) continue;
      const int ks = kvi % DKV_KVST;
      sm90::mbar_wait(&kv_empty[ks], ((kvi / DKV_KVST) & 1) ^ 1);
      sm90::mbar_expect_tx(&kv_full[ks], 2 * TILE_BYTES);
      unsigned char* kb = kvs + ks * 2 * TILE_BYTES;
      for (int i = 0; i < per; ++i) {   // padding repeats the last column
        const int col = tile[3 + (i < ncols ? i : ncols - 1)];
        const int row = bh * S + col * block + tile[1];
        sm90::tma_load_2d(kb + i * piece * 128, &maps.k, 0, row,
                          &kv_full[ks]);
        sm90::tma_load_2d(kb + TILE_BYTES + i * piece * 128, &maps.v, 0,
                          row, &kv_full[ks]);
      }
      ++kvi;
      const int* list = rows_t + ((size_t)th * nb + tile[3]) * max_nnz_t;
      for (int s = 0; s < steps; ++s, ++it) {
        const int st = it % DKV_NST;
        sm90::mbar_wait(&empty[st], ((it / DKV_NST) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * TILE_BYTES + 2 * KT * 4);
        unsigned char* qb = stages + st * DKV_STAGE;
        float* lsd = reinterpret_cast<float*>(qb + 2 * TILE_BYTES);
        for (int i = 0; i < per; ++i) {
          int row;
          if (block > KT) {
            row = list[s / 2] * block + (s % 2) * KT;
          } else {   // past the list: the first q-block again (masked)
            const int qi = s * per + i;
            row = list[qi < nq ? qi : 0] * block;
          }
          const int grow = bh * S + row;
          sm90::tma_load_2d(qb + i * piece * 128, &maps.q, 0, grow,
                            &full[st]);
          sm90::tma_load_2d(qb + TILE_BYTES + i * piece * 128, &maps.dout,
                            0, grow, &full[st]);
          sm90::bulk_load(lsd + i * piece, lse + grow, piece * 4, &full[st]);
          sm90::bulk_load(lsd + KT + i * piece, delta + grow, piece * 4,
                          &full[st]);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w holds keys 16 w + g (+ 8) of the tile
  const int g = lane / 4, t4 = lane % 4;
  float dka[32], dva[32], sacc[32], dpa[32];
  uint32_t pf[4][4], df[4][4];
  int it = 0, kvi = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int* tile = tiles + (w / rep) * TILE_INTS;
    const int th = tile[0], ncols = tile[2];
    const int bh = (w % rep) * TH + th;
    const int nq = tile[7], steps = n_steps(nq);
#pragma unroll
    for (int x = 0; x < 32; ++x) dka[x] = dva[x] = 0.f;
    if (steps > 0) {
      const int ks = kvi % DKV_KVST;
      const unsigned char* kb = kvs + ks * 2 * TILE_BYTES;
      const unsigned char* vb = kb + TILE_BYTES;
      sm90::mbar_wait(&kv_full[ks], (kvi / DKV_KVST) & 1);
      for (int s = 0; s < steps; ++s, ++it) {
        const int st = it % DKV_NST;
        const unsigned char* qb = stages + st * DKV_STAGE;
        const unsigned char* dob = qb + TILE_BYTES;
        const float* lsd = reinterpret_cast<const float*>(qb + 2 * TILE_BYTES);
        // q rows of this step that belong to the tile's list
        const int valid =
            block > KT ? KT : min(per, nq - s * per) * piece;
        sm90::mbar_wait(&full[st], (it / DKV_NST) & 1);
        sm90::fence_regs(sacc);
        sm90::fence_regs(dpa);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<64, 0, 0>(sacc, sm90::wgmma_desc(kb + kk * 32, 16,
                                                          1024),
                                   sm90::wgmma_desc(qb + kk * 32, 16, 1024),
                                   kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<64, 0, 0>(dpa, sm90::wgmma_desc(vb + kk * 32, 16,
                                                         1024),
                                   sm90::wgmma_desc(dob + kk * 32, 16, 1024),
                                   kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sacc);
        sm90::fence_regs(dpa);
        // p^T and dS^T: rows keys, columns q (8 j + 2 t4 + e)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 ls = *reinterpret_cast<const float2*>(lsd + col);
          const float2 dl = *reinterpret_cast<const float2*>(lsd + KT + col);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * h + e;
              const float p = col + e < valid
                                  ? __expf(sacc[x] * scale - (e ? ls.y : ls.x))
                                  : 0.f;
              sacc[x] = p;
              dpa[x] = p * (dpa[x] - (e ? dl.y : dl.x));
            }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pf[kk][x] =
                pack_f32(sacc[8 * kk + 2 * x], sacc[8 * kk + 2 * x + 1]);
            df[kk][x] =
                pack_f32(dpa[8 * kk + 2 * x], dpa[8 * kk + 2 * x + 1]);
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::fence_regs(pf[kk]);
          sm90::fence_regs(df[kk]);
        }
        sm90::fence_regs(dka);
        sm90::fence_regs(dva);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_rs<64, 1>(dva, pf[kk],
                                sm90::wgmma_desc(dob + kk * 2048, 8192, 1024),
                                1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_rs<64, 1>(dka, df[kk],
                                sm90::wgmma_desc(qb + kk * 2048, 8192, 1024),
                                1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dka);
        sm90::fence_regs(dva);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[st]);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&kv_empty[ks]);
      ++kvi;
    }

    // the tile's keys: slot kr -> column kr / piece, row kr % piece
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = 16 * warp + g + 8 * h;
      const int ci = kr / piece;
      if (ci >= ncols) continue;
      const size_t key =
          (size_t)bh * S + tile[3 + ci] * block + tile[1] + kr % piece;
      float* dkr = dk + key * 64 + 2 * t4;
      float* dvr = dv + key * 64 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dkr + 8 * j) =
            make_float2(dka[4 * j + 2 * h] * scale,
                        dka[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dvr + 8 * j) =
            make_float2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// the blocks the kernels take
bool block_ok(int block) {
  return block == 16 || block == 32 || block == 64 || block == 128;
}

// the row walk's launch: out is o (fp32) for the forward, dq (bf16) for
// dq, whose lse and delta are inputs
template <bool DQ>
int launch_rows(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* cols, const void* tiles, void* out, int BH,
                int TH, int S, int block, int max_nnz, int n_tiles,
                float scale, cudaStream_t st) {
  if (!block_ok(block) || TH <= 0 || BH % TH || S % block)
    return (int)cudaErrorInvalidValue;
  const int rep = BH / TH, n_work = n_tiles * rep;
  if (n_work == 0) return (int)cudaSuccess;
  RowMaps maps;
  const int rows = BH * S, box = block < KT ? block : KT;
  cudaError_t e = sm90::encode_2d(&maps.q, q, rows, 64, box);
  if (e == cudaSuccess) e = sm90::encode_2d(&maps.k, k, rows, 64, box);
  if (e == cudaSuccess) e = sm90::encode_2d(&maps.v, v, rows, 64, box);
  if (e == cudaSuccess && DQ)
    e = sm90::encode_2d(&maps.dout, dout, rows, 64, box);
  if (e != cudaSuccess) return (int)e;
  static bool allowed = false;     // one attribute call a process
  if (!allowed) {
    e = cudaFuncSetAttribute(bs_rows_tma_kernel<DQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RowCfg<DQ>::SMEM);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int slots = RowCfg<DQ>::CTAS * sm90::sm_count();
  const int grid = n_work < slots ? n_work : slots;
  bs_rows_tma_kernel<DQ><<<grid, RW_THREADS, RowCfg<DQ>::SMEM, st>>>(
      maps, (float*)lse, (const float*)delta, (const int*)cols,
      (const int*)tiles, DQ ? nullptr : (float*)out,
      DQ ? (bf16*)out : nullptr, TH, S, block, max_nnz, n_work, rep, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v bf16 [BH, S, 64]; cols int32 [TH, S / block, max_nnz] the rows'
// k-block lists; tiles int32 [n_tiles, 8] the row work list in walk order
// (ops/cuda/blocksparse.py TileWork), walked for each of the BH / TH heads
// of a table; o fp32 [BH, S, 64], lse fp32 [BH, S]. S a multiple of block
// (the wrapper checks both).
extern "C" int dstpu_bs_fwd(const void* q, const void* k, const void* v,
                            const void* cols, const void* tiles, void* o,
                            void* lse, int BH, int TH, int S, int block,
                            int max_nnz, int n_tiles, float scale,
                            void* stream) {
  return launch_rows<false>(q, k, v, nullptr, lse, nullptr, cols, tiles, o,
                            BH, TH, S, block, max_nnz, n_tiles, scale,
                            (cudaStream_t)stream);
}

// dq bf16 [BH, S, 64]; lse, delta fp32 [BH, S]; the rest as dstpu_bs_fwd
extern "C" int dstpu_bs_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* cols,
                               const void* tiles, void* dq, int BH, int TH,
                               int S, int block, int max_nnz, int n_tiles,
                               float scale, void* stream) {
  return launch_rows<true>(q, k, v, dout, lse, delta, cols, tiles, dq, BH,
                           TH, S, block, max_nnz, n_tiles, scale,
                           (cudaStream_t)stream);
}

// rows_t: the transposed layout's q-block lists [TH, S / block,
// max_nnz_t]; tiles int32 [n_tiles, 8] the dk/dv work list in walk order
// (ops/cuda/blocksparse.py TileWork over the transposed tables), walked
// for each of the BH / TH heads of a table; dk, dv fp32 [BH, S, 64]
extern "C" int dstpu_bs_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* rows_t,
                                const void* tiles, void* dk, void* dv,
                                int BH, int TH, int S, int block,
                                int max_nnz_t, int n_tiles, float scale,
                                void* stream) {
  if (!block_ok(block) || TH <= 0 || BH % TH || S % block)
    return (int)cudaErrorInvalidValue;
  const int rep = BH / TH, n_work = n_tiles * rep;
  if (n_work == 0) return (int)cudaSuccess;
  DkvMaps maps;
  const int rows = BH * S, box = block < KT ? block : KT;
  cudaError_t e = sm90::encode_2d(&maps.q, q, rows, 64, box);
  if (e == cudaSuccess) e = sm90::encode_2d(&maps.k, k, rows, 64, box);
  if (e == cudaSuccess) e = sm90::encode_2d(&maps.v, v, rows, 64, box);
  if (e == cudaSuccess) e = sm90::encode_2d(&maps.dout, dout, rows, 64, box);
  if (e != cudaSuccess) return (int)e;
  static bool allowed = false;     // one attribute call a process
  if (!allowed) {
    e = cudaFuncSetAttribute(bs_dkv_tma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int slots = 2 * sm90::sm_count();    // two blocks an SM
  const int grid = n_work < slots ? n_work : slots;
  bs_dkv_tma_kernel<<<grid, DKV_THREADS, DKV_SMEM, (cudaStream_t)stream>>>(
      maps, (const float*)lse, (const float*)delta, (const int*)rows_t,
      (const int*)tiles, (float*)dk, (float*)dv, TH, S, block, max_nnz_t,
      n_work, rep, scale);
  return (int)cudaGetLastError();
}
