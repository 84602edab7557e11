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
// What bounds them on the H100: per active (row, column) block pair the
// forward does 4 * block^2 * 64 flops over one [block, 64] K and V tile
// (2 * block * 64 * 2 bytes); at block 16 that is 64 flops a byte, under
// the ridge of ~295, so each kernel is bound by the bytes it streams, and
// at block 16 by how many small tiles it can keep in flight. The bound
// chip_smoke.py states counts each input once, which a kernel that
// streams every active tile again cannot reach: the tiles come from L2.
//
// What the design does about it (the forward and dq: simple and right
// first; dk/dv: redesigned for Hopper):
// - The TPU kernels' lane padding to 128, block-major copies, DMA
//   semaphores and grouped-row union tables are Mosaic's constraints and
//   are not carried over. A CUDA block reads its own row of the table.
// - Forward and dq: a block is 4 warps over 64 query rows, each warp 16
//   rows held as mma.sync m16n8k16 A fragments in registers, as in
//   flash_attention.cu. The warps that share a q-block row form a group
//   of WPR = min(block, 64) / 16 warps: at block 16 each warp walks its
//   own row's list, at block 32 pairs of warps, at 64 and 128 all four. A
//   group stages each [16 WPR, 64] K/V tile of its active blocks in its
//   own shared memory, synchronised by a named barrier of its own warps
//   only. A block of 128 is two tiles of 64; a q-block row of 128 is two
//   thread blocks that walk the same list.
// - dk/dv (bs_dkv_tma_kernel): the transposed lists are badly unbalanced
//   (DeepSpeed's Fixed layout at block 16: 64 of a head's 256 columns
//   list all 256 q-blocks, the rest 4), and one warp a 16-key column left
//   three of a block's four warps idle for 252 of 256 steps behind a
//   chain of plain loads and barriers (4.9 % of the bound). So the host
//   (ops/cuda/blocksparse.py DkvWork) cuts the work into 64-key tiles --
//   up to 64 / block columns whose lists are the same (at block 16 four
//   of the long columns), or half a column of 128 -- sorted longest first;
//   a persistent grid of two blocks an SM walks that list. (Cutting the
//   long tiles' lists into chunks whose fp32 partials are summed
//   afterwards was measured slower at BERT-large's layer, at 1 and 4
//   sequences: its longest tile is under a block's even share.) A
//   producer warp gathers each 64-row q step (64 / block listed
//   q-blocks, their lse and delta) box by box by TMA into a 4-stage
//   ring, so loads run ahead of the products, and the tile's K and V
//   into a 2-deep ring. One consumer warpgroup
//   runs all four products on the tensor cores (wgmma m64n64k16, below):
//   with 64 keys as M a Q/dO step is read once for four columns, not once
//   a column.
// - Every key of an active block is valid (S is a multiple of the block),
//   so no element mask is needed: the online softmax of the forward and
//   the p = exp(s - lse) of the backward run unmasked (dk/dv masks only
//   the q rows a short last step pads). A row with no active block gets
//   o = 0 and lse = +1e30 (_bs_fwd_kernel :178-182), so the backward's
//   exp(s - lse) is 0.
// - No atomics on the outputs, deterministic: dq walks the rows' lists and
//   dk/dv the columns' lists, as the Pallas backward splits them; one
//   block computes a dk/dv tile whole, so a rerun is bit-equal. dk/dv
//   computes S^T = K.Q^T and dP^T = V.dO^T so that P^T
//   and dS^T come out in the A layout of the next product, as the flash
//   backward does.
// - o, dk and dv are written in fp32 (the Pallas outputs' type: backward's
//   delta = rowsum(do * o) reads the unrounded o); dq in bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int HD = 64;          // head dim
constexpr int SROW = HD + 8;    // padded shared-memory row: conflict-free
constexpr int NT = 128;         // 4 warps, 64 rows (or keys) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float POS_INF = 1e30f;

// The WPR warps of group `group` meet here (named barrier 1 + group; bar 0
// is __syncthreads'): the tile in shared memory is complete, or free.
template <int WPR>
__device__ __forceinline__ void group_sync(int group) {
  if (WPR == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(32 * WPR)
                 : "memory");
}

// rows r0 .. r0 + 16 WPR - 1 of a [S, 64] head into a padded shared tile,
// by the group's 32 WPR threads
template <int WPR>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int gtid) {
  for (int i = gtid; i < 16 * WPR * HD / 8; i += 32 * WPR) {
    const int row = i / (HD / 8), c8 = i % (HD / 8);
    *reinterpret_cast<uint4*>(dst + row * SROW + c8 * 8) = __ldg(
        reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * HD) + c8);
  }
}

// A fragments (16 rows x 64) of rows r and r + 8 of a [S, 64] head
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const bf16* p,
                                             int r, int t4) {
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(p + (size_t)r * HD);
  const uint32_t* p1 =
      reinterpret_cast<const uint32_t*>(p + (size_t)(r + 8) * HD);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = p0[kk * 8 + t4];
    f[kk][1] = p1[kk * 8 + t4];
    f[kk][2] = p0[kk * 8 + 4 + t4];
    f[kk][3] = p1[kk * 8 + 4 + t4];
  }
}

// acc[j] (16 x 8, j < NJ) = A (16 x 64) . T^T for an (8 NJ)-row shared tile
// T whose rows are the product's n index: S = Q.K^T
template <int NJ>
__device__ __forceinline__ void mma_abt(float acc[NJ][4],
                                        const uint32_t a[4][4], const bf16* t,
                                        int lane) {
  const int r = lane % 8, m = lane / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t b[4];
      ldsm_x4(b, t + (j * 8 + r) * SROW + kp * 32 + m * 8);
      mma_bf16(acc[j], a[2 * kp], b);
      mma_bf16(acc[j], a[2 * kp + 1], b + 2);
    }
  }
}

// out[dn] (16 x 8, dn < 8) += X (16 x 8 NJ, held as accumulators x[j])
// rounded to bf16, . T for an (8 NJ)-row shared [., 64] tile T whose rows
// are the product's k index: O += P.V
template <int NJ>
__device__ __forceinline__ void mma_xt(float out[8][4], const float x[NJ][4],
                                       const bf16* t, int lane) {
  const int r = lane % 8, m = lane / 8;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_f32(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_f32(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, t + (kk * 16 + (m & 1) * 8 + r) * SROW +
                       (2 * dp + (m >> 1)) * 8);
      mma_bf16(out[2 * dp], a, b);
      mma_bf16(out[2 * dp + 1], a, b + 2);
    }
  }
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// rows r and r + 8 of a [S, 64] fp32 head from accumulators, times mul
__device__ __forceinline__ void store_f32(float* p, const float acc[8][4],
                                          int r, int t4, float mul0,
                                          float mul1) {
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    *reinterpret_cast<float2*>(p + (size_t)r * HD + col) =
        make_float2(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<float2*>(p + (size_t)(r + 8) * HD + col) =
        make_float2(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

// The same rows in bf16
__device__ __forceinline__ void store_bf16(bf16* p, const float acc[8][4],
                                           int r, int t4, float mul) {
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(p + (size_t)r * HD + col) =
        pack_f32(acc[dn][0] * mul, acc[dn][1] * mul);
    *reinterpret_cast<uint32_t*>(p + (size_t)(r + 8) * HD + col) =
        pack_f32(acc[dn][2] * mul, acc[dn][3] * mul);
  }
}

// Where a warp and its group sit: the block's 64 rows (keys) start at
// blockIdx.x * 64; group `group` of WPR warps owns 16 WPR of them, all in
// one q-block row (k-block column) `line` of the table.
template <int WPR>
struct Place {
  int warp, lane, g, t4, group, gtid, row, grow, bh, th;
  __device__ explicit Place(int TH) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    g = lane / 4;
    t4 = lane % 4;
    group = warp / WPR;
    gtid = threadIdx.x - group * 32 * WPR;
    row = blockIdx.x * 64 + warp * 16 + g;   // this thread's rows: row, +8
    grow = blockIdx.x * 64 + group * 16 * WPR;
    bh = blockIdx.y;
    th = bh % TH;
  }
};

template <int WPR>
__global__ void __launch_bounds__(NT) bs_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ counts,
    const int* __restrict__ cols, int max_nnz, float* __restrict__ o,
    float* __restrict__ lse, int TH, int S, int block, float scale) {
  constexpr int TK = 16 * WPR, NJ = TK / 8;
  __shared__ __align__(16) bf16 ks[64 * SROW];
  __shared__ __align__(16) bf16 vs[64 * SROW];
  const Place<WPR> at(TH);
  if (at.grow >= S) return;   // the ragged end: whole groups only
  const int nb = S / block, r = at.grow / block;
  const int nnz = counts[at.th * nb + r];
  const int* list = cols + ((size_t)at.th * nb + r) * max_nnz;
  const size_t base = (size_t)at.bh * S * HD;
  bf16* kt = ks + at.group * TK * SROW;
  bf16* vt = vs + at.group * TK * SROW;

  uint32_t qf[4][4];
  load_a_frags(qf, q + base, at.row, at.t4);
  float of[8][4];
  zero(of);
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nnz; ++j) {
    for (int k0 = list[j] * block, end = k0 + block; k0 < end; k0 += TK) {
      group_sync<WPR>(at.group);
      load_tile<WPR>(kt, k + base, k0, at.gtid);
      load_tile<WPR>(vt, v + base, k0, at.gtid);
      group_sync<WPR>(at.group);

      float sf[NJ][4];
      mma_abt<NJ>(sf, qf, kt, at.lane);   // S = Q.K^T
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sf[jj][e] *= scale;
          if (e < 2) mx0 = fmaxf(mx0, sf[jj][e]);
          else mx1 = fmaxf(mx1, sf[jj][e]);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(sf[jj][e] - (e < 2 ? mx0 : mx1));
          sf[jj][e] = p;
          if (e < 2) ps0 += p;
          else ps1 += p;
        }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        of[dn][0] *= a0;
        of[dn][1] *= a0;
        of[dn][2] *= a1;
        of[dn][3] *= a1;
      }
      mma_xt<NJ>(of, sf, vt, at.lane);    // O += P.V
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  // nnz == 0: l = 0, o = 0, lse = +1e30
  store_f32(o + base, of, at.row, at.t4, l0 > 0.f ? 1.f / l0 : 0.f,
            l1 > 0.f ? 1.f / l1 : 0.f);
  if (at.t4 == 0) {
    float* lp = lse + (size_t)at.bh * S;
    lp[at.row] = l0 > 0.f ? m0 + logf(l0) : POS_INF;
    lp[at.row + 8] = l1 > 0.f ? m1 + logf(l1) : POS_INF;
  }
}

// dq of 16 WPR query rows over their row's active k-blocks
template <int WPR>
__global__ void __launch_bounds__(NT) bs_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ counts, const int* __restrict__ cols, int max_nnz,
    bf16* __restrict__ dq, int TH, int S, int block, float scale) {
  constexpr int TK = 16 * WPR, NJ = TK / 8;
  __shared__ __align__(16) bf16 ks[64 * SROW];
  __shared__ __align__(16) bf16 vs[64 * SROW];
  const Place<WPR> at(TH);
  if (at.grow >= S) return;
  const int nb = S / block, r = at.grow / block;
  const int nnz = counts[at.th * nb + r];
  const int* list = cols + ((size_t)at.th * nb + r) * max_nnz;
  const size_t base = (size_t)at.bh * S * HD;
  bf16* kt = ks + at.group * TK * SROW;
  bf16* vt = vs + at.group * TK * SROW;

  uint32_t qf[4][4], df[4][4];
  load_a_frags(qf, q + base, at.row, at.t4);
  load_a_frags(df, dout + base, at.row, at.t4);
  const float* lp = lse + (size_t)at.bh * S;
  const float* dlp = delta + (size_t)at.bh * S;
  const float ls0 = lp[at.row], ls1 = lp[at.row + 8];
  const float d0 = dlp[at.row], d1 = dlp[at.row + 8];
  float dqf[8][4];
  zero(dqf);

  for (int j = 0; j < nnz; ++j) {
    for (int k0 = list[j] * block, end = k0 + block; k0 < end; k0 += TK) {
      group_sync<WPR>(at.group);
      load_tile<WPR>(kt, k + base, k0, at.gtid);
      load_tile<WPR>(vt, v + base, k0, at.gtid);
      group_sync<WPR>(at.group);

      float sf[NJ][4], dsf[NJ][4];
      mma_abt<NJ>(sf, qf, kt, at.lane);    // S = Q.K^T
      mma_abt<NJ>(dsf, df, vt, at.lane);   // dP = dO.V^T
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(sf[jj][e] * scale - (e < 2 ? ls0 : ls1));
          dsf[jj][e] = p * (dsf[jj][e] - (e < 2 ? d0 : d1));
        }
      mma_xt<NJ>(dqf, dsf, kt, at.lane);   // dQ += dS.K
    }
  }
  store_bf16(dq + base, dqf, at.row, at.t4, scale);
}

// ------------------------------------------------------ dk/dv (TMA, wgmma)

constexpr int KT = 64;                      // keys a tile, q rows a step
constexpr int TILE_BYTES = KT * 128;        // [64][64] bf16, 128B swizzle
constexpr int DKV_NST = 4;                  // stages of the Q/dO ring
constexpr int DKV_STAGE = 2 * TILE_BYTES + 1024;   // Q, dO, lse, delta
constexpr int DKV_KVST = 2;                 // key tiles in flight
constexpr int DKV_THREADS = 160;            // a consumer warpgroup + a warp
constexpr int DKV_SMEM =
    1024 + DKV_NST * DKV_STAGE + DKV_KVST * 2 * TILE_BYTES + 128;
// a key tile (ops/cuda/blocksparse.py DkvWork): its table, key offset in
// its column (block 128), columns (1 .. 64 / block, same q-block list),
// the columns, the list's length
constexpr int TILE_INTS = 8;

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

// warps a q-block row (k-block column) shares: 1, 2 or 4; 0 for a block
// the kernels do not take
int group_warps(int block) {
  switch (block) {
    case 16: return 1;
    case 32: return 2;
    case 64:
    case 128: return 4;
    default: return 0;
  }
}

}  // namespace

// q, k, v bf16 [BH, S, 64]; counts int32 [TH, S / block], cols int32
// [TH, S / block, max_nnz]; o fp32 [BH, S, 64], lse fp32 [BH, S]. S a
// multiple of block (the wrapper checks both).
extern "C" int dstpu_bs_fwd(const void* q, const void* k, const void* v,
                            const void* counts, const void* cols, void* o,
                            void* lse, int BH, int TH, int S, int block,
                            int max_nnz, float scale, void* stream) {
  const dim3 grid((S + 63) / 64, BH);
  cudaStream_t st = (cudaStream_t)stream;
#define BS_FWD(W)                                                            \
  bs_fwd_kernel<W><<<grid, NT, 0, st>>>(                                     \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)counts,    \
      (const int*)cols, max_nnz, (float*)o, (float*)lse, TH, S, block,    \
      scale)
  switch (group_warps(block)) {
    case 1: BS_FWD(1); break;
    case 2: BS_FWD(2); break;
    case 4: BS_FWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BS_FWD
  return (int)cudaGetLastError();
}

// dq bf16 [BH, S, 64]; lse, delta fp32 [BH, S]
extern "C" int dstpu_bs_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* counts,
                               const void* cols, void* dq, int BH, int TH,
                               int S, int block, int max_nnz, float scale,
                               void* stream) {
  const dim3 grid((S + 63) / 64, BH);
  cudaStream_t st = (cudaStream_t)stream;
#define BS_DQ(W)                                                             \
  bs_dq_kernel<W><<<grid, NT, 0, st>>>(                                      \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,     \
      (const float*)lse, (const float*)delta, (const int*)counts,            \
      (const int*)cols, max_nnz, (bf16*)dq, TH, S, block, scale)
  switch (group_warps(block)) {
    case 1: BS_DQ(1); break;
    case 2: BS_DQ(2); break;
    case 4: BS_DQ(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BS_DQ
  return (int)cudaGetLastError();
}

// rows_t: the transposed layout's q-block lists [TH, S / block,
// max_nnz_t]; tiles int32 [n_tiles, 8] the work list in walk order
// (ops/cuda/blocksparse.py DkvWork), walked for each of the BH / TH heads
// of a table; dk, dv fp32 [BH, S, 64]
extern "C" int dstpu_bs_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* rows_t,
                                const void* tiles, void* dk, void* dv,
                                int BH, int TH, int S, int block,
                                int max_nnz_t, int n_tiles, float scale,
                                void* stream) {
  if (group_warps(block) == 0 || TH <= 0 || BH % TH || S % block)
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
