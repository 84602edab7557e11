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
// What the design does about it (simple and right first; speed is later
// work):
// - The TPU kernels' lane padding to 128, block-major copies, DMA
//   semaphores and grouped-row union tables are Mosaic's constraints and
//   are not carried over. A CUDA block reads its own row of the table.
// - A block is 4 warps over 64 query rows (the dk/dv pass: 64 keys), each
//   warp 16 rows held as mma.sync m16n8k16 A fragments in registers, as in
//   flash_attention.cu. The warps that share a q-block row (a k-block
//   column) form a group of WPR = min(block, 64) / 16 warps: at block 16
//   each warp walks its own row's list, at block 32 pairs of warps, at 64
//   and 128 all four. A group stages each [16 WPR, 64] K/V (Q/dO) tile of
//   its active blocks in its own shared memory, synchronised by a named
//   barrier of its own warps only, so groups of one block never wait for
//   each other. A block of 128 is two tiles of 64; a q-block row of 128 is
//   two thread blocks that walk the same list.
// - Every key of an active block is valid (S is a multiple of the block),
//   so no element mask is needed: the online softmax of the forward and
//   the p = exp(s - lse) of the backward run unmasked. A row with no
//   active block gets o = 0 and lse = +1e30 (_bs_fwd_kernel :178-182), so
//   the backward's exp(s - lse) would be 0; its loops run no step anyway.
// - No atomics, deterministic: dq walks the rows' lists and dk/dv the
//   columns' lists, as the Pallas backward splits them. dk/dv computes
//   S^T = K.Q^T and dP^T = V.dO^T so that P^T and dS^T come out in the A
//   layout of the next product, as flash_bwd_dkv_kernel does.
// - o, dk and dv are written in fp32 (the Pallas outputs' type: backward's
//   delta = rowsum(do * o) reads the unrounded o); dq in bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

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

// dk, dv of 16 WPR keys over the q-blocks of their column's list
template <int WPR>
__global__ void __launch_bounds__(NT) bs_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ counts_t, const int* __restrict__ rows_t,
    int max_nnz_t, float* __restrict__ dk, float* __restrict__ dv, int TH,
    int S, int block, float scale) {
  constexpr int TQ = 16 * WPR, NJ = TQ / 8;
  __shared__ __align__(16) bf16 qs[64 * SROW];
  __shared__ __align__(16) bf16 dos[64 * SROW];
  __shared__ float ls[64], dls[64];
  const Place<WPR> at(TH);   // here: rows are keys, the line a column
  if (at.grow >= S) return;
  const int nb = S / block, c = at.grow / block;
  const int nnz = counts_t[at.th * nb + c];
  const int* list = rows_t + ((size_t)at.th * nb + c) * max_nnz_t;
  const size_t base = (size_t)at.bh * S * HD;
  const float* lp = lse + (size_t)at.bh * S;
  const float* dlp = delta + (size_t)at.bh * S;
  bf16* qt = qs + at.group * TQ * SROW;
  bf16* dot = dos + at.group * TQ * SROW;
  float* lt = ls + at.group * TQ;
  float* dlt = dls + at.group * TQ;

  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, k + base, at.row, at.t4);
  load_a_frags(vf, v + base, at.row, at.t4);
  float dkf[8][4], dvf[8][4];
  zero(dkf);
  zero(dvf);

  for (int j = 0; j < nnz; ++j) {
    for (int q0 = list[j] * block, end = q0 + block; q0 < end; q0 += TQ) {
      group_sync<WPR>(at.group);
      load_tile<WPR>(qt, q + base, q0, at.gtid);
      load_tile<WPR>(dot, dout + base, q0, at.gtid);
      if (at.gtid < TQ) {
        lt[at.gtid] = lp[q0 + at.gtid];
        dlt[at.gtid] = dlp[q0 + at.gtid];
      }
      group_sync<WPR>(at.group);

      float pt[NJ][4], dst[NJ][4];     // P^T, dS^T: [16 keys x TQ queries]
      mma_abt<NJ>(pt, kf, qt, at.lane);    // S^T = K.Q^T
      mma_abt<NJ>(dst, vf, dot, at.lane);  // dP^T = V.dO^T
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = jj * 8 + 2 * at.t4 + (e & 1);
          const float p = __expf(pt[jj][e] * scale - lt[col]);
          pt[jj][e] = p;
          dst[jj][e] = p * (dst[jj][e] - dlt[col]);
        }
      mma_xt<NJ>(dvf, pt, dot, at.lane);   // dV += P^T.dO
      mma_xt<NJ>(dkf, dst, qt, at.lane);   // dK += dS^T.Q
    }
  }
  store_f32(dk + base, dkf, at.row, at.t4, scale, scale);
  store_f32(dv + base, dvf, at.row, at.t4, 1.f, 1.f);
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

// counts_t, rows_t: the tables of the transposed layout; dk, dv fp32
// [BH, S, 64]
extern "C" int dstpu_bs_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* counts_t,
                                const void* rows_t, void* dk, void* dv,
                                int BH, int TH, int S, int block,
                                int max_nnz_t, float scale, void* stream) {
  const dim3 grid((S + 63) / 64, BH);
  cudaStream_t st = (cudaStream_t)stream;
#define BS_DKV(W)                                                            \
  bs_dkv_kernel<W><<<grid, NT, 0, st>>>(                                     \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,     \
      (const float*)lse, (const float*)delta, (const int*)counts_t,          \
      (const int*)rows_t, max_nnz_t, (float*)dk, (float*)dv, TH, S, block,   \
      scale)
  switch (group_warps(block)) {
    case 1: BS_DKV(1); break;
    case 2: BS_DKV(2); break;
    case 4: BS_DKV(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BS_DKV
  return (int)cudaGetLastError();
}
