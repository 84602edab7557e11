// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the Pallas forward of deepspeed_tpu/ops/pallas/flash_attention.py:
// flash_attention (:580) -> _flash_fwd (:149) -> _fwd_kernel (:122). It
// covers the chunked long-S forward's contract too (_flash_fwd_chunked,
// :336): K/V are streamed in tiles for any S, so no VMEM-budget split is
// needed.
//
// What bounds it on the H100: at the prefill shapes of GPT-2 large
// (S <= 1024, D = 64, causal) the work is ~2.7 GFLOP over ~10.5 MB per
// layer, about 260 flop/byte, close to the ridge of 295: both the tensor
// cores and the bytes matter, and at short S the launch does.
//
// What the design does about it:
// - The TPU kernel keeps a whole K/V row of one head in VMEM and loops
//   over it inside one grid step. Here one block of 4 warps owns a
//   (batch*head, 64-row q tile); each warp owns 16 q rows, held as
//   mma.sync m16n8k16 bf16 A fragments in registers for the whole pass.
// - K/V stream through shared memory in 64-row tiles (rows padded to 72
//   elements so fragment reads are bank-conflict free). S = Q.K^T and
//   O += P.V run on the tensor cores with fp32 accumulation; P is reused
//   from the S accumulator registers as the next A operand. The B
//   fragments come from shared memory by ldmatrix, .trans for V's
//   transposed reads: one instruction gives two fragments (mma_abt,
//   mma_xt, shared with the backward).
// - The online softmax (running max m, running sum l, rescale alpha) runs
//   in fp32 registers; each group of 4 lanes shares a row, so row maxima
//   take two shuffles and row sums are reduced once at the end.
// - Causal: tiles above the diagonal are never loaded; the masked tiles
//   use the reference's finite -1e30, so a row that has seen a valid key
//   never produces NaN. The ragged tail (S not a multiple of 64) is
//   zero-filled and masked, so S = 16 and S = 32 buckets work.
// - GQA: the q head maps to its KV head by index; K/V are never repeated.
// - Causal blocks are issued longest first, which evens out the tail.
// cp.async double buffering, wgmma and TMA are later work.
//
// Flash-attention backward: two kernels, dk/dv and dq.
//
// Replace the Pallas backward of the same file: _flash_bwd (:257) ->
// _bwd_fused_kernel (:192), and the chunked long-S form _flash_bwd_chunked
// (:457) -> _bwd_dkv_kernel_chunked (:405) and _bwd_dq_kernel_chunked
// (:367). Both tile Q and K/V in 64-row tiles, so one design covers any S.
// Per score tile they follow _bwd_ds_block (:96): fp32 scores,
// p = exp(scale*q.k - lse), dp = do.v^T, ds = p*(dp - delta), with p and
// ds rounded to bf16 before their products; delta = rowsum(do*o) comes in
// from the wrapper, as it does in JAX (:260).
//
// What bounds them: at GPT-2 large's training shape (B*H = 160, S = 1024,
// D = 64, causal) dk/dv is 4 and dq 3 products of 2*S*S*D/2 flops per
// head, ~43 and ~33 us of bf16 tensor-core time, against ~38 and ~31 us
// of bytes: both are near the ridge.
//
// What the design does about it:
// - No atomics, deterministic: the dk/dv kernel owns a (b*h, 64-key tile)
//   and loops over q tiles from the diagonal on; the dq kernel owns a
//   (b*h, 64-query tile) and loops over k tiles up to the diagonal. Each
//   recomputes the score tile the other needs (the fused single pass of
//   _bwd_fused_kernel, which computes each exp once, is later work).
// - The transposed products need no register transposes: the dk/dv kernel
//   computes S^T = K.Q^T and dP^T = V.dO^T directly (4 warps x 16 keys,
//   K and V held as A fragments), so P^T and dS^T come out in the
//   accumulator layout that is the A layout of the next mma, exactly as P
//   does in the forward; dO and Q are then read as B through
//   ldmatrix.trans, the forward's V pattern.
// - Masked diagonal tiles and the ragged tail (S not a multiple of 64) set
//   p = 0 where the reference's -1e30 makes exp give 0, and zero-fill the
//   rows past S.
// - Causal blocks are issued longest first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;   // q rows per block (16 per warp)
constexpr int BK = 64;   // keys per K/V tile
constexpr int HD = 64;   // head dim
constexpr int NT = 128;  // threads per block
constexpr int SROW = HD + 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* base, int row,
                                              int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * HD + col);
}

// ldmatrix: four 8x8 bf16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8; .trans hands each lane the
// transposed elements, which is the mma B layout of a row-major [k][n] tile
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Fill a 64-row tile of shared memory from rows r0.. of a [S, HD] head,
// zero past S.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < 64 * HD / 8; i += NT) {
    const int row = i / (HD / 8), c8 = i % (HD / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < S)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * HD) + c8);
    *reinterpret_cast<uint4*>(dst + row * SROW + c8 * 8) = val;
  }
}

// A fragments (16 rows x HD) of rows r0 (and r0 + 8) of a [S, HD] head
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const bf16* p,
                                             int r0, int t4, int S) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = load_pair(p, r0, kk * 16 + 2 * t4, S);
    f[kk][1] = load_pair(p, r0 + 8, kk * 16 + 2 * t4, S);
    f[kk][2] = load_pair(p, r0, kk * 16 + 8 + 2 * t4, S);
    f[kk][3] = load_pair(p, r0 + 8, kk * 16 + 8 + 2 * t4, S);
  }
}

// acc[j] (16 x 8, j = 0..7) = A (16 x HD) . T^T for a 64-row shared tile T
// (rows are the product's n index): S = Q.K^T. One ldmatrix.x4 gives the
// B fragments of two k steps.
__device__ __forceinline__ void mma_abt(float acc[8][4], const uint32_t a[4][4],
                                        const bf16* t, int lane) {
  const int r = lane % 8, m = lane / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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

// out[dn] (16 x 8, dn = 0..7) += X (16 x 64, held as accumulators x[j])
// rounded to bf16, . T for a 64-row shared tile T (rows are the product's
// k index): O += P.V. One ldmatrix.x4.trans gives the B fragments of two
// n blocks.
__device__ __forceinline__ void mma_xt(float out[8][4], const float x[8][4],
                                       const bf16* t, int lane) {
  const int r = lane % 8, m = lane / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
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

__device__ __forceinline__ void store_rows(bf16* p, const float acc[8][4],
                                           int r0, int t4, int S, float mul0,
                                           float mul1) {
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(p + (size_t)r0 * HD + col) =
          pack_f32(acc[dn][0] * mul0, acc[dn][1] * mul0);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(p + (size_t)(r0 + 8) * HD + col) =
          pack_f32(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int S, float scale,
    int causal) {
  __shared__ __align__(16) bf16 ks[BK * SROW];
  __shared__ __align__(16) bf16 vs[BK * SROW];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const bf16* kp = k + (size_t)kvh * S * HD;
  const bf16* vp = v + (size_t)kvh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[4][4];
  load_a_frags(qf, q + (size_t)bh * S * HD, r0, t4, S);
  float of[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) of[j][e] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(ks, kp, k0, S);
    load_tile(vs, vp, k0, S);
    __syncthreads();

    float sf[8][4];
    mma_abt(sf, qf, ks, lane);      // S = Q.K^T

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key < S && (!causal || key <= row);
        const float s = ok ? sf[j][e] * scale : -1e30f;
        sf[j][e] = s;
        if (e < 2) mx0 = fmaxf(mx0, s);
        else mx1 = fmaxf(mx1, s);
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
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sf[j][e] - (e < 2 ? mx0 : mx1));
        sf[j][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      of[j][0] *= a0;
      of[j][1] *= a0;
      of[j][2] *= a1;
      of[j][3] *= a1;
    }
    mma_xt(of, sf, vs, lane);       // O += P.V
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  store_rows(o + (size_t)bh * S * HD, of, r0, t4, S, 1.f / l0, 1.f / l1);
  if (t4 == 0) {
    if (r0 < S) lse[(size_t)bh * S + r0] = m0 + logf(l0);
    if (r1 < S) lse[(size_t)bh * S + r1] = m1 + logf(l1);
  }
}

// dk, dv of one (b*h, 64-key tile): each warp owns 16 keys
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
    int causal) {
  __shared__ __align__(16) bf16 qs[BQ * SROW];
  __shared__ __align__(16) bf16 dos[BQ * SROW];
  __shared__ float ls[BQ], dls[BQ];
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;   // causal: key tile 0 has the most q tiles
  const size_t base = (size_t)bh * S * HD;
  const float* lp = lse + (size_t)bh * S;
  const float* dlp = delta + (size_t)bh * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kr0 = k0 + warp * 16 + g;   // this thread's keys: kr0, kr0 + 8

  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, k + base, kr0, t4, S);
  load_a_frags(vf, v + base, kr0, t4, S);
  float dkf[8][4], dvf[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkf[j][e] = dvf[j][e] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile(qs, q + base, q0, S);
    load_tile(dos, dout + base, q0, S);
    if (threadIdx.x < BQ) {
      const bool in = q0 + threadIdx.x < S;
      ls[threadIdx.x] = in ? lp[q0 + threadIdx.x] : 0.f;
      dls[threadIdx.x] = in ? dlp[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float pt[8][4], dst[8][4];      // P^T and dS^T: [16 keys x 64 queries]
    mma_abt(pt, kf, qs, lane);     // S^T = K.Q^T
    mma_abt(dst, vf, dos, lane);   // dP^T = V.dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const int qi = q0 + c, key = e < 2 ? kr0 : kr0 + 8;
        const bool ok = qi < S && key < S && (!causal || qi >= key);
        const float p = ok ? __expf(pt[j][e] * scale - ls[c]) : 0.f;
        pt[j][e] = p;
        dst[j][e] = p * (dst[j][e] - dls[c]);
      }
    mma_xt(dvf, pt, dos, lane);    // dV += P^T.dO
    mma_xt(dkf, dst, qs, lane);    // dK += dS^T.Q
  }
  store_rows(dk + base, dkf, kr0, t4, S, scale, scale);
  store_rows(dv + base, dvf, kr0, t4, S, 1.f, 1.f);
}

// dq of one (b*h, 64-query tile): each warp owns 16 queries
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, float scale, int causal) {
  __shared__ __align__(16) bf16 ks[BK * SROW];
  __shared__ __align__(16) bf16 vs[BK * SROW];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = (size_t)bh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[4][4], df[4][4];
  load_a_frags(qf, q + base, r0, t4, S);
  load_a_frags(df, dout + base, r0, t4, S);
  const float* lp = lse + (size_t)bh * S;
  const float* dlp = delta + (size_t)bh * S;
  const float l0 = r0 < S ? lp[r0] : 0.f, l1 = r1 < S ? lp[r1] : 0.f;
  const float d0 = r0 < S ? dlp[r0] : 0.f, d1 = r1 < S ? dlp[r1] : 0.f;
  float dqf[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqf[j][e] = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(ks, k + base, k0, S);
    load_tile(vs, v + base, k0, S);
    __syncthreads();

    float sf[8][4], dsf[8][4];      // S and dS: [16 queries x 64 keys]
    mma_abt(sf, qf, ks, lane);     // S = Q.K^T
    mma_abt(dsf, df, vs, lane);    // dP = dO.V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key < S && row < S && (!causal || key <= row);
        const float p = ok ? __expf(sf[j][e] * scale - (e < 2 ? l0 : l1))
                           : 0.f;
        dsf[j][e] = p * (dsf[j][e] - (e < 2 ? d0 : d1));
      }
    mma_xt(dqf, dsf, ks, lane);    // dQ += dS.K
  }
  store_rows(dq + base, dqf, r0, t4, S, scale, scale);
}

}  // namespace

extern "C" int dstpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int BH, int S, float scale, int causal,
                                   void* stream) {
  dim3 grid((S + BK - 1) / BK, BH);
  flash_bwd_dkv_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, scale,
      causal);
  return (int)cudaGetLastError();
}

extern "C" int dstpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int BH, int S,
                                  float scale, int causal, void* stream) {
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_bwd_dq_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int BH, int H, int Hkv,
                               int S, float scale, int causal,
                               void* stream) {
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, Hkv, S, scale, causal);
  return (int)cudaGetLastError();
}
