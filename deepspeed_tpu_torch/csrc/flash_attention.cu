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
//   from the S accumulator registers as the next A operand.
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

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* base, int row,
                                              int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * HD + col);
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
  const bf16* qp = q + (size_t)bh * S * HD;
  const bf16* kp = k + (size_t)kvh * S * HD;
  const bf16* vp = v + (size_t)kvh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = load_pair(qp, r0, kk * 16 + 2 * t4, S);
    qf[kk][1] = load_pair(qp, r1, kk * 16 + 2 * t4, S);
    qf[kk][2] = load_pair(qp, r0, kk * 16 + 8 + 2 * t4, S);
    qf[kk][3] = load_pair(qp, r1, kk * 16 + 8 + 2 * t4, S);
  }
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
    for (int i = threadIdx.x; i < BK * HD / 8; i += NT) {
      const int row = i / (HD / 8), c8 = i % (HD / 8);
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < S) {
        kv = __ldg(reinterpret_cast<const uint4*>(kp + (size_t)(k0 + row) * HD) + c8);
        vv = __ldg(reinterpret_cast<const uint4*>(vp + (size_t)(k0 + row) * HD) + c8);
      }
      *reinterpret_cast<uint4*>(ks + row * SROW + c8 * 8) = kv;
      *reinterpret_cast<uint4*>(vs + row * SROW + c8 * 8) = vv;
    }
    __syncthreads();

    float sf[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* kr = ks + (j * 8 + g) * SROW + kk * 16 + 2 * t4;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(kr);
        bfr[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(sf[j], qf[kk], bfr);
      }
    }

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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(sf[2 * kk][0], sf[2 * kk][1]);
      pa[1] = pack_f32(sf[2 * kk][2], sf[2 * kk][3]);
      pa[2] = pack_f32(sf[2 * kk + 1][0], sf[2 * kk + 1][1]);
      pa[3] = pack_f32(sf[2 * kk + 1][2], sf[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const bf16* v0 = vs + (kk * 16 + 2 * t4) * SROW + dn * 8 + g;
        uint32_t bfr[2];
        bfr[0] = pack_bf16(v0[0], v0[SROW]);
        bfr[1] = pack_bf16(v0[8 * SROW], v0[9 * SROW]);
        mma_bf16(of[dn], pa, bfr);
      }
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* op = o + (size_t)bh * S * HD;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(op + (size_t)r0 * HD + col) =
          pack_f32(of[dn][0] * inv0, of[dn][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(op + (size_t)r1 * HD + col) =
          pack_f32(of[dn][2] * inv1, of[dn][3] * inv1);
  }
  if (t4 == 0) {
    if (r0 < S) lse[(size_t)bh * S + r0] = m0 + logf(l0);
    if (r1 < S) lse[(size_t)bh * S + r1] = m1 + logf(l1);
  }
}

}  // namespace

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
