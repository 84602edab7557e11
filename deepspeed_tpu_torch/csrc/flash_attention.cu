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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block (16 per warp)
constexpr int BK = 64;   // keys per K/V tile
constexpr int HD = 64;   // the backward kernels' head dim
constexpr int NT = 128;  // threads per block

// shared-memory row of a [64, D] tile, padded so fragment reads are
// bank-conflict free
template <int D>
__host__ __device__ constexpr int srow() { return D + 8; }
constexpr unsigned kFull = 0xffffffffu;

template <int D>
__device__ __forceinline__ uint32_t load_pair(const bf16* base, int row,
                                              int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * D + col);
}

// Fill a 64-row tile of shared memory from rows r0.. of a [S, D] head,
// zero past S.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < 64 * D / 8; i += NT) {
    const int row = i / (D / 8), c8 = i % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < S)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * D) + c8);
    *reinterpret_cast<uint4*>(dst + row * srow<D>() + c8 * 8) = val;
  }
}

// A fragments (16 rows x D) of rows r0 (and r0 + 8) of a [S, D] head
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t f[D / 16][4],
                                             const bf16* p, int r0, int t4,
                                             int S) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = load_pair<D>(p, r0, kk * 16 + 2 * t4, S);
    f[kk][1] = load_pair<D>(p, r0 + 8, kk * 16 + 2 * t4, S);
    f[kk][2] = load_pair<D>(p, r0, kk * 16 + 8 + 2 * t4, S);
    f[kk][3] = load_pair<D>(p, r0 + 8, kk * 16 + 8 + 2 * t4, S);
  }
}

// acc[j] (16 x 8, j = 0..7) = A (16 x D) . T^T for a 64-row shared tile T
// (rows are the product's n index): S = Q.K^T. One ldmatrix.x4 gives the
// B fragments of two k steps.
template <int D>
__device__ __forceinline__ void mma_abt(float acc[8][4],
                                        const uint32_t a[D / 16][4],
                                        const bf16* t, int lane) {
  const int r = lane % 8, m = lane / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
      uint32_t b[4];
      ldsm_x4(b, t + (j * 8 + r) * srow<D>() + kp * 32 + m * 8);
      mma_bf16(acc[j], a[2 * kp], b);
      mma_bf16(acc[j], a[2 * kp + 1], b + 2);
    }
  }
}

// out[dn] (16 x 8, dn = 0..D/8-1) += X (16 x 64, held as accumulators
// x[j]) rounded to bf16, . T for a 64-row shared [64, D] tile T (rows are
// the product's k index): O += P.V. One ldmatrix.x4.trans gives the B
// fragments of two n blocks.
template <int D>
__device__ __forceinline__ void mma_xt(float out[D / 8][4],
                                       const float x[8][4], const bf16* t,
                                       int lane) {
  const int r = lane % 8, m = lane / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_f32(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_f32(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, t + (kk * 16 + (m & 1) * 8 + r) * srow<D>() +
                       (2 * dp + (m >> 1)) * 8);
      mma_bf16(out[2 * dp], a, b);
      mma_bf16(out[2 * dp + 1], a, b + 2);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* p, const float acc[D / 8][4],
                                           int r0, int t4, int S, float mul0,
                                           float mul1) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(p + (size_t)r0 * D + col) =
          pack_f32(acc[dn][0] * mul0, acc[dn][1] * mul0);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(p + (size_t)(r0 + 8) * D + col) =
          pack_f32(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

// dk, dv of one (b*h, 64-key tile): each warp owns 16 keys
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
    int causal) {
  __shared__ __align__(16) bf16 qs[BQ * srow<HD>()];
  __shared__ __align__(16) bf16 dos[BQ * srow<HD>()];
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
  load_a_frags<HD>(kf, k + base, kr0, t4, S);
  load_a_frags<HD>(vf, v + base, kr0, t4, S);
  float dkf[8][4], dvf[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkf[j][e] = dvf[j][e] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<HD>(qs, q + base, q0, S);
    load_tile<HD>(dos, dout + base, q0, S);
    if (threadIdx.x < BQ) {
      const bool in = q0 + threadIdx.x < S;
      ls[threadIdx.x] = in ? lp[q0 + threadIdx.x] : 0.f;
      dls[threadIdx.x] = in ? dlp[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float pt[8][4], dst[8][4];      // P^T and dS^T: [16 keys x 64 queries]
    mma_abt<HD>(pt, kf, qs, lane);     // S^T = K.Q^T
    mma_abt<HD>(dst, vf, dos, lane);   // dP^T = V.dO^T
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
    mma_xt<HD>(dvf, pt, dos, lane);    // dV += P^T.dO
    mma_xt<HD>(dkf, dst, qs, lane);    // dK += dS^T.Q
  }
  store_rows<HD>(dk + base, dkf, kr0, t4, S, scale, scale);
  store_rows<HD>(dv + base, dvf, kr0, t4, S, 1.f, 1.f);
}

// dq of one (b*h, 64-query tile): each warp owns 16 queries
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, float scale, int causal) {
  __shared__ __align__(16) bf16 ks[BK * srow<HD>()];
  __shared__ __align__(16) bf16 vs[BK * srow<HD>()];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = (size_t)bh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[4][4], df[4][4];
  load_a_frags<HD>(qf, q + base, r0, t4, S);
  load_a_frags<HD>(df, dout + base, r0, t4, S);
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
    load_tile<HD>(ks, k + base, k0, S);
    load_tile<HD>(vs, v + base, k0, S);
    __syncthreads();

    float sf[8][4], dsf[8][4];      // S and dS: [16 queries x 64 keys]
    mma_abt<HD>(sf, qf, ks, lane);     // S = Q.K^T
    mma_abt<HD>(dsf, df, vs, lane);    // dP = dO.V^T
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
    mma_xt<HD>(dqf, dsf, ks, lane);    // dQ += dS.K
  }
  store_rows<HD>(dq + base, dqf, r0, t4, S, scale, scale);
}

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
