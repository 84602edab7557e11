// Decode-tick (S=1) kernels for paged GPT-2 serving on Hopper (sm_90a).
//
// Replaces three Pallas kernels of deepspeed_tpu/ops/pallas/decode.py:
//   ln_qkv_int8_stacked     (:432, kernel _ln_qkv_stacked_kernel :496)
//   out_ffn_int8_stacked    (:698, kernel _out_ffn_stacked_kernel :1000)
//   decode_attention_paged  (:854, kernel _decode_attn_paged_kernel :931)
// for bf16 activations and weights (int8 codes are a later slice).
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
// - The layer index (a one-element device int32) and the per-layer
//   scales are read on the device, so a layer loop never syncs to the
//   host.
// - Paged attention: one block per (KV head, slot), reading page_table
//   itself (there is no scalar prefetch). Its 8 warps split the slot's
//   live keys in 16-key groups, each warp with its own fp32 online
//   softmax, holding the next group's K/V in registers while it computes
//   the current one (no shared-memory staging, no block barrier in the
//   loop); the block merges the 8 states at the end. A lane pair owns a
//   key for the score (32 dims each), a lane owns 2 dims of P.V. Splitting
//   one slot over several blocks ("flash-decoding") is later work: a
//   long slot still runs on one SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

enum { PRO_COPY = 0, PRO_LN_BF16 = 1, PRO_LN_F32 = 2 };
enum { EPI_BIAS = 0, EPI_RESID_X1 = 1, EPI_GELU = 2, EPI_RESID = 3 };

// bytes of one element of the kernel's input rows
template <int PRO>
__host__ __device__ constexpr int in_bytes() {
  return PRO == PRO_LN_F32 ? 4 : 2;
}

constexpr int kCols = 64;               // a block's column tile
constexpr int kLanesPerRow = kCols / 8;  // 8 lanes x 16 B: one 128-byte line
constexpr int kRowGroups = kThreads / kLanesPerRow;  // rows a block-wide step
constexpr int kStageBatch = 8;           // 16-byte loads in flight a thread
constexpr int kMaxSplit = 8;             // blocks a cluster (portable limit)

// the 8 bf16 values of a 16-byte vector, as floats
__device__ __forceinline__ void unpack8(const uint4 v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

// dst[j] = W row k0 + j * kRowGroups (16 bytes at the thread's columns),
// or zeros at and past row k_hi: one predicated batch of loads.
template <int NB>
__device__ __forceinline__ void load_w_rows(uint4 (&dst)[NB],
                                            const bf16* __restrict__ Wl,
                                            int ncols, int k0, int k_hi) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int k = k0 + j * kRowGroups;
    dst[j] = k < k_hi ? __ldg(reinterpret_cast<const uint4*>(
                            Wl + (size_t)k * ncols))
                      : make_uint4(0, 0, 0, 0);
  }
}

// out[b, n] = epilogue(sum_k u[b, k] * W[layer, k, n]), u = prologue(xin).
//
// Grid (N / 64 column tiles, S): the S blocks of a column tile form one
// thread-block cluster and split K into S slices. In a block, 8 lanes
// cover one 128-byte line of a W row (64 columns) and a warp 4 rows, so
// every load takes whole lines; each thread keeps a [MAXB x 8] fp32
// accumulator, streaming its rows kBatch at a time with the next batch
// in flight. The block folds its warps through shared memory into a
// [B x 64] partial; after a cluster barrier each block sums its share of
// the outputs over the S partials (distributed shared memory, fixed order,
// so the result does not depend on timing) and applies the epilogue.
//
// Shared memory: red [kWarps][MAXB][64] f32, part [MAXB][64] f32, ut
// [kslice][MAXB] bf16 (u transposed: one 16-byte load gives a row's B
// values) and, for a LayerNorm prologue, the whole input rows [B][K] and
// the slice of ln_w, ln_b.
template <int MAXB, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, MAXB <= 8 ? 2 : 1)
    stacked_matvec_kernel(const void* __restrict__ xin,
                          const float* __restrict__ ln_w,
                          const float* __restrict__ ln_b,
                          const bf16* __restrict__ W,
                          const float* __restrict__ scales,
                          const float* __restrict__ bias,
                          const int* __restrict__ layer_ptr,
                          const bf16* __restrict__ resid,
                          bf16* __restrict__ out, float* __restrict__ out_f32,
                          int B, int K, int N, int kslice, float eps) {
  constexpr int kBatch = MAXB <= 8 ? 4 : 2;
  constexpr int kOut = (MAXB * kCols + kThreads - 1) / kThreads;
  constexpr bool kResid = EPI == EPI_RESID_X1 || EPI == EPI_RESID;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  const int k_lo = rank * kslice, k_hi = min(K, k_lo + kslice);
  const int klen = max(k_hi - k_lo, 0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [kWarps][MAXB][kCols]
  float* part = red + kWarps * MAXB * kCols;         // [MAXB][kCols]
  bf16* ut = reinterpret_cast<bf16*>(part + MAXB * kCols);  // [kslice][MAXB]
  unsigned char* xs = reinterpret_cast<unsigned char*>(ut + kslice * MAXB);
  float* lnw = reinterpret_cast<float*>(xs + (size_t)B * K * in_bytes<PRO>());
  float* lnb = lnw + kslice;
  const int l = *layer_ptr;
  const float s = scales[l];

  // this block's share of the tile's B x 64 outputs, and their epilogue
  // operands, requested now so they arrive during the weight stream
  const int n_out = B * kCols, per = (n_out + nsplit - 1) / nsplit;
  const int o_lo = rank * per, o_hi = min(n_out, o_lo + per);
  float pre_b[kOut], pre_r[kOut];
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const int i = o_lo + threadIdx.x + t * kThreads;
    const int b = i / kCols, n = blockIdx.x * kCols + i % kCols;
    const bool ok = i < o_hi && n < N;
    pre_b[t] = ok ? bias[(size_t)l * N + n] : 0.f;
    pre_r[t] = ok && kResid ? __bfloat162float(resid[(size_t)b * N + n])
                            : 0.f;
  }

  if (PRO == PRO_COPY) {
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
    stage_rows(reinterpret_cast<uint4*>(xs),
               reinterpret_cast<const uint4*>(xin),
               B * K * in_bytes<PRO>() / 16, reinterpret_cast<uint4*>(lnw),
               reinterpret_cast<const uint4*>(ln_w + (size_t)l * K + k_lo),
               klen / 4, reinterpret_cast<uint4*>(lnb),
               reinterpret_cast<const uint4*>(ln_b + (size_t)l * K + k_lo),
               klen / 4);
    __syncthreads();
    if (PRO == PRO_LN_BF16)
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
    const bf16* Wl = W + (size_t)l * K * N + n0;
    constexpr int kStep = kBatch * kRowGroups;
    uint4 cur[kBatch], nxt[kBatch];
    load_w_rows<kBatch>(cur, Wl, N, k_lo + rg, k_hi);
    for (int k0 = k_lo + rg; k0 < k_hi; k0 += kStep) {
      if (k0 + kStep < k_hi) load_w_rows<kBatch>(nxt, Wl, N, k0 + kStep, k_hi);
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
    } else {
      out[o] = __float2bfloat16((pre_r[t] + a * s) + bn);
    }
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// Splits K over a cluster of S blocks: the smallest power of two that puts
// at least 160 blocks on the card (H100: 132 SMs, 2 blocks each), at most
// kMaxSplit; each slice a multiple of 8 rows.
inline int split_for(int n_tiles) {
  int S = 1;
  while (S < kMaxSplit && n_tiles * S < 160) S *= 2;
  return S;
}

template <int MAXB, int PRO>
size_t matvec_smem(int B, int K, int kslice) {
  return (size_t)(kWarps + 1) * MAXB * kCols * sizeof(float) +
         (size_t)kslice * MAXB * sizeof(bf16) +
         (PRO == PRO_COPY ? 0
                          : (size_t)B * K * in_bytes<PRO>() +
                                2 * (size_t)kslice * sizeof(float));
}

template <int MAXB, int PRO, int EPI>
cudaError_t launch_matvec(const void* xin, const float* ln_w,
                          const float* ln_b, const bf16* W,
                          const float* scales, const float* bias,
                          const int* layer_ptr, const bf16* resid,
                          bf16* out, float* out_f32,
                          int B, int K, int N, float eps, cudaStream_t st) {
  auto kern = stacked_matvec_kernel<MAXB, PRO, EPI>;
  const int n_tiles = (N + kCols - 1) / kCols;
  const int S = split_for(n_tiles);
  const int kslice = ((K + S - 1) / S + 7) / 8 * 8;
  const size_t smem = matvec_smem<MAXB, PRO>(B, K, kslice);
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
  return cudaLaunchKernelEx(&cfg, kern, xin, ln_w, ln_b, W, scales, bias,
                            layer_ptr, resid, out, out_f32, B, K, N, kslice,
                            eps);
}

template <int PRO, int EPI>
cudaError_t matvec(const void* xin, const float* ln_w, const float* ln_b,
                   const bf16* W, const float* scales, const float* bias,
                   const int* layer_ptr, const bf16* resid, bf16* out,
                   float* out_f32, int B, int K, int N, float eps,
                   cudaStream_t st) {
  if (B <= 8)
    return launch_matvec<8, PRO, EPI>(xin, ln_w, ln_b, W, scales, bias,
                                      layer_ptr, resid, out, out_f32, B, K,
                                      N, eps, st);
  return launch_matvec<16, PRO, EPI>(xin, ln_w, ln_b, W, scales, bias,
                                     layer_ptr, resid, out, out_f32, B, K, N,
                                     eps, st);
}

// ------------------------------------------------- paged decode attention

constexpr int kAttnWarps = 8;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kHeadDim = 64;  // score: 2 lanes x 32 dims; P.V: 2 dims a lane
constexpr int kGroup = 16;    // keys a warp takes per step, one a lane pair
constexpr int kMaxRows = 8;   // R, query rows per KV head

// One 16-key group of a slot's K/V rows, as one warp holds it: lane i has
// K[key0 + i/2][32*(i%2) .. +32) and V[key0 + j][2i .. 2i+2) for all j.
struct KVGroup {
  uint4 k[4];
  uint32_t v[kGroup];
};

__device__ __forceinline__ void load_group(KVGroup& g,
                                           const bf16* __restrict__ kpool,
                                           const bf16* __restrict__ vpool,
                                           size_t base, int lane) {
  const uint4* kr = reinterpret_cast<const uint4*>(
      kpool + base + (lane >> 1) * kHeadDim + (lane & 1) * 32);
#pragma unroll
  for (int i = 0; i < 4; ++i) g.k[i] = __ldg(kr + i);
  const uint32_t* vr = reinterpret_cast<const uint32_t*>(vpool + base) + lane;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) g.v[j] = __ldg(vr + j * (kHeadDim / 2));
}

// One block per (KV head, slot). Each warp walks the slot's live keys in
// 16-key groups (g = warp, warp + 8, ...) with its own fp32 online
// softmax for the R rows, loading the next group while it computes this
// one; the block then merges the 8 partial (max, sum, acc) states.
__global__ void __launch_bounds__(kAttnThreads) decode_attn_paged_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kpool,
    const bf16* __restrict__ vpool, const int* __restrict__ pos_arr,
    const int* __restrict__ pt, const int* __restrict__ layer_ptr,
    bf16* __restrict__ out, int H, int R, int NB, int page,
    int maxp, int rows_per_step, float scale) {
  __shared__ __align__(16) float qs[kMaxRows][kHeadDim];
  __shared__ float part_m[kAttnWarps][kMaxRows];
  __shared__ float part_l[kAttnWarps][kMaxRows];
  __shared__ float part_acc[kAttnWarps][kMaxRows][kHeadDim];
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = pos_arr[b];
  const int npair = R * kHeadDim;
  bf16* ob = out + (size_t)(b * H + h) * npair;

  // idle slot: zeros, and no page is touched (decode.py:959-961 — even a
  // multi-query window must not pull page 0 in)
  if (pos < 0) {
    for (int i = threadIdx.x; i < npair; i += kAttnThreads)
      ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int l = *layer_ptr;
  // keys past pos + max_step are masked for every row, as are pages past
  // the table: the Pallas grid visits page p iff p*page <= pos + max_step
  const int max_step = rows_per_step > 0 ? R / rows_per_step - 1 : 0;
  const int n_keys = min(pos + max_step + 1, maxp * page);
  const int n_groups = (n_keys + kGroup - 1) / kGroup;

  const bf16* qb = q + (size_t)(b * H + h) * npair;
  for (int i = threadIdx.x; i < npair; i += kAttnThreads)
    qs[i / kHeadDim][i % kHeadDim] = __bfloat162float(qb[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const size_t page_elems = (size_t)page * kHeadDim;
  const size_t layer_off = (size_t)l * NB * H * page_elems;
  const int* ptb = pt + (size_t)b * maxp;
  auto group_base = [&](int g) {
    const int key0 = g * kGroup, p = key0 / page;   // page % 16 == 0
    return layer_off + ((size_t)ptb[p] * H + h) * page_elems +
           (size_t)(key0 - p * page) * kHeadDim;
  };

  float m[kMaxRows], lsum[kMaxRows], acc[kMaxRows][2];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m[r] = -1e30f;
    lsum[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }
  KVGroup cur, nxt;
  int g = warp;
  if (g < n_groups) load_group(cur, kpool, vpool, group_base(g), lane);
  for (; g < n_groups; g += kAttnWarps) {
    if (g + kAttnWarps < n_groups)
      load_group(nxt, kpool, vpool, group_base(g + kAttnWarps), lane);
    const int key = g * kGroup + (lane >> 1);
    float kf[32];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w[4] = {cur.k[i].x, cur.k[i].y, cur.k[i].z, cur.k[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kf[8 * i + 2 * c] = __uint_as_float(w[c] << 16);
        kf[8 * i + 2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < R) {
        const float4* qr = reinterpret_cast<const float4*>(&qs[r][half * 32]);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv = qr[i];
          dot = fmaf(qv.x, kf[4 * i], dot);
          dot = fmaf(qv.y, kf[4 * i + 1], dot);
          dot = fmaf(qv.z, kf[4 * i + 2], dot);
          dot = fmaf(qv.w, kf[4 * i + 3], dot);
        }
        dot += __shfl_xor_sync(kFull, dot, 1);
        const int lim = pos + (rows_per_step > 0 ? r / rows_per_step : 0);
        const bool valid = key <= lim;
        const float s = dot * scale;
        float gmax = valid ? s : -1e30f;
#pragma unroll
        for (int o = 2; o < 32; o <<= 1)
          gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, o));
        const float m_new = fmaxf(m[r], gmax);
        const float alpha = __expf(m[r] - m_new);
        const float p = valid ? __expf(s - m_new) : 0.f;
        lsum[r] = lsum[r] * alpha + warp_sum(half ? 0.f : p);
        // p is rounded to bf16 before the V product and summed unrounded,
        // as in the Pallas kernel
        const float pr = __bfloat162float(__float2bfloat16(p));
        float a0 = acc[r][0] * alpha, a1 = acc[r][1] * alpha;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float pj = __shfl_sync(kFull, pr, 2 * j);
          a0 = fmaf(pj, __uint_as_float(cur.v[j] << 16), a0);
          a1 = fmaf(pj, __uint_as_float(cur.v[j] & 0xffff0000u), a1);
        }
        acc[r][0] = a0;
        acc[r][1] = a1;
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
      part_acc[warp][r][2 * lane] = acc[r][0];
      part_acc[warp][r][2 * lane + 1] = acc[r][1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npair; i += kAttnThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
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

}  // namespace

extern "C" {

// out [B, N] = LN(x) . W[layer] * s[layer] + b[layer]
int dstpu_ln_qkv_stacked(const void* x, const void* ln_w, const void* ln_b,
                         const void* w, const void* s, const void* b,
                         const void* layer_ptr, void* out,
                         int B, int E, int N, float eps, void* stream) {
  return (int)matvec<PRO_LN_BF16, EPI_BIAS>(
      x, (const float*)ln_w, (const float*)ln_b, (const bf16*)w,
      (const float*)s, (const float*)b, (const int*)layer_ptr, nullptr,
      (bf16*)out, nullptr, B, E, N, eps, (cudaStream_t)stream);
}

// Three launches on one stream: x1 (bf16 + fp32 copies), h, then out.
int dstpu_out_ffn_stacked(const void* ctx, const void* x, const void* wp,
                          const void* sp, const void* bp, const void* ln_w,
                          const void* ln_b, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, const void* layer_ptr,
                          void* x1, void* x1f, void* h,
                          void* out, int B, int E, int F, float eps,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lp = (const int*)layer_ptr;
  cudaError_t e = matvec<PRO_COPY, EPI_RESID_X1>(
      ctx, nullptr, nullptr, (const bf16*)wp, (const float*)sp,
      (const float*)bp, lp, (const bf16*)x, (bf16*)x1,
      (float*)x1f, B, E, E, eps, st);
  if (e != cudaSuccess) return (int)e;
  e = matvec<PRO_LN_F32, EPI_GELU>(
      x1f, (const float*)ln_w, (const float*)ln_b, (const bf16*)w1,
      (const float*)s1, (const float*)b1, lp, nullptr, (bf16*)h,
      nullptr, B, E, F, eps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)matvec<PRO_COPY, EPI_RESID>(
      h, nullptr, nullptr, (const bf16*)w2, (const float*)s2,
      (const float*)b2, lp, (const bf16*)x1, (bf16*)out, nullptr,
      B, F, E, eps, st);
}

// head dim 64, R <= 8, page % 16 == 0 (the wrapper checks)
int dstpu_decode_attention_paged(const void* q, const void* k_pool,
                                 const void* v_pool, const void* pos,
                                 const void* page_table,
                                 const void* layer_ptr, void* out, int B,
                                 int H, int R, int NB, int page, int maxp,
                                 int rows_per_step,
                                 float scale, void* stream) {
  dim3 grid(H, B);
  decode_attn_paged_kernel<<<grid, kAttnThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
      (const int*)pos, (const int*)page_table, (const int*)layer_ptr,
      (bf16*)out, H, R, NB, page, maxp, rows_per_step, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
