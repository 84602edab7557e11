// All-gather+matmul and matmul+reduce-scatter over peer-mapped ZeRO-3
// shards, for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replace the Pallas kernels of deepspeed_tpu/ops/pallas/fused_collective.py:
// - _ag_matmul_fused (:299; pallas_calls :394 contracting, :480 column
//   blocks): y = x @ all_gather(W shards) (or x @ W^T), the ring's chunks
//   multiplied as they arrive. Here: ag_matmul_kernel.
// - _mm_rs_fused (:491; pallas_call :595): this rank's shard of
//   sum over ranks of lhs^T @ rhs, partial sums riding the ring. Here:
//   mm_rs_partial_kernel, then mm_rs_reduce_kernel after a host barrier.
//
// The TPU kernels move chunks between chips with in-kernel remote DMA and
// a credit semaphore between neighbours. Here each rank's resting shards
// live in a cudaMalloc'd heap that every peer maps through CUDA IPC
// (parallel/symmetric_memory.py), and a kernel is handed the table of the
// n peers' pointers to one region. No kernel waits on a flag another
// process writes: the ranks may share one card, whose processes do not run
// kernels at the same time, so a spin would never end. The phases are
// ordered by host barriers instead (the shards are written before the
// step's barrier; the partials of mm_rs before the barrier that precedes
// mm_rs_reduce).
//
// ag_matmul_kernel. The GEMM's B operand is W (or W^T) assembled on the fly:
// the tile loader resolves which rank owns each element, so the gather is
// fused into the tile loads and no full W is ever written.
// - CONTRACT: the shards cut the contracting dim (chunk c = rows
//   [c*ck, c*ck + ck) of B). The k loop takes the chunks in JAX's ring
//   order, the rank's own chunk first: c = (rank - s) mod n at step s
//   (_ag_matmul_lax :204); a chunk's last tile is masked at its end, so
//   any chunk width works.
// - otherwise the shards cut the output dim (column block c of B); the
//   owner of a column is resolved per 16-byte vector (per element when
//   the widths are not multiples of 8).
// - B_COL: B is read transposed from the shard (dx = dy @ W^T from the
//   same resting shard: no transposed copy).
// - output fp32 or bf16; M is bounded by checks in the kernel, not by a
//   divisor rule, so any M works.
// mm_rs_partial_kernel computes this rank's full [K, N] partial lhs^T @ rhs
// (contracting over the tokens) and writes each element into the slot of
// its destination chunk in this rank's heap slot region ([n, shard]); after
// a barrier mm_rs_reduce_kernel has rank k sum slot k of every peer in
// _mm_rs_lax's order (:245): the partial born on rank k+1 first, rank k's
// own last. The caller casts the fp32 result to the parameter's dtype.
//
// What bounds them on the H100: at GPT-2 large's shapes (M = 2048 tokens a
// rank, [1280, 3840] .. [5120, 1280]) each GEMM is 6.7-26.8 GFLOP over
// 14-41 MB: 1.7-2.3x above the ridge of 295 flop/byte, so the tensor cores.
// mm_rs_reduce is bytes only (n + 1 shard-sized fp32 passes).
//
// What the design does about it, simply: 128x128 block tiles over 32-deep
// k tiles, 8 warps of 64x32, bf16 mma.sync m16n8k16 with ldmatrix
// fragments (csrc/mma.cuh; .trans where the contiguous dim of the operand
// is not k), shared tiles padded against bank conflicts, a 3-stage
// cp.async pipeline (two k tiles in flight while one multiplies; 60 KB of
// dynamic shared memory, two blocks an SM), and the peer pointer table
// copied into shared memory, where resolving a vector's owner indexes it.
// Widths that are not multiples of 8 take element-wise loads
// through registers instead of cp.async. wgmma, TMA and in-kernel
// signalling are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "mma.cuh"

namespace {

constexpr int MAX_RANKS = 8;
constexpr int BM = 128, BN = 128, BK = 32, NT = 256, PAD = 8, STAGES = 3;
// one operand's tile in a stage, the larger of its two layouts ([128][40],
// [32][136]); a stage holds A's and B's, SMEM_BYTES all STAGES
constexpr int TILE_ELEMS = BM * (BK + PAD);
constexpr int SMEM_BYTES = 2 * STAGES * TILE_ELEMS * 2;

struct Peers { const bf16* p[MAX_RANKS]; };
struct PeersF { const float* p[MAX_RANKS]; };

union Vec8 {
  uint4 u;
  bf16 h[8];
};

// vector v (8 elements) of an R x C tile, C contiguous: its row and column
template <int C>
__device__ __forceinline__ void coords(int v, int& r, int& c) {
  r = v / (C / 8);
  c = (v % (C / 8)) * 8;
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// each thread loads 2 vectors of a 512-vector (4096-element) tile into a
// shared stage: with VEC one 16-byte cp.async each (the 8 elements share
// validity and owner; an invalid vector is zero-filled), otherwise element
// by element through registers
template <bool VEC, int C, class Src>
__device__ __forceinline__ void load_tile(const Src& s, bf16* smem) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int r, c;
    coords<C>(threadIdx.x + q * NT, r, c);
    bf16* dst = smem + r * (C + PAD) + c;
    if (VEC) {
      const bool ok = s.ok(r, c);
      cp_async16(dst, ok ? s.at(r, c) : s.any(), ok);
    } else {
      Vec8 t;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        t.h[e] = s.ok(r, c + e) ? *s.at(r, c + e) : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = t.u;
    }
  }
}

// one BK-deep step of the block's 128x128 product from shared tiles.
// A is [BM][BK] (A_COL: [BK][BM]); B is [BK][BN] (B_COL: [BN][BK]).
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void mma_tile(const bf16* sA, const bf16* sB,
                                         float (&acc)[4][4][4], int wm,
                                         int wn, int lane) {
  const int i = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = wm * 64 + mi * 16;
      if (A_COL)
        ldsm_x4_t(a[mi], sA + (kk + r8 + 8 * (i >> 1)) * (BM + PAD) + m +
                             8 * (i & 1));
      else
        ldsm_x4(a[mi], sA + (m + (lane & 15)) * (BK + PAD) + kk +
                           (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n = wn * 32 + np * 16;
      uint32_t t[4];
      if (B_COL)
        ldsm_x4(t, sB + (n + r8 + 8 * (i >> 1)) * (BK + PAD) + kk +
                       8 * (i & 1));
      else
        ldsm_x4_t(t, sB + (kk + r8 + 8 * (i & 1)) * (BN + PAD) + n +
                         8 * (i >> 1));
      b[2 * np][0] = t[0];
      b[2 * np][1] = t[1];
      b[2 * np + 1][0] = t[2];
      b[2 * np + 1][1] = t[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// the element (r, c) of the tile's coordinates -> its global address, and
// whether it lies inside the operand (zero-filled otherwise)

struct SrcRows {            // a row-major [rows, cols] operand, rows r0 + r
  const bf16* p;
  int rows, ld, r0, c0, cend;
  __device__ bool ok(int r, int c) const {
    return r0 + r < rows && c0 + c < cend;
  }
  __device__ const bf16* at(int r, int c) const {
    return p + (size_t)(r0 + r) * ld + c0 + c;
  }
  __device__ const bf16* any() const { return p; }
};

// B of a contracting chunk held by one rank: B_ROW tiles are [k][n] of a
// [ck, N] shard, B_COL tiles [n][k] of an [N, ck] shard
template <bool B_COL>
struct SrcChunk {
  const bf16* p;
  int ld, ck, N, kl0, n0;
  __device__ bool ok(int r, int c) const {
    return B_COL ? (n0 + r < N && kl0 + c < ck)
                 : (kl0 + r < ck && n0 + c < N);
  }
  __device__ const bf16* at(int r, int c) const {
    return B_COL ? p + (size_t)(n0 + r) * ld + kl0 + c
                 : p + (size_t)(kl0 + r) * ld + n0 + c;
  }
  __device__ const bf16* any() const { return p; }
};

// B whose output columns are cut in blocks of ck: column n belongs to rank
// n / ck. B_ROW tiles are [k][n] of [K, ck] shards, B_COL tiles [n][k] of
// [ck, K] shards
template <bool B_COL>
struct SrcColumns {
  const bf16* const* w;     // the n ranks' pointers, in shared memory
  int ld, ck, N, K, k0, n0;
  __device__ bool ok(int r, int c) const {
    return B_COL ? (n0 + r < N && k0 + c < K) : (k0 + r < K && n0 + c < N);
  }
  __device__ const bf16* at(int r, int c) const {
    const int n = B_COL ? n0 + r : n0 + c;
    const int k = B_COL ? k0 + c : k0 + r;
    const int o = n / ck, nl = n - o * ck;
    return B_COL ? w[o] + (size_t)nl * ld + k : w[o] + (size_t)k * ld + nl;
  }
  __device__ const bf16* any() const { return w[0]; }
};

template <bool VEC, bool B_COL, bool CONTRACT, bool OUT_F32>
__global__ void __launch_bounds__(NT, 2)
    ag_matmul_kernel(const bf16* __restrict__ x, Peers w, void* out, int M,
                     int K, int N, int ck, int ldb, int rank, int nranks) {
  constexpr int CB = B_COL ? BK : BN;     // contiguous width of the B tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ const bf16* peers[MAX_RANKS];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * TILE_ELEMS;
  if (threadIdx.x < MAX_RANKS) peers[threadIdx.x] = w.p[threadIdx.x];
  __syncthreads();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int per_chunk = CONTRACT ? (ck + BK - 1) / BK : 1;
  const int T = CONTRACT ? nranks * per_chunk : (K + BK - 1) / BK;

  auto load = [&](int t) {
    bf16* a = sA + (t % STAGES) * TILE_ELEMS;
    bf16* b = sB + (t % STAGES) * TILE_ELEMS;
    if (CONTRACT) {
      const int s = t / per_chunk, kt = t - s * per_chunk;
      const int c = (rank - s + nranks) % nranks;   // the ring's order
      const int k0 = c * ck + kt * BK;
      load_tile<VEC, BK>(SrcRows{x, M, K, m0, k0, c * ck + ck}, a);
      load_tile<VEC, CB>(SrcChunk<B_COL>{peers[c], ldb, ck, N, kt * BK, n0},
                         b);
    } else {
      const int k0 = t * BK;
      load_tile<VEC, BK>(SrcRows{x, M, K, m0, k0, K}, a);
      load_tile<VEC, CB>(SrcColumns<B_COL>{peers, ldb, ck, N, K, k0, n0}, b);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // STAGES-deep pipeline: tile t + STAGES - 1 is in flight while tile t
  // multiplies; one barrier a tile frees the stage the next load takes
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < T) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < T) load(t + STAGES - 1);
    cp_async_commit();
    mma_tile<false, B_COL>(sA + (t % STAGES) * TILE_ELEMS,
                           sB + (t % STAGES) * TILE_ELEMS, acc, wm, wn, lane);
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          const float v = acc[mi][ni][2 * h + e];
          const size_t o = (size_t)row * N + col + e;
          if (OUT_F32)
            static_cast<float*>(out)[o] = v;
          else
            static_cast<bf16*>(out)[o] = __float2bfloat16(v);
        }
      }
}

// lhs^T as the GEMM's A: tiles [t][i] of the row-major [M tokens, K] lhs
struct SrcCols {
  const bf16* p;
  int rows, cols, r0, c0;
  __device__ bool ok(int r, int c) const {
    return r0 + r < rows && c0 + c < cols;
  }
  __device__ const bf16* at(int r, int c) const {
    return p + (size_t)(r0 + r) * cols + c0 + c;
  }
  __device__ const bf16* any() const { return p; }
};

template <bool VEC, bool SHARD1>
__global__ void __launch_bounds__(NT, 2)
    mm_rs_partial_kernel(const bf16* __restrict__ lhs,
                         const bf16* __restrict__ rhs, float* __restrict__ out,
                         int M, int K, int N, int ck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * TILE_ELEMS;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int T = (M + BK - 1) / BK;

  auto load = [&](int t) {
    load_tile<VEC, BM>(SrcCols{lhs, M, K, t * BK, i0},
                       sA + (t % STAGES) * TILE_ELEMS);
    load_tile<VEC, BN>(SrcCols{rhs, M, N, t * BK, j0},
                       sB + (t % STAGES) * TILE_ELEMS);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < T) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < T) load(t + STAGES - 1);
    cp_async_commit();
    mma_tile<true, false>(sA + (t % STAGES) * TILE_ELEMS,
                          sB + (t % STAGES) * TILE_ELEMS, acc, wm, wn, lane);
  }

  // element (i, j) of the [K, N] partial goes to the slot of its
  // destination chunk: shard dim 0 makes the slots the row blocks of [K, N]
  // itself; shard dim 1 stores column block c as slot c, [K, ck]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
        const int j = j0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        if (i >= K) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j + e;
          if (jj >= N) continue;
          size_t o;
          if (SHARD1) {
            const int c = jj / ck;
            o = (size_t)c * K * ck + (size_t)i * ck + (jj - c * ck);
          } else {
            o = (size_t)i * N + jj;
          }
          out[o] = acc[mi][ni][2 * h + e];
        }
      }
}

// out[e] = sum over s = 1..n of slot (rank + s) mod n, chunk `rank`: the
// partial born on rank+1 first, this rank's own last
template <bool VEC>
__global__ void mm_rs_reduce_kernel(PeersF s, float* __restrict__ out,
                                    long long shard, int rank, int nranks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long base = (long long)rank * shard;
  if (VEC) {
    const long long n4 = shard / 4;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < n4; e += stride) {
      float4 acc = reinterpret_cast<const float4*>(
          s.p[(rank + 1) % nranks] + base)[e];
      for (int j = 2; j <= nranks; ++j) {
        const float4 v = reinterpret_cast<const float4*>(
            s.p[(rank + j) % nranks] + base)[e];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      reinterpret_cast<float4*>(out)[e] = acc;
    }
  } else {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < shard; e += stride) {
      float acc = s.p[(rank + 1) % nranks][base + e];
      for (int j = 2; j <= nranks; ++j)
        acc += s.p[(rank + j) % nranks][base + e];
      out[e] = acc;
    }
  }
}

// dynamic shared memory above 48 KB must be allowed kernel by kernel
template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <bool VEC, bool SHARD1>
cudaError_t launch_partial(const bf16* l, const bf16* r, float* o, int M,
                           int K, int N, int ck, cudaStream_t st) {
  auto kernel = mm_rs_partial_kernel<VEC, SHARD1>;
  const cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM);
  kernel<<<grid, NT, SMEM_BYTES, st>>>(l, r, o, M, K, N, ck);
  return cudaGetLastError();
}

template <bool VEC, bool B_COL, bool CONTRACT>
cudaError_t launch_ag(const bf16* x, const Peers& w, void* out, int out_f32,
                      int M, int K, int N, int ck, int ldb, int rank,
                      int nranks, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (out_f32) {
    auto kernel = ag_matmul_kernel<VEC, B_COL, CONTRACT, true>;
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, SMEM_BYTES, st>>>(x, w, out, M, K, N, ck, ldb, rank,
                                         nranks);
  } else {
    auto kernel = ag_matmul_kernel<VEC, B_COL, CONTRACT, false>;
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, SMEM_BYTES, st>>>(x, w, out, M, K, N, ck, ldb, rank,
                                         nranks);
  }
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_ag_vec(const bf16* x, const Peers& w, void* out,
                          int out_f32, int M, int K, int N, int ck, int ldb,
                          int rank, int nranks, int contracting, int b_col,
                          cudaStream_t st) {
  if (contracting)
    return b_col ? launch_ag<VEC, true, true>(x, w, out, out_f32, M, K, N, ck,
                                              ldb, rank, nranks, st)
                 : launch_ag<VEC, false, true>(x, w, out, out_f32, M, K, N,
                                               ck, ldb, rank, nranks, st);
  return b_col ? launch_ag<VEC, true, false>(x, w, out, out_f32, M, K, N, ck,
                                             ldb, rank, nranks, st)
               : launch_ag<VEC, false, false>(x, w, out, out_f32, M, K, N, ck,
                                              ldb, rank, nranks, st);
}

}  // namespace

// y [M, N] = x [M, K] @ B, B assembled from the n ranks' shards (see the
// header): `shards` is a host array of n device pointers, `ldb` the row
// stride of a shard, `ck` the chunk width (of B's rows when contracting,
// of its columns otherwise).
extern "C" int dstpu_ag_matmul(const void* x, const void* shards, void* out,
                               int nranks, int rank, int M, int K, int N,
                               int ck, int ldb, int contracting, int b_col,
                               int out_f32, int vec, void* stream) {
  if (nranks < 1 || nranks > MAX_RANKS || rank < 0 || rank >= nranks ||
      M < 1 || K < 1 || N < 1 || ck < 1 || ldb < 1)
    return (int)cudaErrorInvalidValue;
  const void* const* table = static_cast<const void* const*>(shards);
  Peers w;
  for (int j = 0; j < MAX_RANKS; ++j)
    w.p[j] = j < nranks ? static_cast<const bf16*>(table[j]) : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  return vec ? (int)launch_ag_vec<true>(xb, w, out, out_f32, M, K, N, ck, ldb,
                                        rank, nranks, contracting, b_col, st)
             : (int)launch_ag_vec<false>(xb, w, out, out_f32, M, K, N, ck,
                                         ldb, rank, nranks, contracting, b_col,
                                         st);
}

// out: this rank's [n, shard] fp32 slot region; lhs [M, K], rhs [M, N]
extern "C" int dstpu_mm_rs_partial(const void* lhs, const void* rhs,
                                   void* out, int M, int K, int N, int ck,
                                   int shard1, int vec, void* stream) {
  if (M < 1 || K < 1 || N < 1 || ck < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* l = static_cast<const bf16*>(lhs);
  const bf16* r = static_cast<const bf16*>(rhs);
  float* o = static_cast<float*>(out);
  if (vec)
    return shard1 ? (int)launch_partial<true, true>(l, r, o, M, K, N, ck, st)
                  : (int)launch_partial<true, false>(l, r, o, M, K, N, ck, st);
  return shard1 ? (int)launch_partial<false, true>(l, r, o, M, K, N, ck, st)
                : (int)launch_partial<false, false>(l, r, o, M, K, N, ck, st);
}

// out [shard] fp32 = sum of chunk `rank` of the n peers' slot regions
extern "C" int dstpu_mm_rs_reduce(const void* slots, void* out, int shard,
                                  int rank, int nranks, int vec,
                                  void* stream) {
  if (nranks < 1 || nranks > MAX_RANKS || rank < 0 || rank >= nranks ||
      shard < 1)
    return (int)cudaErrorInvalidValue;
  const void* const* table = static_cast<const void* const*>(slots);
  PeersF s;
  for (int j = 0; j < MAX_RANKS; ++j)
    s.p[j] = j < nranks ? static_cast<const float*>(table[j]) : nullptr;
  const long long work = vec ? shard / 4 : shard;
  const int blocks = (int)(work / 256 + 1 < 1056 ? work / 256 + 1 : 1056);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    mm_rs_reduce_kernel<true><<<blocks, 256, 0, st>>>(
        s, static_cast<float*>(out), shard, rank, nranks);
  else
    mm_rs_reduce_kernel<false><<<blocks, 256, 0, st>>>(
        s, static_cast<float*>(out), shard, rank, nranks);
  return (int)cudaGetLastError();
}

// -- the symmetric heap: cudaMalloc'd memory shared through CUDA IPC ---------
// Sizes come in 256-byte blocks, pointers out through a void** passed as
// void*, so that every entry point takes ints and pointers alone.

extern "C" int dstpu_heap_alloc(int device, int blocks, void* out) {
  void** p = static_cast<void**>(out);
  const size_t bytes = (size_t)blocks * 256;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMalloc(p, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(*p, 0, bytes);
}

extern "C" int dstpu_heap_free(int device, void* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFree(p);
}

// `handle` holds `capacity` bytes (CUDA_IPC_HANDLE_SIZE, 64)
extern "C" int dstpu_ipc_get_handle(void* p, void* handle, int capacity) {
  if (capacity < (int)sizeof(cudaIpcMemHandle_t))
    return (int)cudaErrorInvalidValue;
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, p);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

extern "C" int dstpu_ipc_open(int device, const void* handle, void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(static_cast<void**>(out), h,
                                   cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int dstpu_ipc_close(int device, void* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaIpcCloseMemHandle(p);
}
