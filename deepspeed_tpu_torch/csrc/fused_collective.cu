// All-gather+matmul and matmul+reduce-scatter over peer-mapped ZeRO-3
// shards, for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replace the Pallas kernels of deepspeed_tpu/ops/pallas/fused_collective.py:
// - _ag_matmul_fused (:299; pallas_calls :394 contracting, :480 column
//   blocks): y = x @ all_gather(W shards) (or x @ W^T), the ring's chunks
//   multiplied as they arrive. Here: gemm_tma_kernel<BN, false, B_MN>
//   (entry dstpu_gemm_tma).
// - _mm_rs_fused (:491; pallas_call :595): this rank's shard of the sum
//   over ranks of lhs^T @ rhs, partial sums riding the ring. Here: the
//   partial lhs^T @ rhs of this rank into its n slots,
//   gemm_tma_kernel<BN, true, true> (dstpu_gemm_tma), then
//   mm_rs_reduce_kernel after a host barrier. In the ZeRO-3 backward a
//   layer's partials (and its packed groups' flat gradients) share one
//   exchange region [n, run], slot c of every leaf in region row c, and
//   one barrier and one mm_rs_reduce_kernel launch reduce them all
//   (parallel/overlap.py ReduceScatterBatch).
//
// The TPU kernels move chunks between chips with in-kernel remote DMA and
// a credit semaphore between neighbours. Here each rank's resting shards
// live in a cudaMalloc'd heap that every peer maps through CUDA IPC
// (parallel/symmetric_memory.py), and a kernel is handed the n peers'
// pointers to one region. No kernel waits on a flag another process
// writes: the ranks may share one card, whose processes do not run kernels
// at the same time, so a spin would never end. Host barriers order the
// phases instead (the shards are written before the step's barrier; the
// partials of mm_rs before the barrier that precedes mm_rs_reduce).
//
// What bounds them on the H100: at GPT-2 large's shapes (M = 2048 tokens a
// rank, [1280, 3840] .. [5120, 1280]) each GEMM is 6.7-26.8 GFLOP over
// 14-41 MB, 1.7-2.3x above the ridge of 295 flop/byte: the tensor cores.
// mm_rs_reduce is bytes only: n fp32 reads of the run and one write of
// each element in its leaf's dtype.
//
// What gemm_tma_kernel does about it:
// - Warp specialisation. 384 threads: warpgroup 0 is the producer (one
//   thread issues TMA loads into a ring of 4-8 shared-memory stages, each
//   guarded by a full and an empty mbarrier; it gives its registers away
//   with setmaxnreg), warpgroups 1 and 2 the consumers: each owns 64 rows
//   of a 128 x BN tile, runs wgmma m64nBNk16 on the stages that arrived
//   and keeps its fp32 sum in registers. A stage holds BK = 64: one
//   128-byte swizzled row of bf16, the swizzle TMA writes and wgmma reads
//   (sm90.cuh). One product a stage is kept in flight (wait_group 1)
//   before the stage is released.
// - The gather lives in the producer: the host encodes one tensor map for
//   x (or lhs) and one for each of the n peer shards (a __grid_constant__
//   parameter). Contracting shards: the k loop walks the chunks in JAX's
//   ring order, c = (rank - s) mod n (_ag_matmul_lax :204), the rank's own
//   chunk first; k tile t of chunk c loads from chunk c's map, whose own
//   bounds zero-fill a ragged chunk end (A's box then reads the next
//   chunk's columns, which the zero rows of B cancel). Column-cut shards:
//   the N tiles are laid out chunk by chunk, so that no tile straddles two
//   owners and a tile picks its map once; the last tile of a chunk that
//   BN does not divide is masked.
// - Transposed operands without copies: wgmma reads either major order.
//   B_COL (dx = dy @ W^T from the resting shard) loads the shard's tiles
//   as stored (K-major B); a W shard [k, n] is MN-major B; mm_rs's A =
//   lhs^T comes from the row-major [tokens, K] lhs as MN-major A and its B
//   = rhs [tokens, N] as MN-major B.
// - A persistent grid, one block an SM walking the tiles (tile = block +
//   i * grid), so one tile's epilogue overlaps the next tile's loads. BN
//   is picked per leaf from {256, 192, 128, 64} by the waves it takes
//   (ops/cuda/fused_collective.py tile_plan, which the launch reads). At
//   M 2048, 4 shards, 132 SMs:
//     leaf, GEMM                        BN   tiles  waves
//     ag c_attn y (N 3840, chunks 960)  256   256    1.94
//     ag c_attn dx (N 1280, K 3840)     192   112    0.85
//     ag attn c_proj y; dx              192   112    0.85; 128 0.97
//     ag c_fc y; mlp c_proj dx          128   640    4.85
//     ag c_fc dx; mlp c_proj y          192   112    0.85
//     mm_rs c_attn (slots of 960)       192   200    1.52
//     mm_rs attn c_proj                 128   100    0.76
//     mm_rs c_fc; mlp c_proj            256   200    1.52
//   (The attn c_proj products are wave-limited at any BN: 100-128 tiles.)
// - The epilogue stages each warp's 16 rows a 128-byte slab at a time in
//   shared memory and writes 16-byte vectors. Its addresses are
//   out + chunk * o_chunk + row * ldo + column in chunk, the chunk one a
//   tile; mm_rs under shard dim 0 cuts the rows instead (row chunks of rc
//   rows, r_chunk apart), so its slots ([K, ck] under shard dim 1, [ck,
//   N] row blocks under shard dim 0) may lie a region row apart.
//
// Shapes TMA cannot describe (a width or chunk not a multiple of 8, a base
// not 16-byte aligned) go, by the wrapper's shape test, to this file's
// mma.sync kernels (ag_matmul_kernel, mm_rs_partial_kernel; entries
// dstpu_ag_matmul, dstpu_mm_rs_partial; launch counts ag_matmul_mma and
// mm_rs_partial_mma): 128x128 tiles over 32-deep k steps, mma.sync
// m16n8k16 with ldmatrix fragments (csrc/mma.cuh), a 3-stage cp.async
// pipeline, and each 16-byte vector's owner resolved in the tile loader
// (element loads where widths are not multiples of 8).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma.cuh"
#include "sm90.cuh"

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
                         int M, int K, int N, int ck, long long slot) {
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
  // destination chunk, slot c at c * slot: shard dim 0 makes slot c the
  // row block c of [K, N], [ck, N]; shard dim 1 column block c, [K, ck]
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
            o = (size_t)c * slot + (size_t)i * ck + (jj - c * ck);
          } else {
            const int c = i / ck;
            o = (size_t)c * slot + (size_t)(i - c * ck) * N + jj;
          }
          out[o] = acc[mi][ni][2 * h + e];
        }
      }
}

// The destinations of one reduce: entry i takes elements [off, off + len)
// of the reduced run, written at ptr as fp32 (f32) or bf16 (rounded to
// nearest even, as a cast does). Entries lie in increasing order and do
// not overlap; the run's elements between them (alignment padding) are
// neither read nor written.
constexpr int MAX_OUTS = 16;
struct ReduceOut {
  long long off, len;
  void* ptr;
  int f32;
};
struct ReduceOuts {
  ReduceOut e[MAX_OUTS];
  int n;
};

__device__ __forceinline__ void store4(void* ptr, long long i, int f32,
                                       float4 v) {
  if (f32) {
    reinterpret_cast<float4*>(ptr)[i] = v;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    reinterpret_cast<uint2*>(ptr)[i] =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                   *reinterpret_cast<uint32_t*>(&hi));
  }
}

// The entry holding unit u (W elements) of the run: the cursor ``i`` only
// moves forward, as a thread's units increase. -1 when u lies in the
// padding before entry i; outs.n past the last entry.
template <int W>
__device__ __forceinline__ int entry_of(const ReduceOuts& outs, int& i,
                                        long long u) {
  while (i < outs.n && u * W >= outs.e[i].off + outs.e[i].len) ++i;
  if (i == outs.n) return i;
  return u * W < outs.e[i].off ? -1 : i;
}

// units a thread takes an iteration of the reduce, a grid's width apart:
// at GPT-2 large's layer on an H100 four beat one, two, three, six and
// eight (more bytes in flight a thread, until registers cut occupancy)
constexpr int kReduceUnits = 4;

// Row `rank` of the NR peers' [NR, run] fp32 regions summed, element by
// element, in the ring's order: the partial born on rank+1 first, this
// rank's own last (overlap.ring_order_sum). One grid-stride pass over the
// run (16-byte loads and stores when VEC: every offset, length and
// pointer a multiple of 4 elements), each element read once from each
// peer and written once, at its entry's pointer in the entry's dtype. A
// thread takes kReduceUnits units an iteration and issues all their loads
// before it adds: kReduceUnits * NR 16-byte loads in flight a thread, at
// the occupancy the launch fills the card with.
template <int NR, bool VEC>
__global__ void __launch_bounds__(256)
    mm_rs_reduce_kernel(PeersF s, const __grid_constant__ ReduceOuts outs,
                        long long run, int rank) {
  using V = typename std::conditional<VEC, float4, float>::type;
  constexpr int W = VEC ? 4 : 1, U = kReduceUnits;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_units = run / W;
  const V* src[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j)
    src[j] = reinterpret_cast<const V*>(s.p[(rank + 1 + j) % NR] +
                                        (long long)rank * run);
  int cur[U];
#pragma unroll
  for (int k = 0; k < U; ++k) cur[k] = 0;
  for (long long u0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       u0 < n_units; u0 += U * stride) {
    int e[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long u = u0 + k * stride;
      e[k] = u < n_units ? entry_of<W>(outs, cur[k], u) : outs.n;
    }
    if (e[0] == outs.n) break;
    V v[U][NR];
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (e[k] >= 0 && e[k] < outs.n)
          v[k][j] = __ldcs(src[j] + u0 + k * stride);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (e[k] < 0 || e[k] >= outs.n) continue;
      V acc = v[k][0];
#pragma unroll
      for (int j = 1; j < NR; ++j) {
        if constexpr (VEC) {
          acc.x += v[k][j].x;
          acc.y += v[k][j].y;
          acc.z += v[k][j].z;
          acc.w += v[k][j].w;
        } else {
          acc += v[k][j];
        }
      }
      const ReduceOut& o = outs.e[e[k]];
      const long long at = u0 + k * stride - o.off / W;
      if constexpr (VEC) {
        store4(o.ptr, at, o.f32, acc);
      } else if (o.f32) {
        static_cast<float*>(o.ptr)[at] = acc;
      } else {
        static_cast<bf16*>(o.ptr)[at] = __float2bfloat16_rn(acc);
      }
    }
  }
}

template <int NR, bool VEC>
cudaError_t launch_reduce(const PeersF& s, const ReduceOuts& outs,
                          long long run, int rank, long long units,
                          cudaStream_t st) {
  auto kernel = mm_rs_reduce_kernel<NR, VEC>;
  static int per_sm = 0;        // resident blocks an SM, asked once
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, 256, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long most = (long long)per_sm * sm90::sm_count();
  const long long want = units / (256 * kReduceUnits) + 1;
  kernel<<<(int)(want < most ? want : most), 256, 0, st>>>(s, outs, run,
                                                           rank);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_reduce_n(int nranks, const PeersF& s,
                            const ReduceOuts& outs, long long run, int rank,
                            long long units, cudaStream_t st) {
  switch (nranks) {
    case 1: return launch_reduce<1, VEC>(s, outs, run, rank, units, st);
    case 2: return launch_reduce<2, VEC>(s, outs, run, rank, units, st);
    case 3: return launch_reduce<3, VEC>(s, outs, run, rank, units, st);
    case 4: return launch_reduce<4, VEC>(s, outs, run, rank, units, st);
    case 5: return launch_reduce<5, VEC>(s, outs, run, rank, units, st);
    case 6: return launch_reduce<6, VEC>(s, outs, run, rank, units, st);
    case 7: return launch_reduce<7, VEC>(s, outs, run, rank, units, st);
    case 8: return launch_reduce<8, VEC>(s, outs, run, rank, units, st);
    default: return cudaErrorInvalidValue;
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
                           int K, int N, int ck, long long slot,
                           cudaStream_t st) {
  auto kernel = mm_rs_partial_kernel<VEC, SHARD1>;
  const cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM);
  kernel<<<grid, NT, SMEM_BYTES, st>>>(l, r, o, M, K, N, ck, slot);
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


// -- the TMA-fed, warp-specialised wgmma GEMM -------------------------------

constexpr int TBM = 128, TBK = 64, TNT = 384;
constexpr int SMEM_CAP = 232448;           // a block's dynamic shared memory
constexpr int EPI_ROW = 160;               // staging row: 128 bytes + pad
constexpr int EPI_BYTES = 8 * 16 * EPI_ROW;  // 8 consumer warps x 16 rows
constexpr int BOX = TBK * 64 * 2;          // one [64][64] bf16 box, 8 KB

template <int BN>
struct TmaCfg {
  static constexpr int A_BYTES = TBM * TBK * 2;
  static constexpr int STAGE = A_BYTES + BN * TBK * 2;
  static constexpr int FIT = (SMEM_CAP - 1024 - EPI_BYTES - 256) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  // 1024 for aligning the swizzled stages, 256 for the mbarriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI_BYTES + 256;
};

struct TmaMaps {
  CUtensorMap a;              // x [M, K], or lhs [tokens, K]
  CUtensorMap b[MAX_RANKS];   // the n peers' shards, or rhs [tokens, N]
};

// the tile walk, as tile_plan (ops/cuda/fused_collective.py) lays it out
struct GemmPlan {
  int M;            // output rows (A's MN extent)
  int m_tiles;      // ceil(M / TBM)
  int nt_chunk;     // N tiles in each chunk of the N layout
  int cw;           // a chunk's width in N (N itself when one chunk)
  int tiles;        // m_tiles x chunks x nt_chunk
  int k_chunks;     // contracting chunks walked in ring order (1: none)
  int kpc;          // k tiles in each contracting chunk
  int a_chunk;      // A's k offset from one contracting chunk to the next
  int rank;
  int b_by_chunk;   // N chunk c reads map c at local columns (else map 0
                    // at c * cw)
  int ldo;          // output row stride
  long long o_chunk;  // output offset from one N chunk to the next
  int out_f32;
  int rc;           // rows a row chunk (0: the rows are one run)
  long long r_chunk;  // output offset from one row chunk to the next
};

// this warp's 16 rows of the tile, one 128-byte slab of columns at a time
// through its shared staging rows, out in 16-byte vectors
template <int BN, class OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           unsigned char* stage, OutT* out,
                                           const GemmPlan& p, int row0,
                                           int col0) {
  constexpr int PER = 128 / (int)sizeof(OutT);  // columns a slab
  constexpr int EV = 16 / (int)sizeof(OutT);    // elements a vector
  const int lane = threadIdx.x & 31, r = lane >> 2, q = lane & 3;
  // the output offsets of the 4 rows this lane stores (rows lane / 8 + 4 k
  // of the warp's 16), worked out once a tile: a row chunk costs a
  // division
  size_t ro[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = row0 + (lane >> 3) + 4 * k;
    ro[k] = p.rc ? (size_t)(row / p.rc) * p.r_chunk +
                       (size_t)(row % p.rc) * p.ldo
                 : (size_t)row * p.ldo;
  }
#pragma unroll
  for (int slab = 0; slab < BN / PER; ++slab) {
#pragma unroll
    for (int jj = 0; jj < PER / 8; ++jj) {
      const int j = slab * (PER / 8) + jj;
      const int off = (jj * 8 + 2 * q) * (int)sizeof(OutT);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* dst = stage + (r + 8 * h) * EPI_ROW + off;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (sizeof(OutT) == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(dst) = pack_f32(v0, v1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = (lane >> 3) + 4 * k, cv = lane & 7;
      const int row = row0 + rr, col = col0 + slab * PER + cv * EV;
      if (row < p.M && col < p.cw)
        *reinterpret_cast<uint4*>(out + ro[k] + col) =
            *reinterpret_cast<const uint4*>(stage + rr * EPI_ROW + cv * 16);
    }
    __syncwarp();
  }
}

// out [M, N-layout] = A [M, K] @ B [K, N], A and B fed by TMA from `maps`
// along `p`'s walk. A_MN / B_MN: the operand is MN-major in memory (and in
// its shared tiles).
template <int BN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(TNT, 1)
    gemm_tma_kernel(const __grid_constant__ TmaMaps maps, const GemmPlan p,
                    void* __restrict__ out) {
  using C = TmaCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* epi = smem + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + EPI_BYTES);
  uint64_t* empty = full + C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int T = p.k_chunks * p.kpc;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int mt = tile % p.m_tiles, nt = tile / p.m_tiles;
      const int c = nt / p.nt_chunk;
      const int m0 = mt * TBM;
      const int bn0 = (p.b_by_chunk ? 0 : c * p.cw) +
                      (nt - c * p.nt_chunk) * BN;
      for (int t = 0; t < T; ++t) {
        const int step = t / p.kpc, kt = t - step * p.kpc;
        // the ring's order: this rank's own chunk first
        const int kc = (p.rank - step + p.k_chunks) % p.k_chunks;
        const int ak = kc * p.a_chunk + kt * TBK, bk = kt * TBK;
        const CUtensorMap* bmap =
            &maps.b[p.k_chunks > 1 ? kc : (p.b_by_chunk ? c : 0)];
        sm90::mbar_wait(&empty[s], ph ^ 1);
        sm90::mbar_expect_tx(&full[s], C::STAGE);
        unsigned char* sa = smem + s * C::STAGE;
        unsigned char* sb = sa + C::A_BYTES;
        if (A_MN) {
          sm90::tma_load_2d(sa, &maps.a, m0, ak, &full[s]);
          sm90::tma_load_2d(sa + BOX, &maps.a, m0 + 64, ak, &full[s]);
        } else {
          sm90::tma_load_2d(sa, &maps.a, ak, m0, &full[s]);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_2d(sb + j * BOX, bmap, bn0 + 64 * j, bk,
                              &full[s]);
        } else {
          sm90::tma_load_2d(sb, bmap, bk, bn0, &full[s]);
        }
        if (++s == C::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int half = wg - 1;                  // rows half * 64 .. + 63
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    unsigned char* stage = epi + (half * 4 + warp) * 16 * EPI_ROW;
    int s = 0;
    uint32_t ph = 0;
    float acc[BN / 2];
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int mt = tile % p.m_tiles, nt = tile / p.m_tiles;
      const int c = nt / p.nt_chunk;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int t = 0; t < T; ++t) {
        sm90::mbar_wait(&full[s], ph);
        const unsigned char* sa =
            smem + s * C::STAGE + half * (A_MN ? BOX : 64 * 128);
        const unsigned char* sb = smem + s * C::STAGE + C::A_BYTES;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk) {
          const uint64_t da = A_MN ? sm90::wgmma_desc(sa + kk * 2048, BOX, 1024)
                                   : sm90::wgmma_desc(sa + kk * 32, 16, 1024);
          const uint64_t db = B_MN ? sm90::wgmma_desc(sb + kk * 2048, BOX, 1024)
                                   : sm90::wgmma_desc(sb + kk * 32, 16, 1024);
          sm90::wgmma<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        if (t > 0) {       // the previous stage's products are done
          sm90::wgmma_wait<1>();
          sm90::fence_regs(acc);
          if (lane == 0) sm90::mbar_arrive(&empty[prev]);
        }
        prev = s;
        if (++s == C::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);
      const int row0 = mt * TBM + half * 64 + warp * 16;
      const int col0 = (nt - c * p.nt_chunk) * BN;
      if (p.out_f32)
        store_tile<BN>(acc, stage, static_cast<float*>(out) + c * p.o_chunk,
                       p, row0, col0);
      else
        store_tile<BN>(acc, stage, static_cast<bf16*>(out) + c * p.o_chunk,
                       p, row0, col0);
    }
  }
}

template <int BN, bool A_MN, bool B_MN>
cudaError_t launch_tma_bn(const TmaMaps& maps, const GemmPlan& p, void* out,
                          int grid, cudaStream_t st) {
  auto kernel = gemm_tma_kernel<BN, A_MN, B_MN>;
  static bool allowed = false;     // one attribute call a kernel a process
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TmaCfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  kernel<<<grid, TNT, TmaCfg<BN>::SMEM, st>>>(maps, p, out);
  return cudaGetLastError();
}

template <bool A_MN, bool B_MN>
cudaError_t launch_tma(const TmaMaps& maps, const GemmPlan& p, void* out,
                       int bn, int grid, cudaStream_t st) {
  switch (bn) {
    case 256: return launch_tma_bn<256, A_MN, B_MN>(maps, p, out, grid, st);
    case 192: return launch_tma_bn<192, A_MN, B_MN>(maps, p, out, grid, st);
    case 128: return launch_tma_bn<128, A_MN, B_MN>(maps, p, out, grid, st);
    case 64: return launch_tma_bn<64, A_MN, B_MN>(maps, p, out, grid, st);
    default: return cudaErrorInvalidValue;
  }
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

// out: this rank's n fp32 slots of K * N / n elements, slot c at out +
// c * slot (slot >= the shard: the slots of a layer's exchange region lie
// one region row apart); lhs [M, K], rhs [M, N]
extern "C" int dstpu_mm_rs_partial(const void* lhs, const void* rhs,
                                   void* out, int M, int K, int N, int ck,
                                   int shard1, int vec, int slot,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1 || ck < 1 ||
      (long long)slot < (long long)K * N / ((shard1 ? N : K) / ck))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* l = static_cast<const bf16*>(lhs);
  const bf16* r = static_cast<const bf16*>(rhs);
  float* o = static_cast<float*>(out);
  if (vec)
    return shard1
               ? (int)launch_partial<true, true>(l, r, o, M, K, N, ck, slot, st)
               : (int)launch_partial<true, false>(l, r, o, M, K, N, ck, slot,
                                                  st);
  return shard1
             ? (int)launch_partial<false, true>(l, r, o, M, K, N, ck, slot, st)
             : (int)launch_partial<false, false>(l, r, o, M, K, N, ck, slot,
                                                 st);
}

// out = A @ B by gemm_tma_kernel along the walk that tile_plan
// (ops/cuda/fused_collective.py) laid out (M .. o_chunk: GemmPlan's
// fields; bn, grid). A is the row-major bf16 [a_rows, a_cols] at `a`
// (a_mn: MN-major, lhs^T of mm_rs; else x, K-major); B the `nmaps`
// row-major bf16 [b_rows, b_cols] matrices whose device pointers
// `b_table` holds (b_mn: [k, n]; else [n, k]). Every row 16-byte aligned
// and every base 16-byte aligned: the wrapper's shape test.
extern "C" int dstpu_gemm_tma(const void* a, int a_rows, int a_cols,
                              int a_mn, const void* b_table, int nmaps,
                              int b_rows, int b_cols, int b_mn, void* out,
                              int out_f32, int M, int m_tiles, int nt_chunk,
                              int cw, int tiles, int k_chunks, int kpc,
                              int a_chunk, int rank, int b_by_chunk, int ldo,
                              int o_chunk, int rc, int r_chunk, int bn,
                              int grid, void* stream) {
  if (nmaps < 1 || nmaps > MAX_RANKS || k_chunks < 1 ||
      k_chunks > nmaps || rank < 0 || rank >= k_chunks || M < 1 ||
      tiles < 1 || grid < 1 || kpc < 1 || a_rows < 1 || a_cols < 1 ||
      b_rows < 1 || b_cols < 1 || (a_mn && !b_mn) || m_tiles < 1 ||
      nt_chunk < 1 || tiles % (m_tiles * nt_chunk) != 0 ||
      (b_by_chunk && tiles / (m_tiles * nt_chunk) > nmaps) || rc < 0 ||
      r_chunk < 0)
    return (int)cudaErrorInvalidValue;
  const void* const* table = static_cast<const void* const*>(b_table);
  TmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t err =
      sm90::encode_2d(&maps.a, a, a_rows, a_cols, a_mn ? TBK : TBM);
  for (int j = 0; j < nmaps && err == cudaSuccess; ++j)
    err = sm90::encode_2d(&maps.b[j], table[j], b_rows, b_cols,
                          b_mn ? TBK : bn);
  if (err != cudaSuccess) return (int)err;
  const GemmPlan p = {M,       m_tiles, nt_chunk, cw,      tiles,
                      k_chunks, kpc,     a_chunk,  rank,    b_by_chunk,
                      ldo,     o_chunk, out_f32,  rc,      r_chunk};
  const int g = grid < tiles ? grid : tiles;
  cudaStream_t st = (cudaStream_t)stream;
  if (a_mn) return (int)launch_tma<true, true>(maps, p, out, bn, g, st);
  return b_mn ? (int)launch_tma<false, true>(maps, p, out, bn, g, st)
              : (int)launch_tma<false, false>(maps, p, out, bn, g, st);
}

// Row `rank` of the n peers' [n, run] fp32 regions (`slots`: a host array
// of their n device pointers) summed in the ring's order into n_outs
// destinations: out_ptrs[i] (a host array of device pointers) takes
// elements [meta[3i], meta[3i] + meta[3i + 1]) of the run, as fp32 when
// meta[3i + 2] is 1, else as bf16. vec: every offset, length and pointer
// a multiple of 16 bytes' worth, the 16-byte path.
extern "C" int dstpu_mm_rs_reduce(const void* slots, int nranks, int rank,
                                  int run, const void* out_ptrs,
                                  const void* meta, int n_outs, int vec,
                                  void* stream) {
  if (nranks < 1 || nranks > MAX_RANKS || rank < 0 || rank >= nranks ||
      run < 1 || n_outs < 1 || n_outs > MAX_OUTS)
    return (int)cudaErrorInvalidValue;
  const void* const* table = static_cast<const void* const*>(slots);
  PeersF s;
  for (int j = 0; j < MAX_RANKS; ++j)
    s.p[j] = j < nranks ? static_cast<const float*>(table[j]) : nullptr;
  ReduceOuts outs;
  memset(&outs, 0, sizeof(outs));
  outs.n = n_outs;
  const int* m = static_cast<const int*>(meta);
  void* const* ptrs = static_cast<void* const*>(out_ptrs);
  long long end = 0, work = 0;
  for (int i = 0; i < n_outs; ++i) {
    outs.e[i] = {m[3 * i], m[3 * i + 1], ptrs[i], m[3 * i + 2]};
    if (outs.e[i].off < end || outs.e[i].len < 1 ||
        outs.e[i].off + outs.e[i].len > run)
      return (int)cudaErrorInvalidValue;
    end = outs.e[i].off + outs.e[i].len;
    work += outs.e[i].len;
  }
  // a grid that fills the card at the kernel's occupancy, or
  // kReduceUnits units of work a thread, whichever is smaller
  const long long units = vec ? work / 4 : work;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? (int)launch_reduce_n<true>(nranks, s, outs, run, rank, units,
                                          st)
             : (int)launch_reduce_n<false>(nranks, s, outs, run, rank, units,
                                           st);
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
