// serving_gemm for bf16, redesigned for Hopper: out[M, N] = x[M, K] @
// w[K, N] on the tensor cores, f32 accumulation, rounded once to bf16 (the
// layers' products) or f32 (the logits).
//
// Replaces no Pallas kernel: the reference's serving products are jnp.dot
// (horovod_tpu/models/transformer.py :556, :564, :210, :213, :570), which
// XLA compiles.  serving.cu's first form runs outside the tensor cores;
// the wrapper (ops/serving.py serving_gemm_form) sends bf16 with K and N
// multiples of 8 here and everything else there.
//
// What bounds it on an H100: at decode (M 16) the bytes of w (4.7 MB for
// GPT-2-small's FFN products, 1.4 us at 3.35 TB/s), so enough blocks must
// stream w at once; at prefill (M 1024) the bf16 tensor-core operations
// (FFN-in 4.8 GFLOP, 4.9 us at 989 TFLOP/s), and for the f32 logits the
// 134 MB written.
//
// Design:
// - Block: 160 threads.  Warps 0-3 are one consumer warpgroup that owns
//   a [64, BN] output tile (wgmma's M; BN 64, or 128 for N >= 2048);
//   warp 4 is the producer.  Two blocks share an SM (96 KB of shared
//   memory each).
// - Loads: one producer thread keeps a ring of TMA loads in flight (six
//   stages at BN 64, four at 128): the x tile [64 rows, 64 k] K-major
//   and the w tile [64 k, BN] MN-major (w is [K, N] row-major) as BN/64
//   panels of [64 k, 64 n], all 128-byte swizzled, each stage on a
//   full/empty mbarrier pair.  Rows past M, columns past N and k past K
//   are zero-filled by TMA; rows past M and columns past N are never
//   stored.
// - Products: per 64-deep k tile, four wgmma m64nBNk16 with A = x
//   (K-major) and B = w (MN-major, transpose flag; at BN 128 the
//   descriptor's leading offset steps from panel to panel), accumulating
//   in k order into BN/2 f32 registers a thread; one k tile's group stays
//   in flight while the next is issued, and its stage is released when it
//   completes.  A shared-memory read of x serves 64 columns at BN 64 and
//   128 at BN 128, which is why the wide products take the wide tile.
// - Order: row tiles vary fastest in the grid, so the blocks in flight
//   share their w tiles and w is read from memory about once.
// - Split-K: at M 16 FFN-out (K 3072, N 768) has only 12 column tiles,
//   too few blocks to pull its 4.7 MB of w at the card's rate, so K is
//   cut into `split` fixed ranges of k tiles, one block each, the
//   `split` blocks of an output tile one thread-block cluster (1 x 1 x
//   split, at most 8).  Each block leaves its f32 partial in its own
//   shared memory; each then adds a share of the tile's columns over
//   the cluster through distributed shared memory, in split order, and
//   rounds once.
//   One launch, no workspace: a host-bound decode pays one enqueue.
//   `split` is a function of (N, K) alone (ops/serving.py), never of M;
//   only a long K splits.
// Row invariance: output (m, n) is the k-ordered wgmma sum of x[m, :] and
// w[:, n] over fixed k tiles, then the fixed split order.  The tensor
// cores compute each element from its own row and column, so its bits do
// not depend on M, on the other rows of its tile or on its place in it.
// No atomics, no --use_fast_math: two runs give the same bits.
#pragma once

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace hvdserve {
namespace sm90 {

using namespace hvdflash::sm90;
namespace cg = cooperative_groups;

// BN: output columns of a block, 64 or 128 (ops/serving.py
// serving_gemm_form picks it from N).  96 KB of ring either way.
template <int BN_>
struct GemmSm90 {
  static constexpr int BM = 64, BN = BN_, BK = 64;
  static constexpr int kStages = BN == 64 ? 6 : 4;
  static constexpr int kThreads = 160;     // a consumer warpgroup + a warp
  static constexpr int kPanel = 64 * 64 * 2;  // bytes of a [64, 64] box
  static constexpr int kTileX = kPanel;        // [64 rows, 64 k]
  static constexpr int kTileW = (BN / 64) * kPanel;  // [64 k, BN] panels
  static constexpr int kOffX = 0;
  static constexpr int kOffW = kOffX + kStages * kTileX;
  static constexpr int kOffBar = kOffW + kStages * kTileW;  // full, empty
  static constexpr int kBytes = kOffBar + 16 * kStages + 1024;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// out [M, N] row-major.  At split > 1 the launch is a cluster of the
// `split` blocks of one output tile (blockIdx.z = the K range = the
// block's rank in the cluster).
template <typename TOut, int BN>
__global__ void __launch_bounds__(GemmSm90<BN>::kThreads)
    serving_gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                             const __grid_constant__ CUtensorMap map_w,
                             TOut* __restrict__ out, int M, int N, int K,
                             int split) {
  using L = GemmSm90<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sX = base + L::kOffX, sW = base + L::kOffW;
  const uint32_t bar_full = base + L::kOffBar,
                 bar_empty = bar_full + 8 * kStages;

  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const int z = blockIdx.z;
  const int kt = cdiv(K, L::BK);
  const int kb0 = z * kt / split, kb1 = (z + 1) * kt / split;
  const int n_k = kb1 - kb0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // This thread holds rows row0 and row0 + 8, columns 8 j + col_t +
  // {0, 1} of the tile (hopper.cuh's fragment map); the producer warp's
  // accumulators stay zero and unused.
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int row0 = m0 + 16 * warp + lane / 4;
  const int col_t = 2 * (lane % 4);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (t >= 128) {
    // Producer: one thread issues every load.
    if (t == 128) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, L::kTileX + L::kTileW);
        tma_load_2d(sX + s * L::kTileX, &map_x, bar_full + 8 * s,
                    (kb0 + i) * L::BK, m0);
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load_2d(sW + s * L::kTileW + p * L::kPanel, &map_w,
                      bar_full + 8 * s, n0 + 64 * p, (kb0 + i) * L::BK);
      }
    }
  } else {
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kStages;
      mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
      const uint32_t x_s = sX + s * L::kTileX, w_s = sW + s * L::kTileW;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk) {
        if constexpr (BN == 64)
          wgmma_ss_n64_tb(acc, desc_sw128(x_s + 32 * kk),
                          desc_sw128(w_s + 2048 * kk));
        else
          wgmma_ss_n128_tb(acc, desc_sw128(x_s + 32 * kk),
                           desc_sw128_lbo(w_s + 2048 * kk, L::kPanel));
      }
      wgmma_commit();
      // The previous k tile's products are done: release its stage.
      wgmma_wait<1>();
      if (i > 0) mbar_arrive(bar_empty + 8 * ((i - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if (split > 1) {
    // Every load has landed and every wgmma has read its stage, so the
    // ring holds this block's partial: columns 8 j .. 8 j + 7 of thread
    // t as one float4 at j * 128 + t.  Block z then sums the chunks j
    // with j % split == z over the cluster, reading every block's
    // partial (its own too) through distributed shared memory in split
    // order, each element ((p0 + p1) + p2) + ..., and stores them; the
    // cluster meets again so no block leaves while it is read.
    cg::cluster_group cluster = cg::this_cluster();
    float4* part =
        reinterpret_cast<float4*>(smem_raw + (base - smem_u32(smem_raw)));
    if (t < 128) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        part[j * 128 + t] = make_float4(acc[4 * j], acc[4 * j + 1],
                                        acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync();
    if (t < 128) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + col_t;
        if (j % split != z || col >= N) continue;
        float4 sum = cluster.map_shared_rank(part, 0)[j * 128 + t];
#pragma unroll
        for (int r = 1; r < 8; ++r) {
          if (r >= split) break;
          const float4 p = cluster.map_shared_rank(part, r)[j * 128 + t];
          sum.x = __fadd_rn(sum.x, p.x);
          sum.y = __fadd_rn(sum.y, p.y);
          sum.z = __fadd_rn(sum.z, p.z);
          sum.w = __fadd_rn(sum.w, p.w);
        }
        if (row0 < M) store2(out + (size_t)row0 * N + col, sum.x, sum.y);
        if (row0 + 8 < M)
          store2(out + (size_t)(row0 + 8) * N + col, sum.z, sum.w);
      }
    }
    cluster_sync();
    return;
  }
  if (t >= 128) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + col_t;
      if (col >= N) continue;  // N is even: col + 1 < N too
      store2(out + (size_t)row * N + col, acc[4 * j + 2 * r],
             acc[4 * j + 2 * r + 1]);
    }
  }
}

// x [M, K] and w [K, N] bf16 row-major with rows ldx and ldw elements
// apart (multiples of 8), 16-byte aligned, K and N multiples of 8; out
// [M, N] contiguous in TOut; split K ranges (1 to 8), each range a block
// of one cluster.
template <typename TOut, int BN>
cudaError_t launch_gemm(const void* x, long long ldx, const void* w,
                        long long ldw, void* out, int M, int N, int K,
                        int split, cudaStream_t stream) {
  using L = GemmSm90<BN>;
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || split < 1 || split > 8 ||
      split > cdiv(K, L::BK) || cdiv(N, L::BN) > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  cudaError_t err = make_map_2d(&map_x, x, M, K, ldx);
  if (err == cudaSuccess) err = make_map_2d(&map_w, w, K, N, ldw);
  if (err != cudaSuccess) return err;
  auto kernel = serving_gemm_sm90_kernel<TOut, BN>;
  static std::atomic<unsigned long long> smem_set{0};
  err = set_smem_once(reinterpret_cast<const void*>(kernel), L::kBytes,
                      smem_set);
  if (err != cudaSuccess) return err;
  // Row tiles vary fastest: the blocks that run together share a w
  // tile, so a w larger than the L2 (the logits' 50 MB) is read from
  // memory once rather than once per row tile.
  const dim3 grid(cdiv(M, L::BM), cdiv(N, L::BN), split);
  TOut* o = static_cast<TOut*>(out);
  if (split == 1) {
    kernel<<<grid, L::kThreads, L::kBytes, stream>>>(map_x, map_w, o, M, N,
                                                     K, split);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(L::kThreads);
  config.dynamicSmemBytes = L::kBytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  config.attrs = attr;
  config.numAttrs = 1;
  void* args[] = {&map_x, &map_w, &o, &M, &N, &K, &split};
  return cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(kernel),
                             args);
}

}  // namespace sm90
}  // namespace hvdserve
