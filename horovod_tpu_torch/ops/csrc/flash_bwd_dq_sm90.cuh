// flash_bwd_dq for bf16 at head_dim 64, 80, 96 and 128, redesigned for
// Hopper.
//
// Replaces horovod_tpu/ops/flash_attention.py _bwd_dq_kernel_resident
// (:431) and the streaming _bwd_dq_kernel (:518) for the widths users
// train at; flash_bwd.cu's dispatch sends every other (dtype, head_dim)
// to the first, WMMA/FMA form.  Same math as _bwd_p_ds (:362-381), then
// dq += ds.astype(k.dtype) @ k with f32 accumulation (:453, :553):
//   p  = exp(s - lse), 0 where lse is not finite or the key is masked,
//   ds = p * (dp - delta) * scale   (f32, rounded to bf16 after the scale),
//   dQ += ds K
// with s = q k^T * scale, dp = dO v^T, delta = rowsum(dO * O) from the
// caller in f32.
//
// What bounds it on an H100: three products of 2 d flops per visible
// (query, key) pair on the tensor cores (0.0196 ms at b8 h12 s1024 d64
// causal).  It is the forward's skeleton (flash_fwd_sm90.cuh) with one
// more product and no online softmax; S, dP, dS and dQ stay in registers:
//
// - Block: 384 threads, one 128-row q tile of one slice.  Warpgroups 0
//   and 1 are consumers, 64 q rows each (wgmma's M); one warp of
//   warpgroup 2 is the producer; setmaxnreg moves its registers to the
//   consumers.  A consumer holds S (32) + dP (32) + dQ (DP/2) + dS as bf16
//   (16) registers: 112 at d64, 144 at d80, d96 and d128 (DP is D padded
//   to whole 64-column panels, hopper.cuh).
// - Loads: Q and dO once, by TMA.  The producer then streams 64-key K and
//   V tiles through a two-stage ring with full/empty mbarriers, up to the
//   causal bound hi = min(n_kb, cdiv(q0 + 128 + q_offset, 64)) (:456-461).
// - Products per K/V tile: S = Q K^T and dP = dO V^T are wgmma m64n64k16
//   with both operands K-major in shared memory; p and dS are computed in
//   those registers, and dS, packed to bf16 in the accumulator layout, is
//   the register A operand of dQ += dS K, with the same K tile read as an
//   MN-major B operand (transpose flag).  dQ stays in registers until the
//   epilogue, which stores each thread's rows as bf16.
// - No atomics: each block owns its q rows' dQ, so the result is
//   deterministic.
// - Schedule: blockIdx.y walks q tiles from the last, so the causal
//   blocks that see the most keys go first.
//
// Where trouble lies, and what the code does about it:
// 1. A K tile that lies wholly in one warpgroup's future (causal, the
//    block's last tile, seen by warpgroup 0 only): that warpgroup skips
//    its products, but still waits on the tile's full barrier and arrives
//    on its empty one, which counts both consumer warpgroups.  A
//    warpgroup whose 64 rows all lie past q_len does the same for every
//    tile.  The mask is tested per warpgroup and per tile.
// 2. lse and delta are constant over the loop: each consumer thread reads
//    them once, for its two rows, with a bounds check (a TMA load would
//    zero-fill a padded row's lse to 0).  lse becomes lse * log2(e), or
//    +inf for a row past q_len or with no visible key, so that p =
//    exp2(s * scale * log2(e) - lse2) is exactly 0 there.
// 3. Rounding order: ds is scaled before it is rounded to bf16, as the
//    reference does; scale is not a power of two at d128.
// 4. kv_len == 0 or hi <= 0 (a negative offset): no tile is read and dQ =
//    0 is stored; a map needs a non-empty tensor, so q stands in for k
//    and v when kv_len == 0.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace hvdflash {
namespace sm90 {

template <int D>
struct DqSm90 {
  static_assert(D % 16 == 0 && D >= 64 && D <= 128, "head_dim 64..128");
  static constexpr int BM = 128;      // q rows of a block, 64 a consumer
  static constexpr int BN = 64;       // keys of a K/V tile
  static constexpr int kStages = 2;   // K/V ring
  static constexpr int DP = padded<D>;     // D in whole 64-column panels
  static constexpr int kQ = BM * DP * 2;   // bytes of the Q or dO tile
  static constexpr int kKV = BN * DP * 2;  // bytes of one K or V tile
  // Offsets from the 1024-aligned base; each is a multiple of 1024.
  static constexpr int kOffQ = 0;
  static constexpr int kOffDO = kOffQ + kQ;
  static constexpr int kOffK = kOffDO + kQ;
  static constexpr int kOffV = kOffK + kStages * kKV;
  static constexpr int kOffBar = kOffV + kStages * kKV;  // q, full[], empty[]
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(BN == 64, "S and dP are m64n64 products");
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int q_len,
                             int kv_len, float scale, int causal,
                             int q_offset) {
  using L = DqSm90<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kOffQ, sDO = base + L::kOffDO,
                 sK = base + L::kOffK, sV = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BM;
  const int n_kb = cdiv(kv_len, L::BN);
  // K tiles entirely in the block's future contribute nothing (TPU
  // :456-461).
  const int hi =
      causal ? min(n_kb, cdiv(q0 + L::BM + q_offset, L::BN)) : n_kb;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: one thread issues every load.
    producer_regs();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kQ);
      tma_load_tile<D>(sQ, L::BM * 128, &map_q, bar_q, q0, bh);
      tma_load_tile<D>(sDO, L::BM * 128, &map_do, bar_q, q0, bh);
      for (int kb = 0; kb < hi; ++kb) {
        const int s = kb % kStages;
        mbar_wait(bar_empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kKV);
        tma_load_tile<D>(sK + s * L::kKV, L::BN * 128, &map_k,
                         bar_full + 8 * s, kb * L::BN, bh);
        tma_load_tile<D>(sV + s * L::kKV, L::BN * 128, &map_v,
                         bar_full + 8 * s, kb * L::BN, bh);
      }
    }
  } else {
    // Consumer warpgroup wg: q rows q0 + 64 wg .. + 63.  This thread holds
    // rows row0 and row0 + 8, key columns 8 j + col_t + {0, 1} of each
    // tile and head_dim columns 8 j + col_t + {0, 1} of dQ.
    consumer_regs();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
    const int col_t = 2 * (lane % 4);
    const int q_first = q0 + 64 * wg + q_offset;  // position of row 0
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_wg = sQ + 64 * wg * 128, do_wg = sDO + 64 * wg * 128;
    // This warpgroup's own bound: its rows lie before q_len, and it skips
    // the block's last tile when that lies wholly past its last row.
    const int hi_wg = q0 + 64 * wg >= q_len ? 0
                      : causal ? min(hi, cdiv(q_first + 64, L::BN))
                               : hi;

    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < q_len;
      const float l = in ? lse[(size_t)bh * q_len + row] : -INFINITY;
      lse2[r] = isfinite(l) ? l * kLog2e : INFINITY;
      dlt[r] = in ? delta[(size_t)bh * q_len + row] : 0.f;
    }

    float acc[L::DP / 2];  // dQ [64 x DP]: DP/8 column chunks of 4
#pragma unroll
    for (int i = 0; i < L::DP / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    int kb = 0;
    for (; kb < hi_wg; ++kb) {
      const int s = kb % kStages;
      mbar_wait(bar_full + 8 * s, (kb / kStages) & 1);
      const uint32_t k_s = sK + s * L::kKV, v_s = sV + s * L::kKV;

      float sc[32], dp[32];  // S, dP [64 rows x 64 keys] in f32
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int off = (k % 4) * 32;  // k16 step inside a 64-wide panel
        wgmma_ss_n64(sc, desc_sw128(q_wg + (k / 4) * L::BM * 128 + off),
                     desc_sw128(k_s + (k / 4) * L::BN * 128 + off), k > 0);
      }
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int off = (k % 4) * 32;
        wgmma_ss_n64(dp, desc_sw128(do_wg + (k / 4) * L::BM * 128 + off),
                     desc_sw128(v_s + (k / 4) * L::BN * 128 + off), k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS in place of dP; the mask only on tiles that cross the
      // diagonal or kv_len.
      const int k0 = kb * L::BN;
      const bool edge =
          k0 + L::BN > kv_len || (causal && k0 + L::BN - 1 > q_first);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
        if (edge && !visible(row0 + 8 * r + q_offset,
                             k0 + 8 * (i / 4) + col_t + (i & 1), kv_len,
                             causal))
          p = 0.f;
        dp[i] = p * (dp[i] - dlt[r]) * scale;
      }

      // dQ += dS K: dS (bf16) from registers, K MN-major from shared memory.
      uint32_t dsa[16];
      acc_to_a(dp, dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BN / 16; ++kk) {
        wgmma_rs_panel<0>(acc, dsa + 4 * kk, desc_sw128(k_s + kk * 2048));
        if constexpr (panels<D> == 2)
          wgmma_rs_panel<1>(acc, dsa + 4 * kk,
                            desc_sw128(k_s + L::BN * 128 + kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsa);
      mbar_arrive(bar_empty + 8 * s);
    }
    // Tiles this warpgroup does not need: keep the ring in step.
    for (; kb < hi; ++kb) {
      const int s = kb % kStages;
      mbar_wait(bar_full + 8 * s, (kb / kStages) & 1);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= q_len) continue;
      __nv_bfloat16* dq_row = dq + ((size_t)bh * q_len + row) * D + col_t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(dq_row + 8 * j) =
            pack_bf16(acc[i], acc[i + 1]);
      }
    }
  }
}

template <int D>
struct DqSm90Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* d_o, const void* lse, const void* delta,
                         void* dq, int bh, int q_len, int kv_len, float scale,
                         int causal, int q_offset, cudaStream_t stream) {
    using L = DqSm90<D>;
    // kv_len == 0: no K/V tile is read and dQ = 0; a map needs a
    // non-empty tensor, so q stands in for k and v.
    const bool no_kv = kv_len == 0;
    CUtensorMap map_q, map_k, map_v, map_do;
    cudaError_t err = make_map(&map_q, q, bh, q_len, D, L::BM);
    if (err == cudaSuccess) err = make_map(&map_do, d_o, bh, q_len, D, L::BM);
    if (err == cudaSuccess)
      err = make_map(&map_k, no_kv ? q : k, bh, no_kv ? q_len : kv_len, D,
                     L::BN);
    if (err == cudaSuccess)
      err = make_map(&map_v, no_kv ? q : v, bh, no_kv ? q_len : kv_len, D,
                     L::BN);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_dq_sm90_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, cdiv(q_len, L::BM));  // q tiles from the last (heaviest)
    kernel<<<grid, kBlockThreads, L::kBytes, stream>>>(
        map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
        q_len, kv_len, scale, causal, q_offset);
    return cudaGetLastError();
  }
};

}  // namespace sm90
}  // namespace hvdflash
