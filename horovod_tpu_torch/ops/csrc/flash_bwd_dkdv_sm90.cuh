// flash_bwd_dkdv for bf16 at head_dim 64, 80, 96 and 128, redesigned for
// Hopper.
//
// Replaces horovod_tpu/ops/flash_attention.py _bwd_dkdv_kernel_resident
// (:387) and the streaming _bwd_dkdv_kernel (:466) for the widths users
// train at; flash_bwd.cu's dispatch sends every other (dtype, head_dim)
// to the first, WMMA/FMA form.  Same math as _bwd_p_ds (:362-381):
//   p  = exp(s - lse), 0 where lse is not finite or the key is masked,
//   ds = p * (dp - delta) * scale,   dV += p^T dO,   dK += ds^T q
// with p cast to dO's dtype and ds to q's before the two products
// (:413-416).
//
// What bounds it on an H100: four products of 2 d flops per visible
// (query, key) pair on the tensor cores (0.0261 ms at b8 h12 s1024 d64
// causal).  The design keeps S, dP, dK and dV in registers:
//
// - Block: 384 threads, one 128-key tile of one slice.  Warpgroups 0 and
//   1 are consumers, 64 keys each (wgmma's M), at head_dim 64 and 128
//   alike: a consumer's registers depend on its 64 keys, not on the
//   block's, and dK + dV + S^T + dP^T take 192 of its 240 registers at
//   d128 (and at d80 and d96, whose tiles are zero-padded to two 64-column
//   panels, hopper.cuh).  One warp of warpgroup 2 is the producer;
//   setmaxnreg moves its registers to the consumers.
// - Loads: K and V once, by TMA.  The producer then streams (Q, dO)
//   tiles of 64 q rows by TMA, with their lse and delta, through a
//   two-stage ring with full/empty mbarriers, starting at the causal
//   bound lo = floordiv(k0 - q_offset, 64) (negative numerators floor, as
//   jnp's //).
// - Transposed scores directly: S^T = K Q^T and dP^T = V dO^T are wgmma
//   m64n64k16 with all operands in shared memory (K-major), so P^T and
//   dS^T come out in registers in the accumulator layout, which is the
//   register-A layout of the next products: dV += P^T dO and
//   dK += dS^T Q are register-A wgmma with dO and Q as MN-major B
//   operands.  dK and dV stay in registers until the epilogue.
// - No atomics: each block owns its keys' dK and dV, so the results are
//   deterministic.
//
// Where trouble lies, and what the code does about it:
// 1. Mask in the log2 domain: p = exp2(s * scale * log2(e) - lse *
//    log2(e)); masked entries are set to p = 0 directly (the reference's
//    exp(kMaskValue - lse) is 0 for every finite lse), so no scaled mask
//    value exists to overflow.
// 2. Ragged ends: tensor maps are 3-D [bh, seq, d], so a ragged tile is
//    zero-filled rather than read from the next slice.
// 3. Padded q rows lose lse = -inf under a TMA load (it zero-fills).  So
//    lse and delta are not loaded by TMA: the producer warp reads them
//    with a bounds check, and stores lse * log2(e) for finite lse and
//    +inf for rows past q_len or without a visible key, which makes
//    exp2(x - inf) = 0 exactly, as the reference's isfinite test does.
// 4. Four tensor maps are encoded on the host for every launch; see
//    flash_fwd_sm90.cuh.
// 5. Arbitrary q_offset: the mask test is per warpgroup and per tile; a
//    negative offset that makes lo >= the q tile count leaves dK = dV = 0.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace hvdflash {
namespace sm90 {

template <int D>
struct DkdvSm90 {
  static_assert(D % 16 == 0 && D >= 64 && D <= 128, "head_dim 64..128");
  static constexpr int BN = 128;      // keys of a block, 64 a consumer
  static constexpr int BM = 64;       // q rows of a Q/dO tile
  static constexpr int kStages = 2;   // Q/dO ring
  static constexpr int DP = padded<D>;     // D in whole 64-column panels
  static constexpr int kKV = BN * DP * 2;  // bytes of the K or V tile
  static constexpr int kQ = BM * DP * 2;   // bytes of one Q or dO tile
  // Offsets from the 1024-aligned base; tiles are multiples of 1024.
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kOffK + kKV;
  static constexpr int kOffQ = kOffV + kKV;
  static constexpr int kOffDO = kOffQ + kStages * kQ;
  static constexpr int kOffLse = kOffDO + kStages * kQ;
  static constexpr int kOffDelta = kOffLse + kStages * BM * 4;
  static constexpr int kOffBar = kOffDelta + kStages * BM * 4;  // kv, full, empty
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int q_len,
                               int kv_len, float scale, int causal,
                               int q_offset) {
  using L = DkdvSm90<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  float* s_lse = reinterpret_cast<float*>(base_ptr + L::kOffLse);
  float* s_delta = reinterpret_cast<float*>(base_ptr + L::kOffDelta);
  const uint32_t sK = base + L::kOffK, sV = base + L::kOffV,
                 sQ = base + L::kOffQ, sDO = base + L::kOffDO;
  const uint32_t bar_kv = base + L::kOffBar;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::BN;
  const int n_qb = cdiv(q_len, L::BM);
  // q tiles strictly before this k tile see none of it (TPU :419-426).
  const int lo =
      causal ? min(max(0, floordiv(k0 - q_offset, L::BM)), n_qb) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, 128 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: the first warp of the last warpgroup.
    producer_regs();
    if (threadIdx.x / 32 == 4 * kConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
        tma_load_tile<D>(sK, L::BN * 128, &map_k, bar_kv, k0, bh);
        tma_load_tile<D>(sV, L::BN * 128, &map_v, bar_kv, k0, bh);
      }
      for (int qb = lo; qb < n_qb; ++qb) {
        const int it = qb - lo, s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const int q0 = qb * L::BM;
        for (int r = lane; r < L::BM; r += 32) {
          const int row = q0 + r;
          const bool in = row < q_len;
          const float l = in ? lse[(size_t)bh * q_len + row] : -INFINITY;
          s_lse[s * L::BM + r] = isfinite(l) ? l * kLog2e : INFINITY;
          s_delta[s * L::BM + r] = in ? delta[(size_t)bh * q_len + row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kQ);
          tma_load_tile<D>(sQ + s * L::kQ, L::BM * 128, &map_q,
                           bar_full + 8 * s, q0, bh);
          tma_load_tile<D>(sDO + s * L::kQ, L::BM * 128, &map_do,
                           bar_full + 8 * s, q0, bh);
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys kc .. kc + 63.  This thread holds keys
    // key0 and key0 + 8, q columns 8 j + col_t + {0, 1} of each q tile.
    consumer_regs();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int kc = k0 + 64 * wg;
    const int key0 = kc + 16 * warp + lane / 4;
    const int col_t = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_wg = sK + 64 * wg * 128, v_wg = sV + 64 * wg * 128;

    float acc_dk[L::DP / 2], acc_dv[L::DP / 2];
#pragma unroll
    for (int i = 0; i < L::DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int qb = lo; qb < n_qb; ++qb) {
      const int it = qb - lo, s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      const uint32_t q_s = sQ + s * L::kQ, do_s = sDO + s * L::kQ;

      float st[32], dpt[32];  // S^T, dP^T [64 keys x 64 q rows] in f32
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int off = (k % 4) * 32;
        wgmma_ss_n64(st, desc_sw128(k_wg + (k / 4) * L::BN * 128 + off),
                     desc_sw128(q_s + (k / 4) * L::BM * 128 + off), k > 0);
      }
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int off = (k % 4) * 32;
        wgmma_ss_n64(dpt, desc_sw128(v_wg + (k / 4) * L::BN * 128 + off),
                     desc_sw128(do_s + (k / 4) * L::BM * 128 + off), k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in place of S^T and dP^T.
      const int q0 = qb * L::BM;
      const bool edge =
          kc + 63 >= kv_len || (causal && q0 + q_offset < kc + 63);
      const float* lse2 = s_lse + s * L::BM;
      const float* dlt = s_delta + s * L::BM;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * j + col_t + e;
          const float row_lse = lse2[qi], row_delta = dlt[qi];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            float p = exp2f(fmaf(st[i], scale_log2, -row_lse));
            if (edge && !visible(q0 + qi + q_offset, key0 + 8 * r, kv_len,
                                 causal))
              p = 0.f;
            dpt[i] = p * (dpt[i] - row_delta) * scale;
            st[i] = p;
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q: A from registers (bf16), B MN-major.
      uint32_t pa[16], dsa[16];
      acc_to_a(st, pa);
      acc_to_a(dpt, dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BM / 16; ++kk) {
        wgmma_rs_panel<0>(acc_dv, pa + 4 * kk, desc_sw128(do_s + kk * 2048));
        if constexpr (panels<D> == 2)
          wgmma_rs_panel<1>(acc_dv, pa + 4 * kk,
                            desc_sw128(do_s + L::BM * 128 + kk * 2048));
      }
#pragma unroll
      for (int kk = 0; kk < L::BM / 16; ++kk) {
        wgmma_rs_panel<0>(acc_dk, dsa + 4 * kk, desc_sw128(q_s + kk * 2048));
        if constexpr (panels<D> == 2)
          wgmma_rs_panel<1>(acc_dk, dsa + 4 * kk,
                            desc_sw128(q_s + L::BM * 128 + kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= kv_len) continue;
      const size_t at = ((size_t)bh * kv_len + key) * D + col_t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
            pack_bf16(acc_dk[i], acc_dk[i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
            pack_bf16(acc_dv[i], acc_dv[i + 1]);
      }
    }
  }
}

template <int D>
struct DkdvSm90Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* d_o, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int q_len, int kv_len,
                         float scale, int causal, int q_offset,
                         cudaStream_t stream) {
    using L = DkdvSm90<D>;
    // q_len == 0: no Q/dO tile is read and dK = dV = 0; a map needs a
    // non-empty tensor, so k stands in for q and dO.
    const bool no_q = q_len == 0;
    CUtensorMap map_q, map_k, map_v, map_do;
    cudaError_t err = make_map(&map_k, k, bh, kv_len, D, L::BN);
    if (err == cudaSuccess) err = make_map(&map_v, v, bh, kv_len, D, L::BN);
    if (err == cudaSuccess)
      err = make_map(&map_q, no_q ? k : q, bh, no_q ? kv_len : q_len, D,
                     L::BM);
    if (err == cudaSuccess)
      err = make_map(&map_do, no_q ? k : d_o, bh, no_q ? kv_len : q_len, D,
                     L::BM);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_dkdv_sm90_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, cdiv(kv_len, L::BN));  // low k tiles (the heaviest) first
    kernel<<<grid, kBlockThreads, L::kBytes, stream>>>(
        map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), q_len, kv_len, scale, causal,
        q_offset);
    return cudaGetLastError();
  }
};

}  // namespace sm90
}  // namespace hvdflash
