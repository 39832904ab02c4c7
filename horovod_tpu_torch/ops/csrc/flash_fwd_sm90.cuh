// flash_fwd for bf16 at head_dim 64, 80, 96 and 128, redesigned for Hopper.
//
// Replaces horovod_tpu/ops/flash_attention.py _fwd_kernel_resident (:133)
// and the streaming _fwd_kernel (:189) for the widths users train at;
// flash_fwd.cu's dispatch sends every other (dtype, head_dim) to the
// first, WMMA/FMA form.
//
// What bounds it on an H100: at b8 h12 s1024 d64 causal the forward needs
// 4 d flops per visible (query, key) pair and reads q, k, v once: 0.0151 ms
// by bytes, about the same by bf16 tensor-core operations.  So the design
// keeps every intermediate on chip and feeds the tensor cores from
// shared memory without the threads copying anything:
//
// - Block: 384 threads, one 128-row q tile of one (batch*head) slice.
//   Warpgroups 0 and 1 are consumers, 64 q rows each (wgmma's M); one
//   warp of warpgroup 2 is the producer.  setmaxnreg moves registers from
//   the producer (24) to the consumers (240).  Tiles hold D in 64-column
//   panels (hopper.cuh): at D 80 and 96 the second panel is zero-padded,
//   so S = Q K^T runs D/16 k steps and O += P V two n64 panels, and the
//   registers and shared memory are those of D 128.
// - Loads: the producer issues TMA loads of the q tile (once) and of
//   128-key K and V tiles into a two-stage ring with full/empty
//   mbarriers, so the next tile's load overlaps this tile's products.
//   Tensor maps are 3-D [bh, seq, d] (see below).
// - Products: S = Q K^T is a wgmma m64n128k16 with both operands in
//   shared memory and the f32 accumulator in registers.  The online
//   softmax runs on those registers: each row lives in the four threads
//   of a quad, so its max and sum are two shuffles; exp2f with
//   sm_scale * log2(e) folded in; the mask is evaluated only on tiles
//   that cross the causal diagonal or kv_len.  P is rounded to bf16 in
//   registers (as the TPU casts p to v's dtype) and is the register A
//   operand of O += P V, with V an MN-major B operand (transpose flag).
//   O, m and l stay in registers for the whole loop; l is summed per
//   thread and reduced over the quad once, at the end.
// - Epilogue: o in bf16 and lse = m + log(l) in natural-log units, with
//   the reference's no_valid test (:181-185): o = 0, lse = -inf.
// - Schedule: blockIdx.y walks q tiles from the last: causal q tiles late
//   in the sequence see the most keys, so the heaviest blocks go first,
//   and blockIdx.x (the slice) varies fastest, so every slice's heaviest
//   tile is issued before any lighter one.
//
// Where trouble lies, and what the code does about it:
// 1. The mask value in the log2 domain: kMaskValue (-0.7 FLT_MAX) times
//    log2(e) overflows to -inf, and m_prev - m_new would become
//    (-inf) - (-inf) = NaN.  Scores are scaled first and masked entries
//    then set to the unscaled kMaskValue, so m of a row with no visible
//    key is kMaskValue and `m <= kMaskValue * 0.5` means what it means in
//    the reference (no real score comes near 1e38 in either unit).
// 2. A 2-D map over [bh * seq, d] would let a ragged tile read the next
//    slice's rows; the 3-D map zero-fills past seq instead.  Zero K rows
//    are masked (key >= kv_len) and zero V rows add nothing.
// 3. Three tensor maps are encoded on the host for every launch
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda)
//    and passed as __grid_constant__ parameters; chip_smoke.py reports
//    the host time of one encode.
// 4. With a q_offset that is not a multiple of 128 the diagonal crosses
//    two K tiles: the mask test is per warpgroup and per tile, not "last
//    tile only".  A negative offset can make hi <= 0: the loop is empty,
//    l = 0 and every row is no_valid.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace hvdflash {
namespace sm90 {

template <int D>
struct FwdSm90 {
  static_assert(D % 16 == 0 && D >= 64 && D <= 128, "head_dim 64..128");
  static constexpr int BM = 128;      // q rows of a block, 64 a consumer
  static constexpr int BN = 128;      // keys of a K/V tile
  static constexpr int kStages = 2;   // K/V ring
  static constexpr int DP = padded<D>;     // D in whole 64-column panels
  static constexpr int kQ = BM * DP * 2;   // bytes of the q tile
  static constexpr int kKV = BN * DP * 2;  // bytes of one K or V tile
  // Offsets from the 1024-aligned base; each is a multiple of 1024.
  static constexpr int kOffQ = 0;
  static constexpr int kOffK = kOffQ + kQ;
  static constexpr int kOffV = kOffK + kStages * kKV;
  static constexpr int kOffBar = kOffV + kStages * kKV;  // q, full[], empty[]
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int q_len, int kv_len,
                          float scale, int causal, int q_offset) {
  using L = FwdSm90<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kOffQ, sK = base + L::kOffK,
                 sV = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BM;
  const int n_kb = cdiv(kv_len, L::BN);
  // K tiles entirely in the future contribute nothing (TPU :172-178).
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
      mbar_arrive_expect_tx(bar_q, L::kQ);
      tma_load_tile<D>(sQ, L::BM * 128, &map_q, bar_q, q0, bh);
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
    // rows row0 and row0 + 8, columns 8 j + col_t + {0, 1} of each tile.
    consumer_regs();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
    const int col_t = 2 * (lane % 4);
    const int q_first = q0 + 64 * wg + q_offset;  // position of row 0
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_wg = sQ + 64 * wg * 128;

    float acc[L::DP / 2];  // O [64 x DP]: DP/8 column chunks of 4
#pragma unroll
    for (int i = 0; i < L::DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int kb = 0; kb < hi; ++kb) {
      const int s = kb % kStages;
      mbar_wait(bar_full + 8 * s, (kb / kStages) & 1);
      const uint32_t k_s = sK + s * L::kKV, v_s = sV + s * L::kKV;

      float sc[64];  // S [64 x 128] in f32
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int off = (k % 4) * 32;  // k16 step inside a 64-wide panel
        wgmma_ss_n128(sc, desc_sw128(q_wg + (k / 4) * L::BM * 128 + off),
                      desc_sw128(k_s + (k / 4) * L::BN * 128 + off), k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Scale into log2 units, then mask with the unscaled floor.
      const int k0 = kb * L::BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (k0 + L::BN > kv_len || (causal && k0 + L::BN - 1 > q_first)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i / 4) + col_t + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (!visible(row + q_offset, key, kv_len, causal))
            sc[i] = kMaskValue;
        }
      }
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
      float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = quad_max(m_new[r]);
        alpha[r] = exp2f(m[r] - m_new[r]);  // m = -inf first: alpha = 0
        m[r] = m_new[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
        row_sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + row_sum[r];
#pragma unroll
      for (int i = 0; i < L::DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P (bf16) from registers, V MN-major from shared memory.
      uint32_t pa[32];
      acc_to_a(sc, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BN / 16; ++kk) {
        wgmma_rs_panel<0>(acc, pa + 4 * kk, desc_sw128(v_s + kk * 2048));
        if constexpr (panels<D> == 2)
          wgmma_rs_panel<1>(acc, pa + 4 * kk,
                            desc_sw128(v_s + L::BN * 128 + kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(bar_empty + 8 * s);
    }

    // Rows with no visible key: no tile ran (l == 0) or every score stayed
    // at the mask floor.  They get o = 0 and lse = -inf (TPU :181-186).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_row = quad_sum(l[r]);
      const int row = row0 + 8 * r;
      if (row >= q_len) continue;
      const bool no_valid = l_row == 0.f || m[r] <= kMaskValue * 0.5f;
      const float inv = no_valid ? 0.f : 1.f / l_row;
      __nv_bfloat16* orow = o + ((size_t)bh * q_len + row) * D + col_t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if (lane % 4 == 0)
        lse[(size_t)bh * q_len + row] =
            no_valid ? -INFINITY : m[r] * kLn2 + logf(l_row);
    }
  }
}

template <int D>
struct FwdSm90Launch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int q_len, int kv_len, float scale,
                         int causal, int q_offset, cudaStream_t stream) {
    using L = FwdSm90<D>;
    // kv_len == 0: no K/V tile is read and every row is no_valid; a map
    // needs a non-empty tensor, so q stands in for k and v.
    const bool no_kv = kv_len == 0;
    CUtensorMap map_q, map_k, map_v;
    cudaError_t err = make_map(&map_q, q, bh, q_len, D, L::BM);
    if (err == cudaSuccess)
      err = make_map(&map_k, no_kv ? q : k, bh, no_kv ? q_len : kv_len, D,
                     L::BN);
    if (err == cudaSuccess)
      err = make_map(&map_v, no_kv ? q : v, bh, no_kv ? q_len : kv_len, D,
                     L::BN);
    if (err != cudaSuccess) return err;
    auto kernel = flash_fwd_sm90_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, cdiv(q_len, L::BM));
    kernel<<<grid, kBlockThreads, L::kBytes, stream>>>(
        map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), q_len, kv_len, scale, causal, q_offset);
    return cudaGetLastError();
  }
};

}  // namespace sm90
}  // namespace hvdflash
