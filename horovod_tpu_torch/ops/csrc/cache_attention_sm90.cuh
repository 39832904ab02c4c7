// cache_attention for bf16 at head_dim 64, 80, 96 and 128, redesigned for
// Hopper:
// masked attention of q [b, s, heads, hd] at positions q_pos [b, s]
// against a fixed-capacity KV view [b, cap, heads, hd]; key j takes part
// in row (b, i) iff j <= q_pos[b, i] (and j < cap); a row with q_pos < 0
// comes out all zero.
//
// Replaces no Pallas kernel: the reference's cache_attention
// (horovod_tpu/models/transformer.py :458, einsums :480 and :492) is jnp
// that XLA compiles.  serving.cu's first form (one block a query row)
// stays for f32 and other head dims; the wrapper (ops/serving.py
// cache_attention_form) chooses by (dtype, head_dim) alone.
//
// What bounds it on an H100: the bytes of the K and V rows the batch's
// rows can see and of q and out (a 1024-token prefill of GPT-2-small's 12
// heads: 6.3 MB, 1.9 us), about equal to its bf16 tensor-core operations.
// The first form read each K and V row once per query row; here a block
// of 64 query rows reads them once.
//
// Design:
// - Block: 160 threads, one (64 query rows, head, batch).  Warps 0-3 are
//   the consumer warpgroup (wgmma's 64 rows), warp 4 the producer.  The
//   heaviest row tiles (the latest rows see the most keys) are issued
//   first.
// - Loads: TMA over 4-D maps [b, rows, heads, hd] with the tensors' own
//   strides, so q may be a view of the fused QKV product and K/V a view
//   of a longer buffer (forward_step passes full[:, :cap], whose batch
//   stride is (cap + 1) heads hd): no copy.  q once; K and V in 64-key
//   tiles through a four-stage ring of full/empty mbarriers.  The block
//   reads keys [0, min(max q_pos of its rows + 1, cap)) only.
// - Head dims: tiles hold hd in 64-column panels (hopper.cuh); at hd 80
//   and 96 the second panel's columns past hd are zero (the 4-D map's
//   width is hd, so TMA fills them), S = Q K^T runs hd/16 k steps, O +=
//   P V both panels, and the epilogue stores columns below hd.  Whether a
//   column is padding depends on hd alone, never on the rows.
// - Products: S = Q K^T by wgmma m64n64k16 (both K-major); an online
//   softmax in f32 registers (a row lives in the four threads of a quad);
//   P rounded to bf16 becomes the register A operand of O += P V, V
//   MN-major (transpose flag).  O is divided by the row's sum once, at the
//   end, and stored in bf16.
//
// The rules that keep the serving contract (row i's bits do not depend on
// s, b or the other rows of its tile):
// - Key tiles go in ascending order at fixed positions (multiples of 64),
//   whatever the block's first row.
// - A masked score is selected to -inf, never computed with: K rows past
//   the visible range may hold stale values or NaN.  The running max is
//   guarded: while a row has seen no key, alpha is 1 and its max reads 0,
//   so p = exp2(-inf) = 0; a key tile wholly masked for a row leaves its
//   max, so alpha = exp2(0) = 1 exactly, p = 0, l and O unchanged.  A
//   block that runs more trailing tiles than a row needs (its other rows
//   see further) changes nothing in that row.
// - V rows past the block's furthest visible key are zeroed in shared
//   memory before P V (0 * NaN is NaN); the last tile is the only one
//   that holds such rows.
// - A row with q_pos < 0, or no visible key, is stored as zeros.
// No atomics, no --use_fast_math: two runs give the same bits.
#pragma once

#include "hopper.cuh"

namespace hvdserve {
namespace sm90 {

using namespace hvdflash::sm90;

template <int D>
struct AttnSm90 {
  static_assert(D % 16 == 0 && D >= 64 && D <= 128, "head_dim 64..128");
  static constexpr int BM = 64;       // query rows of a block
  static constexpr int BN = 64;       // keys of a K/V tile
  static constexpr int kStages = 4;   // K/V ring
  static constexpr int kThreads = 160;
  static constexpr int kPanels = panels<D>;  // 64-column panels of hd
  static constexpr int kPanel = 64 * 128;  // [64 rows, 64 hd] in bytes
  static constexpr int kTile = kPanels * kPanel;  // q, K or V tile
  static constexpr int kOffQ = 0;
  static constexpr int kOffK = kOffQ + kTile;
  static constexpr int kOffV = kOffK + kStages * kTile;
  static constexpr int kOffBar = kOffV + kStages * kTile;  // q, full, empty
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

// Orders this thread's generic shared-memory writes before later wgmma
// (async proxy) reads, then syncs the consumer warpgroup.
__device__ __forceinline__ void consumers_sync_after_writes() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(AttnSm90<D>::kThreads)
    cache_attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const long long* __restrict__ q_pos,
                                __nv_bfloat16* __restrict__ out, int S, int H,
                                int cap, float scale_log2) {
  using L = AttnSm90<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int pos_s[L::BM];
  __shared__ int pos_max[2];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kOffQ, sK = base + L::kOffK,
                 sV = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * L::BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  if (t < L::BM) {
    const int i = i0 + t;
    const long long qp = i < S ? q_pos[(size_t)b * S + i] : -1;
    const int p = (int)max(-1LL, min(qp, 0x7fffffffLL));
    pos_s[t] = p;
    int mx = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) pos_max[warp] = mx;
  }
  if (t == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int p_max = max(pos_max[0], pos_max[1]);
  const int n_kv = p_max < 0 ? 0 : min(p_max + 1, cap);  // keys read
  const int n_kb = (n_kv + L::BN - 1) / L::BN;

  if (t >= 128) {
    // Producer: one thread issues every load.
    if (t == 128 && n_kb > 0) {
      mbar_arrive_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(sQ + p * L::kPanel, &map_q, bar_q, 64 * p, h, i0, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        mbar_wait(bar_empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(sK + s * L::kTile + p * L::kPanel, &map_k,
                      bar_full + 8 * s, 64 * p, h, kb * L::BN, b);
          tma_load_4d(sV + s * L::kTile + p * L::kPanel, &map_v,
                      bar_full + 8 * s, 64 * p, h, kb * L::BN, b);
        }
      }
    }
    return;
  }

  // Consumer: this thread holds rows r0 and r0 + 8 of the block, columns
  // 8 j + col_t + {0, 1} of each tile (hopper.cuh's fragment map).
  const int r0 = 16 * warp + lane / 4;
  const int col_t = 2 * (lane % 4);
  const int pos[2] = {pos_s[r0], pos_s[r0 + 8]};
  float acc[L::kPanels * 32];  // O [64 x 64 kPanels]
#pragma unroll
  for (int i = 0; i < L::kPanels * 32; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_kb > 0) mbar_wait(bar_q, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    mbar_wait(bar_full + 8 * s, (kb / kStages) & 1);
    const uint32_t k_s = sK + s * L::kTile, v_s = sV + s * L::kTile;
    const int k0 = kb * L::BN;

    // The tail of the last tile, keys [n_kv, k0 + 64): zero its V rows.
    if (k0 + L::BN > n_kv) {
      const int first = n_kv - k0;
      const int chunks = (L::BN - first) * 8;  // 16-byte chunks a panel
      for (int c = t; c < chunks * L::kPanels; c += 128) {
        const int p = c / chunks, rc = c % chunks;
        const uint32_t addr = v_s + p * L::kPanel + first * 128 + rc * 16;
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                     "r"(0), "r"(0), "r"(0), "r"(0)
                     : "memory");
      }
      consumers_sync_after_writes();
    }

    float sc[32];  // S [64 x 64] in f32
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const int off = (k / 4) * L::kPanel + (k % 4) * 32;
      wgmma_ss_n64(sc, desc_sw128(sQ + off), desc_sw128(k_s + off), k > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Scale into log2 units; select the masked scores to -inf.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + col_t + (i & 1);
      const int row_pos = pos[(i >> 1) & 1];
      sc[i] = (key <= row_pos && key < cap) ? sc[i] * scale_log2 : -INFINITY;
    }
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
    float alpha[2], m_use[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = quad_max(m_new[r]);
      // Guarded: no key seen yet -> alpha 1 (O and l are 0) and a max of
      // 0; an unchanged max -> alpha = exp2(0) = 1 exactly.
      alpha[r] = m[r] == -INFINITY ? 1.f : exp2f(m[r] - m_new[r]);
      m_use[r] = m_new[r] == -INFINITY ? 0.f : m_new[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(sc[i] - m_use[(i >> 1) & 1]);
      row_sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + row_sum[r];
#pragma unroll
    for (int i = 0; i < L::kPanels * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P (bf16) from registers, V MN-major from shared memory.
    uint32_t pa[16];
    acc_to_a(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BN / 16; ++kk) {
      wgmma_rs_panel<0>(acc, pa + 4 * kk, desc_sw128(v_s + kk * 2048));
      if constexpr (L::kPanels == 2)
        wgmma_rs_panel<1>(acc, pa + 4 * kk,
                          desc_sw128(v_s + L::kPanel + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int row = i0 + r0 + 8 * r;
    if (row >= S) continue;
    const bool empty = pos[r] < 0 || l_row == 0.f;
    __nv_bfloat16* orow = out + (((size_t)b * S + row) * H + h) * D + col_t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = empty ? 0.f : __fdiv_rn(acc[4 * j + 2 * r], l_row);
      const float c = empty ? 0.f : __fdiv_rn(acc[4 * j + 2 * r + 1], l_row);
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(a, c);
    }
  }
}

// Strides in elements: q (qs[0..2] for b, s, heads), k and v (ks and
// vs for b, cap, heads); every stride a multiple of 8 and every base
// 16-byte aligned.  q_pos [B, S] int64; out [B, S, H, D] contiguous.
template <int D>
cudaError_t launch_attention(const void* q, const long long* qs,
                             const void* k, const long long* ks,
                             const void* v, const long long* vs,
                             const long long* q_pos, void* out, int B, int S,
                             int H, int cap, float scale,
                             cudaStream_t stream) {
  using L = AttnSm90<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (qs[i] % 8 || ks[i] % 8 || vs[i] % 8) return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_map_4d(&map_q, q, B, S, H, D, qs[0], qs[1], qs[2]);
  if (err == cudaSuccess)
    err = make_map_4d(&map_k, k, B, cap, H, D, ks[0], ks[1], ks[2]);
  if (err == cudaSuccess)
    err = make_map_4d(&map_v, v, B, cap, H, D, vs[0], vs[1], vs[2]);
  if (err != cudaSuccess) return err;
  auto kernel = cache_attention_sm90_kernel<D>;
  static std::atomic<unsigned long long> smem_set{0};
  err = set_smem_once(reinterpret_cast<const void*>(kernel), L::kBytes,
                      smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + L::BM - 1) / L::BM, H, B);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      map_q, map_k, map_v, q_pos, static_cast<__nv_bfloat16*>(out), S, H,
      cap, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace hvdserve
