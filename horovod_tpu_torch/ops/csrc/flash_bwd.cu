// flash_bwd_dkdv and flash_bwd_dq: the attention backward on Hopper.
//
// flash_bwd_dkdv replaces horovod_tpu/ops/flash_attention.py
// _bwd_dkdv_kernel_resident; flash_bwd_dq replaces
// _bwd_dq_kernel_resident.  Each also computes what the streaming
// _bwd_dkdv_kernel / _bwd_dq_kernel compute for seq > 4096: a block that
// loops over tiles has no resident/streaming split.
//
// Two forms of each: bf16 at head_dim 64, 80, 96 and 128 runs the Hopper
// redesigns in flash_bwd_dkdv_sm90.cuh and flash_bwd_dq_sm90.cuh (TMA,
// wgmma, registers); f32 and bf16 at head_dim 16 and 32 run
// flash_bwd_dkdv_kernel and flash_bwd_dq_kernel below (DkdvLaunch and
// DqLaunch choose at compile time, hopper_form in flash_common.cuh).
// BwdSmem is largest at f32 head_dim 128 (dK/dV 120,064 B of the 232,448
// a block may use; 95,488 at 96).
//
// Both rebuild the probabilities from the forward's lse instead of
// storing them, as the TPU kernels do (_bwd_p_ds):
//   p  = exp(s - lse), 0 on rows whose lse is not finite,
//   ds = p * (dp - delta) * scale,  dp = dO v^T,  delta = rowsum(dO * O)
// with delta computed by the caller in f32.  p is cast to the dtype of dO
// before dV += p^T dO, and ds to the dtype of q/k before dK += ds^T q and
// dQ += ds k, as on the TPU (:413-416, :453).
//
// Two kernels rather than one with atomics: the dKdV block owns a k tile
// and loops over q tiles from the causal lower bound `lo`; the dQ block
// owns a q tile and loops over k tiles up to the causal bound `hi`.  No
// two blocks write the same output, so the results are deterministic.
//
// What bounds them on an H100: like the forward, the tensor-core rate at
// the slice's shape (the backward does 2.5x the forward's products).  The
// two kernels recompute s and dp each (the price of no atomics).  The
// first form below stages every product in shared memory, so it runs well
// below that bound; the Hopper forms keep them in registers.

#include "flash_bwd_dkdv_sm90.cuh"
#include "flash_bwd_dq_sm90.cuh"
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
struct BwdSmem {
  static constexpr int R = Tile<T>::kRows;
  static constexpr int LDT = D + Tile<T>::kSkew;  // q, k, v, dO tiles [R][D]
  static constexpr int LDS = R + 4;               // s, dp: f32 [R][R]
  static constexpr int LDP = R + Tile<T>::kSkew;  // p, ds: T [R][R]
  static constexpr int LDA = D + 4;               // dK, dV, dQ: f32 [R][D]
  static constexpr int kTile = round_up(R * LDT * (int)sizeof(T), 128);
  static constexpr int kScore = round_up(R * LDS * 4, 128);
  static constexpr int kProb = round_up(R * LDP * (int)sizeof(T), 128);
  static constexpr int kAcc = round_up(R * LDA * 4, 128);
  static constexpr int kRow = round_up(R * 4, 128);
  // dKdV: k, v, q, dO | s, dp | p, ds | dK, dV | lse, delta
  static constexpr int kDkdvBytes = 4 * kTile + 2 * kScore + 2 * kProb +
                                    2 * kAcc + 2 * kRow;
  // dQ: q, dO, k, v | s, dp | ds | dQ | lse, delta
  static constexpr int kDqBytes = 4 * kTile + 2 * kScore + kProb + kAcc +
                                  2 * kRow;
};

// Load lse and delta for rows [row0, row0 + R); rows past q_len carry
// lse = -inf, so their p and every contribution are exactly zero.
template <int R>
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_delta,
                                               const float* lse,
                                               const float* delta, int row0,
                                               int q_len) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool in = row0 + r < q_len;
    s_lse[r] = in ? lse[row0 + r] : -INFINITY;
    s_delta[r] = in ? delta[row0 + r] : 0.f;
  }
}

// (p, ds) for one (q tile, k tile) pair from the f32 scores s and dp:
// the shared backward math of _bwd_p_ds (TPU :362-381), masked as the
// forward masks.  Writes p (when s_p is not null) and ds in T.
template <typename T, int R, int LDS, int LDP>
__device__ __forceinline__ void p_ds(T* s_p, T* s_ds, const float* s_s,
                                     const float* s_dp, const float* s_lse,
                                     const float* s_delta, int q0, int k0,
                                     int kv_len, float scale, int causal,
                                     int q_offset) {
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int i = idx / R, j = idx % R;
    const float x = s_s[i * LDS + j] * scale;
    const float s =
        visible(q0 + i + q_offset, k0 + j, kv_len, causal) ? x : kMaskValue;
    const float l = s_lse[i];
    const bool finite = isfinite(l);
    const float p = finite ? expf(s - l) : 0.f;
    const float ds = p * (s_dp[i * LDS + j] - s_delta[i]) * scale;
    if (s_p != nullptr) s_p[i * LDP + j] = from_f32<T>(p);
    s_ds[i * LDP + j] = from_f32<T>(ds);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ d_o,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int q_len, int kv_len,
                          float scale, int causal, int q_offset) {
  using L = BwdSmem<T, D>;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* sK = reinterpret_cast<T*>(ptr);
  T* sV = reinterpret_cast<T*>(ptr += L::kTile);
  T* sQ = reinterpret_cast<T*>(ptr += L::kTile);
  T* sDO = reinterpret_cast<T*>(ptr += L::kTile);
  float* sS = reinterpret_cast<float*>(ptr += L::kTile);
  float* sDP = reinterpret_cast<float*>(ptr += L::kScore);
  T* sP = reinterpret_cast<T*>(ptr += L::kScore);
  T* sDS = reinterpret_cast<T*>(ptr += L::kProb);
  float* sDK = reinterpret_cast<float*>(ptr += L::kProb);
  float* sDV = reinterpret_cast<float*>(ptr += L::kAcc);
  float* sLse = reinterpret_cast<float*>(ptr += L::kAcc);
  float* sDelta = reinterpret_cast<float*>(ptr += L::kRow);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const size_t q_base = (size_t)bh * q_len, kv_base = (size_t)bh * kv_len;
  load_rows<T, R, D>(sK, L::LDT, k + kv_base * D, k0, kv_len);
  load_rows<T, R, D>(sV, L::LDT, v + kv_base * D, k0, kv_len);
  zero_tile<R, D>(sDK, L::LDA);
  zero_tile<R, D>(sDV, L::LDA);

  const int n_qb = cdiv(q_len, R);
  // q tiles strictly before this k tile see none of it (TPU :419-426);
  // the numerator may be negative, hence floor division.
  const int lo =
      causal ? min(max(0, floordiv(k0 - q_offset, R)), n_qb) : 0;
  for (int qb = lo; qb < n_qb; ++qb) {
    const int q0 = qb * R;
    __syncthreads();
    load_rows<T, R, D>(sQ, L::LDT, q + q_base * D, q0, q_len);
    load_rows<T, R, D>(sDO, L::LDT, d_o + q_base * D, q0, q_len);
    load_row_stats<R>(sLse, sDelta, lse + q_base, delta + q_base, q0, q_len);
    __syncthreads();
    gemm<R, R, D, true, false>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    gemm<R, R, D, true, false>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, false);
    __syncthreads();
    p_ds<T, R, L::LDS, L::LDP>(sP, sDS, sS, sDP, sLse, sDelta, q0, k0, kv_len,
                               scale, causal, q_offset);
    __syncthreads();
    // dV += p^T dO and dK += ds^T q: the transposed operand is read
    // column-major from its row-major tile.
    gemm<R, D, R, false, true>(sDV, L::LDA, sP, L::LDP, sDO, L::LDT, true);
    gemm<R, D, R, false, true>(sDK, L::LDA, sDS, L::LDP, sQ, L::LDT, true);
  }
  __syncthreads();
  store_rows<T, R, D>(dk + kv_base * D, sDK, L::LDA, k0, kv_len);
  store_rows<T, R, D>(dv + kv_base * D, sDV, L::LDA, k0, kv_len);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int q_len, int kv_len, float scale, int causal,
                        int q_offset) {
  using L = BwdSmem<T, D>;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* sQ = reinterpret_cast<T*>(ptr);
  T* sDO = reinterpret_cast<T*>(ptr += L::kTile);
  T* sK = reinterpret_cast<T*>(ptr += L::kTile);
  T* sV = reinterpret_cast<T*>(ptr += L::kTile);
  float* sS = reinterpret_cast<float*>(ptr += L::kTile);
  float* sDP = reinterpret_cast<float*>(ptr += L::kScore);
  T* sDS = reinterpret_cast<T*>(ptr += L::kScore);
  float* sDQ = reinterpret_cast<float*>(ptr += L::kProb);
  float* sLse = reinterpret_cast<float*>(ptr += L::kAcc);
  float* sDelta = reinterpret_cast<float*>(ptr += L::kRow);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const size_t q_base = (size_t)bh * q_len, kv_base = (size_t)bh * kv_len;
  load_rows<T, R, D>(sQ, L::LDT, q + q_base * D, q0, q_len);
  load_rows<T, R, D>(sDO, L::LDT, d_o + q_base * D, q0, q_len);
  load_row_stats<R>(sLse, sDelta, lse + q_base, delta + q_base, q0, q_len);
  zero_tile<R, D>(sDQ, L::LDA);

  const int n_kb = cdiv(kv_len, R);
  const int hi = causal ? min(n_kb, cdiv(q0 + R + q_offset, R)) : n_kb;
  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * R;
    __syncthreads();
    load_rows<T, R, D>(sK, L::LDT, k + kv_base * D, k0, kv_len);
    load_rows<T, R, D>(sV, L::LDT, v + kv_base * D, k0, kv_len);
    __syncthreads();
    gemm<R, R, D, true, false>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    gemm<R, R, D, true, false>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, false);
    __syncthreads();
    p_ds<T, R, L::LDS, L::LDP>(nullptr, sDS, sS, sDP, sLse, sDelta, q0, k0,
                               kv_len, scale, causal, q_offset);
    __syncthreads();
    gemm<R, D, R, true, true>(sDQ, L::LDA, sDS, L::LDP, sK, L::LDT, true);
  }
  __syncthreads();
  store_rows<T, R, D>(dq + q_base * D, sDQ, L::LDA, q0, q_len);
}

// bf16 at head_dim 64 to 128 runs the Hopper redesign
// (flash_bwd_dkdv_sm90.cuh); every other pair runs the kernel above.
template <typename T, int D>
struct DkdvLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* d_o, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int q_len, int kv_len,
                         float scale, int causal, int q_offset,
                         cudaStream_t stream) {
    if constexpr (hopper_form<T, D>) {
      return sm90::DkdvSm90Launch<D>::run(q, k, v, d_o, lse, delta, dk, dv,
                                          bh, q_len, kv_len, scale, causal,
                                          q_offset, stream);
    } else {
      using L = BwdSmem<T, D>;
      dim3 grid(cdiv(kv_len, L::R), bh);
      return launch(flash_bwd_dkdv_kernel<T, D>, grid, L::kDkdvBytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(d_o),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<T*>(dk),
                    static_cast<T*>(dv), q_len, kv_len, scale, causal, q_offset);
    }
  }
};

// bf16 at head_dim 64 to 128 runs the Hopper redesign
// (flash_bwd_dq_sm90.cuh); every other pair runs the kernel above.
template <typename T, int D>
struct DqLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* d_o, const void* lse, const void* delta,
                         void* dq, int bh, int q_len, int kv_len, float scale,
                         int causal, int q_offset, cudaStream_t stream) {
    if constexpr (hopper_form<T, D>) {
      return sm90::DqSm90Launch<D>::run(q, k, v, d_o, lse, delta, dq, bh,
                                        q_len, kv_len, scale, causal,
                                        q_offset, stream);
    } else {
      using L = BwdSmem<T, D>;
      dim3 grid(cdiv(q_len, L::R), bh);
      return launch(flash_bwd_dq_kernel<T, D>, grid, L::kDqBytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(d_o),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<T*>(dq),
                    q_len, kv_len, scale, causal, q_offset);
    }
  }
};

}  // namespace hvdflash

// q, dO: [bh, q_len, head_dim]; k, v: [bh, kv_len, head_dim], contiguous,
// all in dtype; lse, delta: [bh, q_len] f32; dk, dv like k.
extern "C" int hvd_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* d_o, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int q_len, int kv_len, int head_dim,
                                  int dtype, float scale, int causal,
                                  int q_offset, void* stream) {
  if (bh == 0 || kv_len == 0) return cudaSuccess;
  return hvdflash::dispatch<hvdflash::DkdvLaunch>(
      dtype, head_dim, q, k, v, d_o, lse, delta, dk, dv, bh, q_len, kv_len,
      scale, causal, q_offset, static_cast<cudaStream_t>(stream));
}

// dq like q.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* d_o, const void* lse,
                                const void* delta, void* dq, int bh,
                                int q_len, int kv_len, int head_dim, int dtype,
                                float scale, int causal, int q_offset,
                                void* stream) {
  if (bh == 0 || q_len == 0) return cudaSuccess;
  return hvdflash::dispatch<hvdflash::DqLaunch>(
      dtype, head_dim, q, k, v, d_o, lse, delta, dq, bh, q_len, kv_len, scale,
      causal, q_offset, static_cast<cudaStream_t>(stream));
}
