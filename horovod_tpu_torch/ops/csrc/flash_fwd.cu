// flash_fwd: the online-softmax attention forward on Hopper.
//
// Replaces horovod_tpu/ops/flash_attention.py _fwd_kernel_resident (and
// computes what the streaming _fwd_kernel computes for kv > 4096: a
// block that loops over K/V tiles has no resident/streaming split).
//
// Two forms: bf16 at head_dim 64, 80, 96 and 128 runs the Hopper redesign
// in flash_fwd_sm90.cuh (TMA, wgmma, registers); f32 and bf16 at head_dim
// 16 and 32 run the first form below (FwdLaunch chooses at compile time,
// hopper_form in flash_common.cuh).  The first form's shared memory is
// largest at f32 head_dim 128 (FwdSmem: 77,056 B; 60,672 at 96).
//
// One thread block per (batch*head, 64-row q tile).  It holds its q tile
// in shared memory, loops over 64-key K/V tiles up to the causal bound
// `hi` (the TPU kernel's formula, with q_block_offset), keeps the running
// max m, the sum l and the f32 accumulator, and writes o in the input
// dtype and lse in f32.  Rows with no visible key get o = 0, lse = -inf.
//
// What bounds it on an H100: at head_dim 64 the forward does 4*d = 256
// flops per score against 4*d bytes of q/k/v/o per row, so at the
// slice's shape (b8, h12, s1024, causal) it is bound by the tensor-core
// rate, not by memory.  This first form stages every product's operands
// and results in shared memory (WMMA fragments in and out), so it runs
// well below that rate.  The causal bound skips every tile past the
// diagonal, so the work is the visible triangle only.

#include <chrono>

#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"

namespace hvdflash {

template <typename T, int D>
struct FwdSmem {
  static constexpr int R = Tile<T>::kRows;
  static constexpr int LDT = D + Tile<T>::kSkew;  // q, k, v tiles [R][D]
  static constexpr int LDS = R + 4;               // scores, f32 [R][R]
  static constexpr int LDP = R + Tile<T>::kSkew;  // p, T [R][R]
  static constexpr int LDA = D + 4;               // accumulator, f32 [R][D]
  static constexpr int kTile = round_up(R * LDT * (int)sizeof(T), 128);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kS = kV + kTile;
  static constexpr int kP = kS + round_up(R * LDS * 4, 128);
  static constexpr int kAcc = kP + round_up(R * LDP * (int)sizeof(T), 128);
  static constexpr int kM = kAcc + round_up(R * LDA * 4, 128);
  static constexpr int kL = kM + round_up(R * 4, 128);
  static constexpr int kBytes = kL + round_up(R * 4, 128);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int q_len, int kv_len,
                     float scale, int causal, int q_offset) {
  using L = FwdSmem<T, D>;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  float* sAcc = reinterpret_cast<float*>(smem + L::kAcc);
  float* sM = reinterpret_cast<float*>(smem + L::kM);
  float* sL = reinterpret_cast<float*>(smem + L::kL);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const T* qg = q + (size_t)bh * q_len * D;
  const T* kg = k + (size_t)bh * kv_len * D;
  const T* vg = v + (size_t)bh * kv_len * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, R, D>(sQ, L::LDT, qg, q0, q_len);
  zero_tile<R, D>(sAcc, L::LDA);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  const int n_kb = cdiv(kv_len, R);
  // K tiles entirely in the future contribute nothing (TPU :172-178).
  const int hi = causal ? min(n_kb, cdiv(q0 + R + q_offset, R)) : n_kb;
  for (int kb = 0; kb < hi; ++kb) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, R, D>(sK, L::LDT, kg, kb * R, kv_len);
    load_rows<T, R, D>(sV, L::LDT, vg, kb * R, kv_len);
    __syncthreads();
    gemm<R, R, D, true, false>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    __syncthreads();
    // Online softmax, one warp per row: scale the f32 scores, mask,
    // update m and l, write p in the dtype of v, rescale the row of acc.
    for (int r = warp; r < R; r += kWarps) {
      const int q_pos = q0 + r + q_offset;
      float s[R / 32];
      float m_cur = -INFINITY;
#pragma unroll
      for (int j = 0; j < R / 32; ++j) {
        const int c = lane + 32 * j;
        const float x = sS[r * L::LDS + c] * scale;
        s[j] = visible(q_pos, kb * R + c, kv_len, causal) ? x : kMaskValue;
        m_cur = fmaxf(m_cur, s[j]);
      }
      m_cur = warp_max(m_cur);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < R / 32; ++j) {
        const float p = expf(s[j] - m_new);
        row_sum += p;
        sP[r * L::LDP + lane + 32 * j] = from_f32<T>(p);
      }
      row_sum = warp_sum(row_sum);
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) sAcc[r * L::LDA + c] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = alpha * sL[r] + row_sum;
      }
    }
    __syncthreads();
    gemm<R, D, R, true, true>(sAcc, L::LDA, sP, L::LDP, sV, L::LDT, true);
  }
  __syncthreads();

  // Rows with no visible key: no tile ran (l == 0) or every score stayed
  // at the mask floor.  They get o = 0 and lse = -inf (TPU :181-186).
  T* og = o + (size_t)bh * q_len * D;
  float* lg = lse + (size_t)bh * q_len;
  for (int r = warp; r < R; r += kWarps) {
    const int row = q0 + r;
    if (row >= q_len) continue;
    const float m = sM[r], l = sL[r];
    const bool no_valid = (l == 0.f) || (m <= kMaskValue * 0.5f);
    for (int c = lane; c < D; c += 32)
      og[(size_t)row * D + c] =
          from_f32<T>(no_valid ? 0.f : sAcc[r * L::LDA + c] / l);
    if (lane == 0) lg[row] = no_valid ? -INFINITY : m + logf(l);
  }
}

// bf16 at head_dim 64 to 128 runs the Hopper redesign
// (flash_fwd_sm90.cuh); every other pair runs the kernel above.
template <typename T, int D>
struct FwdLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int q_len, int kv_len, float scale,
                         int causal, int q_offset, cudaStream_t stream) {
    if constexpr (hopper_form<T, D>) {
      return sm90::FwdSm90Launch<D>::run(q, k, v, o, lse, bh, q_len, kv_len,
                                         scale, causal, q_offset, stream);
    } else {
      using L = FwdSmem<T, D>;
      dim3 grid(cdiv(q_len, L::R), bh);
      return launch(flash_fwd_kernel<T, D>, grid, L::kBytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(o),
                    static_cast<float*>(lse), q_len, kv_len, scale, causal,
                    q_offset);
    }
  }
};

}  // namespace hvdflash

// q, k, v: [bh, len, head_dim] contiguous in dtype; o like q; lse
// [bh, q_len] f32.  Returns the cudaError_t of the launch.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int q_len,
                             int kv_len, int head_dim, int dtype, float scale,
                             int causal, int q_offset, void* stream) {
  if (bh == 0 || q_len == 0) return cudaSuccess;
  return hvdflash::dispatch<hvdflash::FwdLaunch>(
      dtype, head_dim, q, k, v, o, lse, bh, q_len, kv_len, scale, causal,
      q_offset, static_cast<cudaStream_t>(stream));
}

// Host microseconds to encode one tensor map, averaged over `iters`
// encodes of a [96, 1024, 64] bf16 map at device address `base` (the
// redesigned kernels encode three or four maps at every launch).
// Returns a negative value if an encode fails.
extern "C" double hvd_flash_tensor_map_us(const void* base, int iters) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (hvdflash::sm90::make_map(&map, base, 96, 1024, 64, 128) !=
        cudaSuccess)
      return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}
