// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile sizes, the score mask, tile loads, the
// shared-memory tile products and the (dtype, head_dim) dispatch.
//
// Layout everywhere: one (batch*head) slice of q/k/v/o is a contiguous
// [seq, head_dim] row-major matrix; lse/delta are [batch*head, seq] f32.
//
// Two forms of kernel.  bf16 at head_dim 64, 80, 96 and 128 (the widths
// users train at: GPT-2's 64, GPT-3 2.7B's 80, GPT-3 Large's 96) runs the
// Hopper redesign of the forward, dK/dV and dQ (flash_fwd_sm90.cuh,
// flash_bwd_dkdv_sm90.cuh, flash_bwd_dq_sm90.cuh: TMA, wgmma, register
// accumulators; hopper_form below).  Every other pair runs the first
// form below: one thread block owns one 64-row tile of its output (32
// rows for f32) and walks the other side's tiles in a loop, so no two
// blocks write the same output (no atomics, results deterministic).
// Every operand tile is staged in shared memory; the products run on the
// tensor cores through WMMA 16x16x16 fragments for bf16 (bf16 operands,
// f32 accumulation, as the TPU kernels' preferred_element_type=f32 dots)
// and as a plain FMA loop for f32, which keeps full f32 products (a
// wgmma on f32 is TF32 and would miss the reference's 5e-5/1e-4).
// Accumulators live in shared memory in f32 so that the online-softmax
// rescale and the mask are plain per-element code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace hvdflash {

// horovod_tpu/ops/flash_attention.py DEFAULT_MASK_VALUE: a finite floor,
// so that m_prev - m_new never becomes (-inf) - (-inf).
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Tile rows and the row skew (in elements) that staggers shared-memory
// rows across banks.  f32 tiles are halved so that the f32 backward at
// head_dim 128 fits the 227 KB a block may use.
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kRows = 64;
  static constexpr int kSkew = 8;
};
template <> struct Tile<float> {
  static constexpr int kRows = 32;
  static constexpr int kSkew = 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floor division, as jnp's // on a possibly negative numerator.
__host__ __device__ inline int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
// Ceiling division, as pl.cdiv.
__host__ __device__ inline int cdiv(int a, int b) { return -floordiv(-a, b); }

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The score mask of _apply_mask: keys past kv_len, and, when causal,
// keys after the query's global position.
__device__ __forceinline__ bool visible(int q_pos, int k_pos, int kv_len,
                                        int causal) {
  return k_pos < kv_len && (!causal || q_pos >= k_pos);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + R) of a [n_rows, D] matrix into a shared tile
// with row stride ld, 16 bytes per thread per step; rows past n_rows are
// zero (the ragged tail).
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Fill an [R, D] f32 shared tile with zeros.
template <int R, int D>
__device__ __forceinline__ void zero_tile(float* dst, int ld) {
  for (int i = threadIdx.x; i < R * D; i += kThreads)
    dst[(i / D) * ld + i % D] = 0.f;
}

// Write rows of an [R, D] f32 shared tile that lie before n_rows to a
// [n_rows, D] global matrix in T.
template <typename T, int R, int D>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int ld,
                                           int row0, int n_rows) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (row0 + r < n_rows)
      dst[(size_t)(row0 + r) * D + c] = from_f32<T>(src[r * ld + c]);
  }
}

// C[M, N] (f32, shared, stride ldc) = (accumulate ? C : 0) + A[M, K] B[K, N]
// with A(i, k) = A_ROW ? A[i*lda + k] : A[k*lda + i]
// and  B(k, j) = B_ROW ? B[k*ldb + j] : B[j*ldb + k].
// bf16: WMMA 16x16x16 on the tensor cores, the block's warps splitting
// the 16x16 output tiles.  Callers synchronise around it.
template <int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void gemm(float* C, int ldc, const __nv_bfloat16* A,
                                     int lda, const __nv_bfloat16* B, int ldb,
                                     bool accumulate) {
  using namespace nvcuda;
  using LA = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
  using LB = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
  constexpr int TN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * TN; t += kWarps) {
    const int ti = t / TN, tj = t % TN;
    float* cp = C + ti * 16 * ldc + tj * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (accumulate)
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      const __nv_bfloat16* ap =
          A_ROW ? A + ti * 16 * lda + kk : A + kk * lda + ti * 16;
      const __nv_bfloat16* bp =
          B_ROW ? B + kk * ldb + tj * 16 : B + tj * 16 * ldb + kk;
      wmma::load_matrix_sync(a, ap, lda);
      wmma::load_matrix_sync(b, bp, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// f32: one FMA loop per output element (no TF32, so the f32 path keeps
// full f32 products, like the reference's f32 dots).
template <int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void gemm(float* C, int ldc, const float* A,
                                     int lda, const float* B, int ldb,
                                     bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx % N;
    float acc = accumulate ? C[i * ldc + j] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_ROW ? A[i * lda + k] : A[k * lda + i];
      const float b = B_ROW ? B[k * ldb + j] : B[j * ldb + k];
      acc = fmaf(a, b, acc);
    }
    C[i * ldc + j] = acc;
  }
}

// The pairs that run the Hopper redesign (the *_sm90.cuh kernels, which
// hold head_dim in 64-column panels, a partial second panel zero-padded).
template <typename T, int D>
constexpr bool hopper_form = std::is_same_v<T, __nv_bfloat16> && D >= 64;

// dtype codes shared with horovod_tpu_torch/ops/flash_attention.py.
enum DType : int { kF32 = 0, kBF16 = 1 };

// Runs Launch<T, D>::run() for the (dtype, head_dim) pair, or reports an
// invalid value for a pair the kernels are not built for.  Each Launch
// chooses its form at compile time from (T, D); neither form falls back
// on the other.
template <template <typename, int> class Launch, typename... Args>
cudaError_t dispatch(int dtype, int head_dim, Args... args) {
#define HVD_FLASH_CASE(T, D) \
  if (head_dim == D) return Launch<T, D>::run(args...);
  if (dtype == kBF16) {
    HVD_FLASH_CASE(__nv_bfloat16, 16)
    HVD_FLASH_CASE(__nv_bfloat16, 32)
    HVD_FLASH_CASE(__nv_bfloat16, 64)
    HVD_FLASH_CASE(__nv_bfloat16, 80)
    HVD_FLASH_CASE(__nv_bfloat16, 96)
    HVD_FLASH_CASE(__nv_bfloat16, 128)
  } else if (dtype == kF32) {
    HVD_FLASH_CASE(float, 16)
    HVD_FLASH_CASE(float, 32)
    HVD_FLASH_CASE(float, 64)
    HVD_FLASH_CASE(float, 80)
    HVD_FLASH_CASE(float, 96)
    HVD_FLASH_CASE(float, 128)
  }
#undef HVD_FLASH_CASE
  return cudaErrorInvalidValue;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, then launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int smem_bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace hvdflash
