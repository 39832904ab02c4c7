// serving_gemm and cache_attention: the serving path's products and its
// masked-softmax attention, with a reduction order that does not depend on
// how many rows a call carries.
//
// Neither has a Pallas counterpart.  The reference's serving half
// (horovod_tpu/models/transformer.py forward_step :496, cache_attention
// :458) is plain jnp that XLA compiles; its contract is bitwise: a prefill
// followed by N one-token decodes gives the logits of the non-incremental
// forward, row for row.  A library GEMM picks its kernel (and split-K) by
// shape, so row i of x[:M] @ W changes bits with M; these kernels fix the
// order of every sum instead.
//
// Each has two forms.  The Hopper forms (serving_gemm_sm90.cuh,
// cache_attention_sm90.cuh: TMA, wgmma) take bf16: serving_gemm when K
// and N are multiples of 8, cache_attention at head_dim 64 and 128.  The
// first forms below take the rest, f32 included; ops/serving.py chooses
// by (dtype, K, N) and (dtype, head_dim), never by the number of rows.
// Each form has its own entry point, so the first form's bf16 build can
// be timed against the Hopper form.
//
// The first forms:
//
// serving_gemm: out[M, N] = x[M, K] @ w[K, N], f32 (or bf16) in, f32
// accumulation, rounded once to the output dtype (bf16 for the layers'
// products, f32 for the logits).  A block owns 16 rows and 32 columns (one
// a lane).  K is cut into chunks of 256 staged in shared memory (as f32,
// transposed, so a lane reads its 16 rows' x with four 16-byte loads); in
// each chunk warp w sums the fixed slice [32w, 32w + 32) into its 16
// accumulators with fused multiply-adds in k order, and at the end the
// eight warps' partials are added in warp order.  So output (m, n) is one
// fixed function of x[m, :], w[:, n] and K: no split-K over blocks, no
// atomics, nothing that depends on M or on the row's place in its tile.
// It runs outside the tensor cores.
//
// cache_attention: the reference's formula for one (batch, head, query
// row) a block: scores s_j = (q . k_j) * hd^-0.5 in f32 (the dot in d
// order), for the keys j <= q_pos only (the reference masks the rest to
// -inf, whose exp is an exact 0), the max m (0 if not finite), p_j =
// exp(s_j - m), denom = the sum of p (a fixed tree over the block; 1 if
// 0), then out_d = sum_j (p_j / denom) v_jd in j order, rounded once to
// the input dtype.  A row with q_pos < 0 comes out all zero.  The order of
// every sum depends on q_pos alone, not on the batch, the number of query
// rows or the capacity.  It reads j < min(q_pos + 1, cap) only.
//
// Both forms are built without --use_fast_math: expf, exp2f, the fused
// multiply-adds and the adds are IEEE operations nvcc does not reorder,
// so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <chrono>
#include <cmath>
#include <cstdint>

#include "cache_attention_sm90.cuh"
#include "serving_gemm_sm90.cuh"

namespace hvdserve {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kGemmRows = 16;    // rows a block
constexpr int kGemmCols = 32;    // columns a block, one a lane
constexpr int kGemmWarps = 8;    // fixed K slices inside a chunk
constexpr int kGemmChunk = 256;  // K staged a step (32 a warp)
constexpr int kGemmThreads = kGemmWarps * 32;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
    serving_gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                        TOut* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[kGemmChunk][kGemmRows];
  __shared__ float part[kGemmWarps][kGemmRows][kGemmCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kGemmCols + lane;
  const int m0 = blockIdx.y * kGemmRows;
  float acc[kGemmRows];
#pragma unroll
  for (int r = 0; r < kGemmRows; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kGemmChunk) {
    // Stage x[m0:m0+16, k0:k0+256] as f32, transposed: xs[k][row].
    for (int i = threadIdx.x; i < kGemmRows * kGemmChunk;
         i += kGemmThreads) {
      const int kk = i / kGemmRows, r = i % kGemmRows;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.0f;
    }
    __syncthreads();
    const int kb = warp * (kGemmChunk / kGemmWarps);
    const int ke = min(kb + kGemmChunk / kGemmWarps, K - k0);
    if (n < N) {
#pragma unroll 4
      for (int kk = kb; kk < ke; ++kk) {
        const float wv = to_f32(w[(size_t)(k0 + kk) * N + n]);
        const float4* xr = reinterpret_cast<const float4*>(xs[kk]);
#pragma unroll
        for (int q = 0; q < kGemmRows / 4; ++q) {
          const float4 a = xr[q];
          acc[4 * q + 0] = __fmaf_rn(a.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = __fmaf_rn(a.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = __fmaf_rn(a.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = __fmaf_rn(a.w, wv, acc[4 * q + 3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kGemmRows; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < kGemmRows * kGemmCols; i += kGemmThreads) {
    const int r = i / kGemmCols, c = i % kGemmCols;
    const int m = m0 + r, nn = blockIdx.x * kGemmCols + c;
    if (m < M && nn < N) {
      float s = part[0][r][c];
#pragma unroll
      for (int v = 1; v < kGemmWarps; ++v) s = __fadd_rn(s, part[v][r][c]);
      store(out + (size_t)m * N + nn, s);
    }
  }
}

constexpr int kAttnThreads = 128;

// Warp-then-block reductions in one fixed pattern (xor butterfly, then the
// four warps in order): the same for every block of a given n.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kAttnThreads / 32; ++i) m = fmaxf(m, red[i]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int i = 1; i < kAttnThreads / 32; ++i) s = __fadd_rn(s, red[i]);
  __syncthreads();
  return s;
}

// q, out: [B, S, H, hd]; k, v: [B, cap, H, hd] with batch stride
// kv_batch_stride elements; q_pos: [B, S] int32.  Dynamic shared memory:
// hd + cap + 4 floats.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    cache_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_pos,
                           T* __restrict__ out, int S, int H, int cap, int hd,
                           long long kv_batch_stride, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* p = smem + hd;
  float* red = p + cap;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t row = ((size_t)b * S + i) * H + h;
  T* o = out + row * hd;
  const int qp = q_pos[(size_t)b * S + i];
  if (qp < 0) {
    for (int d = threadIdx.x; d < hd; d += kAttnThreads) store(o + d, 0.0f);
    return;
  }
  for (int d = threadIdx.x; d < hd; d += kAttnThreads)
    qs[d] = to_f32(q[row * hd + d]);
  __syncthreads();
  const int n = min(qp + 1, cap);
  const size_t stride = (size_t)H * hd;
  const T* kb = k + (size_t)b * kv_batch_stride + (size_t)h * hd;
  const T* vb = v + (size_t)b * kv_batch_stride + (size_t)h * hd;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kAttnThreads) {
    const T* kr = kb + (size_t)j * stride;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = __fmaf_rn(qs[d], to_f32(kr[d]), s);
    s = __fmul_rn(s, scale);
    p[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, red);
  if (!isfinite(mx)) mx = 0.0f;
  float part = 0.0f;
  for (int j = threadIdx.x; j < n; j += kAttnThreads) {
    const float e = expf(__fsub_rn(p[j], mx));
    p[j] = e;
    part = __fadd_rn(part, e);
  }
  float denom = block_sum(part, red);
  if (denom == 0.0f) denom = 1.0f;
  for (int j = threadIdx.x; j < n; j += kAttnThreads)
    p[j] = __fdiv_rn(p[j], denom);
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kAttnThreads) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j)
      acc = __fmaf_rn(p[j], to_f32(vb[(size_t)j * stride + d]), acc);
    store(o + d, acc);
  }
}

template <typename TIn, typename TOut>
int launch_gemm(const void* x, const void* w, void* out, int M, int N, int K,
                cudaStream_t s) {
  const dim3 grid((N + kGemmCols - 1) / kGemmCols,
                  (M + kGemmRows - 1) / kGemmRows);
  serving_gemm_kernel<TIn, TOut><<<grid, kGemmThreads, 0, s>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w),
      static_cast<TOut*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T>
int launch_attention(const void* q, const void* k, const void* v,
                     const int* q_pos, void* out, int B, int S, int H,
                     int cap, int hd, long long kv_batch_stride, float scale,
                     cudaStream_t s) {
  const size_t shmem = sizeof(float) * (hd + cap + kAttnThreads / 32);
  auto kernel = cache_attention_kernel<T>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(S, H, B), kAttnThreads, shmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, static_cast<T*>(out), S, H, cap, hd,
      kv_batch_stride, scale);
  return cudaGetLastError();
}

}  // namespace hvdserve

// The first forms.  in_dtype: 0 f32, 1 bf16 (x and w alike); out_dtype:
// 0 f32, 1 bf16 (bf16 only from bf16 inputs).
extern "C" int hvd_serving_gemm_first(const void* x, const void* w,
                                      void* out, int M, int N, int K,
                                      int in_dtype, int out_dtype,
                                      void* stream) {
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return hvdserve::launch_gemm<float, float>(x, w, out, M, N, K, s);
  if (in_dtype == 1 && out_dtype == 1)
    return hvdserve::launch_gemm<__nv_bfloat16, __nv_bfloat16>(x, w, out, M,
                                                              N, K, s);
  if (in_dtype == 1 && out_dtype == 0)
    return hvdserve::launch_gemm<__nv_bfloat16, float>(x, w, out, M, N, K, s);
  return cudaErrorInvalidValue;
}

extern "C" int hvd_cache_attention_first(const void* q, const void* k,
                                         const void* v, const void* q_pos,
                                         void* out, int B, int S, int H,
                                         int cap, int hd,
                                         long long kv_batch_stride,
                                         int dtype, float scale,
                                         void* stream) {
  if (B < 0 || S < 0 || H < 0 || cap < 1 || hd < 1)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(q_pos);
  if (dtype == 0)
    return hvdserve::launch_attention<float>(q, k, v, pos, out, B, S, H, cap,
                                             hd, kv_batch_stride, scale, s);
  if (dtype == 1)
    return hvdserve::launch_attention<__nv_bfloat16>(
        q, k, v, pos, out, B, S, H, cap, hd, kv_batch_stride, scale, s);
  return cudaErrorInvalidValue;
}

// The Hopper forms.  serving_gemm: bf16 x [M, K] and w [K, N] row-major
// with rows ldx and ldw elements apart (multiples of 8), out [M, N]
// contiguous, out_dtype 0 f32 or 1 bf16, output tiles tile_n (64 or 128)
// wide, `split` K ranges (1 to 8) added in one cluster.
extern "C" int hvd_serving_gemm_sm90(const void* x, long long ldx,
                                     const void* w, long long ldw, void* out,
                                     int M, int N, int K, int out_dtype,
                                     int tile_n, int split, void* stream) {
  using hvdserve::sm90::launch_gemm;
  if (M < 0 || N < 0 || K < 1) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1 && tile_n == 64)
    return launch_gemm<__nv_bfloat16, 64>(x, ldx, w, ldw, out, M, N, K, split,
                                          s);
  if (out_dtype == 1 && tile_n == 128)
    return launch_gemm<__nv_bfloat16, 128>(x, ldx, w, ldw, out, M, N, K,
                                           split, s);
  if (out_dtype == 0 && tile_n == 64)
    return launch_gemm<float, 64>(x, ldx, w, ldw, out, M, N, K, split, s);
  if (out_dtype == 0 && tile_n == 128)
    return launch_gemm<float, 128>(x, ldx, w, ldw, out, M, N, K, split, s);
  return cudaErrorInvalidValue;
}

// cache_attention: bf16 q [B, S, H, hd], k and v [B, cap, H, hd] with
// element strides (q_sb, q_ss, q_sh), (k_sb, k_sc, k_sh), (v_sb, v_sc,
// v_sh) and unit stride over hd; q_pos [B, S] int64 (as the model makes
// them); out [B, S, H, hd] contiguous bf16; hd 64 or 128.
extern "C" int hvd_cache_attention_sm90(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_sc, long long k_sh,
    const void* v, long long v_sb, long long v_sc, long long v_sh,
    const void* q_pos, void* out, int B, int S, int H, int cap, int hd,
    float scale, void* stream) {
  if (B < 0 || S < 0 || H < 0 || cap < 1) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_sc, k_sh},
                  vs[3] = {v_sb, v_sc, v_sh};
  const auto* pos = static_cast<const long long*>(q_pos);
  if (hd == 64)
    return hvdserve::sm90::launch_attention<64>(q, qs, k, ks, v, vs, pos, out,
                                                B, S, H, cap, scale, s);
  if (hd == 128)
    return hvdserve::sm90::launch_attention<128>(q, qs, k, ks, v, vs, pos,
                                                 out, B, S, H, cap, scale, s);
  return cudaErrorInvalidValue;
}

// Host microseconds to encode one tensor map, averaged over `iters`
// encodes of the decode attention's K map (b8, cap 1024, 12 heads, hd 64,
// batch stride 1025 rows) at device address `base`; the Hopper forms
// encode two (serving_gemm) or three (cache_attention) maps a launch.
// Returns a negative value if an encode fails.
extern "C" double hvd_serving_tensor_map_us(const void* base, int iters) {
  CUtensorMap map;
  const long long row = 12 * 64;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (hvdflash::sm90::make_map_4d(&map, base, 8, 1024, 12, 64, 1025 * row,
                                    row, 64) != cudaSuccess)
      return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}
