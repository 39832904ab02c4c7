// quant_pack and unpack_dequantize: the block-scaled int8/int4 wire codec
// of the quantized allreduce, on Hopper.
//
// The reference has no Pallas kernel here: horovod_tpu/ops/megakernel.py
// compiles quantize -> exchange -> dequantize into one XLA program per
// fusion group, from horovod_tpu/ops/compression.py quantize_blocks
// (:510), wire_pack (:552), wire_unpack (:562), dequantize_blocks (:535)
// and ordered_sum (:596).  In PyTorch eager that math is some twenty
// launches a leg; these two kernels do each leg in one pass.
//
// quant_pack: rows [r, C] (f32, bf16 or f16; C % block == 0) -> one wire
// frame per row: C codes (int8, or int4 two to a byte, the even element
// in the low nibble, +8 offset), then C / block bf16 scales as bytes.
// One warp quantizes one scaling block at a time (grid-stride over the
// blocks): a warp reduction of |x| gives amax, the scale is the smallest
// power of two with amax <= levels * scale, from the f32 bit pattern (the
// exponent field clipped to [1, 254], 0 for an all-zero block), and each
// element becomes clip(floor(x / scale + u)), where u is JAX's threefry
// dither uint8(b0 ^ b1) / 256 of the element's flat index in [r, C]
// (floor(x / scale + 1/2) for nearest rounding).  With a residual output
// it also writes x - dequant(q) in the input dtype.
//
// unpack_dequantize: wire [r, frame] -> codes x scale in f32, [r, C], or
// the rows summed in index order into [C].
//
// Bitwise equal to the plain PyTorch version: every scale is a power of
// two, so each quotient and product by it is exact; every other
// operation is one IEEE-rounded intrinsic (__fdiv_rn, __fadd_rn,
// __fmul_rn, __fsub_rn), which nvcc never contracts into an FMA; the
// row sum keeps its order.  Build without --use_fast_math.
//
// What bounds it on an H100: about 20 rounds of 32-bit integer work per
// element for the dither against 4-13 bytes of traffic per element, so
// the threefry, not memory, sets the time of the stochastic form; the
// bound the smoke test states is the bytes' (3.35 TB/s).  This first form
// keeps one block per warp and byte stores; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdquant {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// jax/_src/prng.py _threefry2x32_lowering, 20 rounds.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.bits(key, shape, uint8)[idx] / 256 under
// jax_threefry_partitionable: the counter is the flat index's (hi, lo).
__device__ __forceinline__ float dither(uint32_t k0, uint32_t k1,
                                        uint64_t idx) {
  uint32_t x0 = static_cast<uint32_t>(idx >> 32);
  uint32_t x1 = static_cast<uint32_t>(idx);
  threefry2x32(k0, k1, x0, x1);
  return __fmul_rn(static_cast<float>((x0 ^ x1) & 0xFFu), 0.00390625f);
}

// compression.py _pow2_scale (:481): integer arithmetic on the f32 bits.
template <int BITS>
__device__ __forceinline__ float pow2_scale(float amax) {
  const uint32_t a = __float_as_uint(amax);
  const int e = static_cast<int>(a >> 23) - 127;
  const int m = static_cast<int>(a & 0x7FFFFFu);
  const int base = BITS == 8 ? 6 : 2;
  const int thresh = BITS == 8 ? 8257536 : 6291456;  // .984375, .75 of 2^23
  int pe = e - base + (m > thresh ? 1 : 0) + 127;
  pe = pe < 1 ? 1 : (pe > 254 ? 254 : pe);
  return amax > 0.f ? __uint_as_float(static_cast<uint32_t>(pe) << 23)
                    : 0.f;
}

template <int BITS>
__device__ __forceinline__ int quantize_one(float v, float div,
                                            int stochastic, uint32_t k0,
                                            uint32_t k1, uint64_t idx) {
  constexpr float lv = BITS == 8 ? 127.f : 7.f;
  float x = __fdiv_rn(v, div);
  x = __fadd_rn(x, stochastic ? dither(k0, k1, idx) : 0.5f);
  x = fminf(fmaxf(floorf(x), -lv), lv);
  return static_cast<int>(x);
}

template <typename T>
__device__ __forceinline__ T residual(float v, int q, float scale) {
  // vin - dequant(q).astype(dtype), in the input dtype.
  const float d = to_f(from_f<T>(__fmul_rn(static_cast<float>(q), scale)));
  return from_f<T>(__fsub_rn(v, d));
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
    quant_pack_kernel(const T* __restrict__ rows, uint8_t* __restrict__ wire,
                      T* __restrict__ resid, int64_t r, int64_t C, int block,
                      int stochastic, uint32_t k0, uint32_t k1) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t per_row = C / block;
  const int64_t codes = C * BITS / 8;
  const int64_t frame = codes + 2 * per_row;
  for (int64_t b = warp; b < r * per_row; b += n_warps) {
    const int64_t row = b / per_row;
    const int64_t col0 = (b % per_row) * block;
    const int64_t base = row * C + col0;
    const T* src = rows + base;
    float amax = 0.f;
    for (int i = lane; i < block; i += 32)
      amax = fmaxf(amax, fabsf(to_f(src[i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = pow2_scale<BITS>(amax);
    const float div = scale > 0.f ? scale : 1.f;
    uint8_t* out = wire + row * frame;
    for (int p = lane; p < block / 2; p += 32) {
      const int64_t col = col0 + 2 * p;
      const float v0 = to_f(src[2 * p]), v1 = to_f(src[2 * p + 1]);
      const uint64_t idx = static_cast<uint64_t>(base + 2 * p);
      const int q0 = quantize_one<BITS>(v0, div, stochastic, k0, k1, idx);
      const int q1 =
          quantize_one<BITS>(v1, div, stochastic, k0, k1, idx + 1);
      if (BITS == 8) {
        out[col] = static_cast<uint8_t>(static_cast<int8_t>(q0));
        out[col + 1] = static_cast<uint8_t>(static_cast<int8_t>(q1));
      } else {
        out[col / 2] = static_cast<uint8_t>((q0 + 8) | ((q1 + 8) << 4));
      }
      if (resid != nullptr) {
        resid[base + 2 * p] = residual<T>(v0, q0, scale);
        resid[base + 2 * p + 1] = residual<T>(v1, q1, scale);
      }
    }
    if (lane == 0) {
      // The bf16 of a power of two is its f32's high half, exactly.
      const uint32_t s = __float_as_uint(scale) >> 16;
      const int64_t at = codes + 2 * (b % per_row);
      out[at] = static_cast<uint8_t>(s & 0xFFu);
      out[at + 1] = static_cast<uint8_t>(s >> 8);
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_kernel(const uint8_t* __restrict__ wire,
                             float* __restrict__ out, int64_t r, int64_t C,
                             int block, int sum_rows) {
  const int64_t pairs = C / 2;
  const int64_t codes = C * BITS / 8;
  const int64_t frame = codes + 2 * (C / block);
  const int64_t total = sum_rows ? pairs : r * pairs;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t first = sum_rows ? 0 : t / pairs;
    const int64_t last = sum_rows ? r : first + 1;
    const int64_t p = sum_rows ? t : t % pairs;
    const int64_t col = 2 * p;
    const int64_t at = codes + 2 * (col / block);
    float a0 = 0.f, a1 = 0.f;
    for (int64_t row = first; row < last; ++row) {
      const uint8_t* w = wire + row * frame;
      const float s = __uint_as_float(
          (static_cast<uint32_t>(w[at]) |
           (static_cast<uint32_t>(w[at + 1]) << 8)) << 16);
      int q0, q1;
      if (BITS == 8) {
        q0 = static_cast<int8_t>(w[col]);
        q1 = static_cast<int8_t>(w[col + 1]);
      } else {
        const int byte = w[p];
        q0 = (byte & 0xF) - 8;
        q1 = (byte >> 4) - 8;
      }
      const float d0 = __fmul_rn(static_cast<float>(q0), s);
      const float d1 = __fmul_rn(static_cast<float>(q1), s);
      // ordered_sum: rows[0] + rows[1] + ..., in index order.
      a0 = row == first ? d0 : __fadd_rn(a0, d0);
      a1 = row == first ? d1 : __fadd_rn(a1, d1);
    }
    float* o = out + (sum_rows ? 0 : first * C) + col;
    o[0] = a0;
    o[1] = a1;
  }
}

inline int grid_for(int64_t work, int64_t per_block) {
  const int64_t g = (work + per_block - 1) / per_block;
  return static_cast<int>(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

template <typename T>
cudaError_t launch_pack(const void* rows, void* wire, void* resid, int64_t r,
                        int64_t C, int bits, int block, int stochastic,
                        uint32_t k0, uint32_t k1, cudaStream_t stream) {
  const int grid = grid_for(r * (C / block), kThreads / 32);
  if (bits == 8)
    quant_pack_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<uint8_t*>(wire),
        static_cast<T*>(resid), r, C, block, stochastic, k0, k1);
  else
    quant_pack_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<uint8_t*>(wire),
        static_cast<T*>(resid), r, C, block, stochastic, k0, k1);
  return cudaGetLastError();
}

}  // namespace hvdquant

// dtype: 0 f32, 1 bf16, 2 f16.  bits: 8 or 4.  resid may be null.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int hvd_quant_pack(const void* rows, void* wire, void* resid,
                              long long r, long long C, int dtype, int bits,
                              int block, int stochastic, unsigned int k0,
                              unsigned int k1, void* stream) {
  if ((bits != 8 && bits != 4) || block < 2 || block % 2 || C % block)
    return cudaErrorInvalidValue;
  if (r == 0 || C == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return hvdquant::launch_pack<float>(rows, wire, resid, r, C, bits,
                                          block, stochastic, k0, k1, s);
    case 1:
      return hvdquant::launch_pack<__nv_bfloat16>(
          rows, wire, resid, r, C, bits, block, stochastic, k0, k1, s);
    case 2:
      return hvdquant::launch_pack<__half>(rows, wire, resid, r, C, bits,
                                           block, stochastic, k0, k1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int hvd_unpack_dequantize(const void* wire, void* out, long long r,
                                     long long C, int bits, int block,
                                     int sum_rows, void* stream) {
  if ((bits != 8 && bits != 4) || block < 2 || block % 2 || C % block)
    return cudaErrorInvalidValue;
  if (r == 0 || C == 0) return cudaSuccess;
  const int64_t work = sum_rows ? C / 2 : r * (C / 2);
  const int grid = hvdquant::grid_for(work, hvdquant::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    hvdquant::unpack_dequantize_kernel<8><<<grid, hvdquant::kThreads, 0, s>>>(
        static_cast<const uint8_t*>(wire), static_cast<float*>(out), r, C,
        block, sum_rows);
  else
    hvdquant::unpack_dequantize_kernel<4><<<grid, hvdquant::kThreads, 0, s>>>(
        static_cast<const uint8_t*>(wire), static_cast<float*>(out), r, C,
        block, sum_rows);
  return cudaGetLastError();
}
