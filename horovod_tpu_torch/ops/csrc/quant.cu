// quant_pack and unpack_dequantize: the block-scaled int8/int4 wire codec
// of the quantized allreduce, on Hopper.
//
// The reference has no Pallas kernel here: horovod_tpu/ops/megakernel.py
// compiles quantize -> exchange -> dequantize into one XLA program per
// fusion group, from horovod_tpu/ops/compression.py quantize_blocks
// (:510), wire_pack (:552), wire_unpack (:562), dequantize_blocks (:535)
// and ordered_sum (:596).  In PyTorch eager that math is some twenty
// launches a leg; these kernels do each leg in one pass.
//
// quant_pack: rows [r, C] (f32, bf16 or f16; C % block == 0) -> one wire
// frame per row: C codes (int8, or int4 two to a byte, the even element
// in the low nibble, +8 offset), then C / block bf16 scales as bytes.
// Each scaling block's amax (a NaN-propagating max of |x|, as jnp.max
// and torch.amax) gives its scale, the smallest power of two with amax
// <= levels * scale, from the f32 bit pattern (the exponent field
// clipped to [1, 254]; 0 when amax > 0 is false: an all-zero block, or a
// NaN in it).  Each element becomes clip(floor(x / scale + u)), where u
// is JAX's threefry dither uint8(b0 ^ b1) / 256 of the element's flat
// index in [r, C] (floor(x / scale + 1/2) for nearest rounding; x / 1
// for the scale 0), and a NaN quotient becomes the code 0, as XLA's and
// torch's float -> int8 casts give it.  With a residual output it also
// writes x - dequant(q) in the input dtype.
//
// unpack_dequantize: wire [r, frame] -> codes x scale in f32, [r, C], or
// the rows summed in index order into [C].
//
// Bitwise equal to the plain PyTorch version: every scale is a power of
// two, so each product by it is exact; every other operation is one
// IEEE-rounded intrinsic (__fdiv_rn, __fadd_rn, __fmul_rn, __fsub_rn,
// and __fmaf_rn only where its product is exact, add_dither), which nvcc
// never contracts or splits; the row sum keeps its order.  Build without
// --use_fast_math and without -ftz=true: the one-pass form's exact
// reciprocal below needs subnormals kept.
//
// quant_pack has two forms; ops/quant.py quant_pack_form picks one from
// the shape, dtype, format and pointer alignment:
//
// * The one pass (quant_pack_one_pass_kernel), for power-of-two blocks
//   from 64 to 1024, 16-byte aligned rows and residual, r * C < 2^32.
//   What bounds it on an H100 is operations, not bytes: the function
//   needs 85 an element (threefry2x32's 20 adds, 20 rotates and 20 xors
//   and 12 key-schedule adds, the dither's xor-and, its conversion and
//   scale, the quotient, the sum, the floor and the clip, the residual,
//   the amax), 41 of them only the integer ALU issues (64 lanes an SM a
//   clock) and all of them share 128 issue lanes: 0.664 SM-clocks an
//   element, against 4-13 bytes an element (bytes bind only f32 with a
//   residual, 12 bytes at 3.35 TB/s).  The integer ALU is the pipe that
//   fills first, so the design spends it, and the issue slots, on the
//   function and little else:
//   - one pass from registers: each lane loads 8 consecutive elements
//     with 16-byte loads (one for bf16/f16, two for f32), reduces |x|
//     across the lanes of its scaling block with __shfl_xor_sync, and
//     quantizes the same registers; no element is read twice.  A warp
//     tile is 256 elements (several blocks below 256, reduced by
//     segment) or one block of 512 or 1024 (16 or 32 elements a lane);
//     resident blocks walk the tiles, loading the next before they
//     quantize this one, so the load's latency hides under the threefry;
//   - an exact reciprocal instead of IEEE division: for a scale 2^e, e in
//     [-126, 127], x / 2^e and x * 2^-e are the same real number and
//     IEEE rounds each once, so they give the same bits (subnormal
//     results included), and 2^-e is exact in f32 over that range (2^-127
//     is a subnormal).  inv is built from the exponent bits once a block;
//     each element takes one __fmul_rn.  This holds only while the build
//     keeps subnormals (no -ftz=true, no --use_fast_math);
//   - 32-bit counters: r * C < 2^32, so the threefry counter's high word
//     is 0 and its low word is the element's flat index, a 32-bit add;
//     the row comes from the grid (blockIdx.y), so there is no division;
//   - eight independent threefry chains a lane, unrolled in registers,
//     so the scheduler interleaves eight 20-round dependency chains, and
//     their adds go to the FMA pipe (threefry2x32 below);
//   - clip(floor(x)) as one round-down conversion (saturating, NaN -> 0)
//     plus integer min/max, the dither byte's conversion on the
//     conversion unit and its 1/256 folded into the sum's FFMA: none of
//     them adds integer-ALU work;
//   - vector stores: 8 bytes of int8 codes or 4 of int4 codes a lane (4
//     or 2 where the frame only keeps rows after the first 4- or 2-byte
//     aligned), 16 bytes of residual a lane in bf16/f16 (32 in f32), one
//     2-byte scale a block.
// * The first form (quant_pack_kernel): one warp per scaling block,
//   grid-stride, two reads of every element, IEEE division, 64-bit
//   indices, byte stores.  It takes any even block and any alignment.

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

// The rotations of jax/_src/prng.py _threefry2x32_lowering, round group
// i (0-4), step j (0-3).
__host__ __device__ constexpr int rotation(int i, int j) {
  return i % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                    : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// threefry2x32, 20 rounds, on N independent counters (x0[n], x1[n]) at
// once: each step is written for all N before the next, so the N
// dependency chains interleave.  Each round's add is written x0 * one +
// x1 with one = blockDim.z, which is 1 on every launch here but unknown
// to the compiler: ptxas then issues it as IMAD on the FMA pipe instead
// of IADD3 on the integer ALU, which already carries the rotate and the
// xor.  (Moving the rotates to the FMA pipe instead, as IMAD.WIDE, was
// slower on an H100: that pipe then carries too much.)
template <int N>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t (&x0)[N],
                                             uint32_t (&x1)[N]) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const uint32_t one = blockDim.z;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x0[n] += ks[0];
    x1[n] += ks[1];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        x0[n] = x0[n] * one + x1[n];
        x1[n] = __funnelshift_l(x1[n], x1[n], rotation(i, j)) ^ x0[n];
      }
    }
    const uint32_t a = ks[(i + 1) % 3];
    const uint32_t b = ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      x0[n] += a;
      x1[n] += b;
    }
  }
}

// The dither of jax.random.bits(key, shape, uint8)[idx] from the threefry
// output pair: the byte k = uint8(b0 ^ b1) as a float (its conversion
// goes to the conversion unit, not to the integer ALU); u = k / 256.
__device__ __forceinline__ float dither_byte(uint32_t b0, uint32_t b1) {
  return static_cast<float>((b0 ^ b1) & 0xFFu);
}

// x + k / 256, rounded as __fadd_rn(x, u) rounds it: k * 2^-8 is exact,
// so the FFMA rounds the same exact sum once.  k = 128 gives nearest
// rounding's x + 1/2.
__device__ __forceinline__ float add_dither(float x, float k) {
  return __fmaf_rn(k, 0.00390625f, x);
}

// max(a, b), NaN if either is NaN, as jnp.max and torch.amax reduce
// (fmaxf drops a NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// compression.py _pow2_scale (:481), integer arithmetic on the f32 bits
// of amax: the exponent field pe in [1, 254] of the scale 2^(pe - 127),
// or 0 for the scale 0 (amax > 0 false: all zero, or a NaN in the block).
template <int BITS>
__device__ __forceinline__ uint32_t scale_field(float amax) {
  const uint32_t a = __float_as_uint(amax);
  const int e = static_cast<int>(a >> 23) - 127;
  const int m = static_cast<int>(a & 0x7FFFFFu);
  const int base = BITS == 8 ? 6 : 2;
  const int thresh = BITS == 8 ? 8257536 : 6291456;  // .984375, .75 of 2^23
  int pe = e - base + (m > thresh ? 1 : 0) + 127;
  pe = pe < 1 ? 1 : (pe > 254 ? 254 : pe);
  return amax > 0.f ? static_cast<uint32_t>(pe) : 0u;
}

// 2^-e for the scale 2^e = 2^(pe - 127): the exponent field 254 - pe, or
// the subnormal 2^-127 (0x00400000) for pe = 254.  1 for the scale 0,
// which the plain version divides by 1.
__device__ __forceinline__ float inv_scale(uint32_t pe) {
  if (pe == 0u) return 1.f;
  return __uint_as_float(pe == 254u ? 0x00400000u : (254u - pe) << 23);
}

// clip(floor(x), -lv, lv), then the int8 cast, in one round-down
// conversion and integer min/max.  The conversion saturates to its
// type's range and gives 0 for NaN, as XLA's and torch's float -> int8
// casts of a NaN do.  int8 converts straight to s8 ([-128, 127]), so only
// the -127 side is left to clip; int4 converts to s32 and clips both.
template <int BITS>
__device__ __forceinline__ int clip_floor(float x) {
  if constexpr (BITS == 8) {
    short q;
    asm("cvt.rmi.s8.f32 %0, %1;" : "=h"(q) : "f"(x));
    return max(static_cast<int>(q), -127);
  } else {
    return min(max(__float2int_rd(x), -7), 7);
  }
}

// dequant(q).astype(dtype) back in f32.  q * scale is exact in f32 and,
// |q| <= 127 and the scale a power of two >= 2^-126, exact in bf16 too
// (or inf in both), so only f16 rounds here.
template <typename T>
__device__ __forceinline__ float dequant(int q, float scale) {
  const float d = __fmul_rn(static_cast<float>(q), scale);
  return to_f(from_f<T>(d));
}
template <>
__device__ __forceinline__ float dequant<__nv_bfloat16>(int q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

// ---------------------------------------------------------------------------
// The first form: one warp per scaling block
// ---------------------------------------------------------------------------

template <int BITS>
__device__ __forceinline__ int quantize_one(float v, float div,
                                            int stochastic, uint32_t k0,
                                            uint32_t k1, uint64_t idx) {
  float k = 128.f;
  if (stochastic) {
    uint32_t x0[1] = {static_cast<uint32_t>(idx >> 32)};
    uint32_t x1[1] = {static_cast<uint32_t>(idx)};
    threefry2x32<1>(k0, k1, x0, x1);
    k = dither_byte(x0[0], x1[0]);
  }
  return clip_floor<BITS>(add_dither(__fdiv_rn(v, div), k));
}

template <typename T>
__device__ __forceinline__ T residual(float v, int q, float scale) {
  // vin - dequant(q).astype(dtype), in the input dtype.
  return from_f<T>(__fsub_rn(v, dequant<T>(q, scale)));
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
      amax = max_nan(amax, fabsf(to_f(src[i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const uint32_t pe = scale_field<BITS>(amax);
    const float scale = __uint_as_float(pe << 23);
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

// ---------------------------------------------------------------------------
// The one-pass form
// ---------------------------------------------------------------------------

// Eight consecutive elements: loaded as kWords 16-byte words (the
// pointers are 16-byte aligned), decoded to f32 registers, and stored
// from f32 in T.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  static constexpr int kWords = 2;
  static __device__ __forceinline__ void decode(const uint4 (&w)[2],
                                                float (&v)[8]) {
    v[0] = __uint_as_float(w[0].x); v[1] = __uint_as_float(w[0].y);
    v[2] = __uint_as_float(w[0].z); v[3] = __uint_as_float(w[0].w);
    v[4] = __uint_as_float(w[1].x); v[5] = __uint_as_float(w[1].y);
    v[6] = __uint_as_float(w[1].z); v[7] = __uint_as_float(w[1].w);
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  static constexpr int kWords = 1;
  // bf16 -> f32 is the bf16 bits in the f32's high half.
  static __device__ __forceinline__ void decode(const uint4 (&u)[1],
                                                float (&v)[8]) {
    const uint32_t w[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec8<__half> {
  static constexpr int kWords = 1;
  static __device__ __forceinline__ void decode(const uint4 (&u)[1],
                                                float (&v)[8]) {
    const uint32_t w[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__half* p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Eight codes into the frame at byte p: int8 as 8 bytes, int4 as 4 (the
// even element in the low nibble, +8 offset), in stores of STORE bytes.
template <int BITS, int STORE>
__device__ __forceinline__ void store_codes(uint8_t* p, const int (&q)[8]) {
  if constexpr (BITS == 8) {
    const uint32_t lo = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                                    __byte_perm(q[2], q[3], 0x0040), 0x5410);
    const uint32_t hi = __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                                    __byte_perm(q[6], q[7], 0x0040), 0x5410);
    if constexpr (STORE == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
    } else if constexpr (STORE == 4) {
      reinterpret_cast<uint32_t*>(p)[0] = lo;
      reinterpret_cast<uint32_t*>(p)[1] = hi;
    } else {
      uint16_t* h = reinterpret_cast<uint16_t*>(p);
      h[0] = static_cast<uint16_t>(lo);
      h[1] = static_cast<uint16_t>(lo >> 16);
      h[2] = static_cast<uint16_t>(hi);
      h[3] = static_cast<uint16_t>(hi >> 16);
    }
  } else {
    // sum of (q_k + 8) << 4k: each term fits its nibble, so this is
    // 0x88888888 plus the codes' two's-complement shifts, mod 2^32.
    uint32_t w = 0x88888888u;
#pragma unroll
    for (int k = 0; k < 8; ++k) w += static_cast<uint32_t>(q[k]) << (4 * k);
    if constexpr (STORE == 4) {
      *reinterpret_cast<uint32_t*>(p) = w;
    } else {
      uint16_t* h = reinterpret_cast<uint16_t*>(p);
      h[0] = static_cast<uint16_t>(w);
      h[1] = static_cast<uint16_t>(w >> 16);
    }
  }
}

// One warp's tile: 256 * NCH consecutive elements of a row from column
// wcol, NCH chunks of 8 a lane (chunk j of lane l at (32 j + l) * 8, so
// each 16-byte load is coalesced).  Below a block of 256 a row may end
// inside a tile, between two scaling blocks: such lanes load zeros and
// store nothing.
template <typename T, int NCH>
__device__ __forceinline__ void load_tile(
    const T* src, uint32_t wcol, bool valid,
    uint4 (&w)[NCH][Vec8<T>::kWords]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int i = 0; i < Vec8<T>::kWords; ++i) {
      if (valid)
        w[j][i] = __ldg(reinterpret_cast<const uint4*>(
                            src + wcol + (j * 32 + lane) * 8) + i);
      else
        w[j][i] = make_uint4(0u, 0u, 0u, 0u);
    }
}

// Each warp walks its row's tiles (blockIdx.y is the row), loading the
// next tile before it quantizes this one, so the load's latency hides
// under the threefry.  seg_lanes lanes (block / 8, at most 32) share a
// scaling block.
template <typename T, int BITS, int NCH, int STORE>
__global__ void __launch_bounds__(kThreads, NCH == 1 ? 4 : 2)
    quant_pack_one_pass_kernel(const T* __restrict__ rows,
                               uint8_t* __restrict__ wire,
                               T* __restrict__ resid, uint32_t C,
                               uint32_t frame, uint32_t tiles, int seg_lanes,
                               int block_log2, int stochastic, uint32_t k0,
                               uint32_t k1) {
  constexpr int W = Vec8<T>::kWords;
  constexpr uint32_t kTile = 256u * NCH;
  const int lane = threadIdx.x & 31;
  const uint32_t stride = gridDim.x * (kThreads / 32);
  uint32_t t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= tiles) return;  // the whole warp
  const uint32_t row = blockIdx.y;
  const T* src = rows + static_cast<size_t>(row) * C;
  uint8_t* out = wire + static_cast<size_t>(row) * frame;
  T* res = resid == nullptr ? nullptr : resid + static_cast<size_t>(row) * C;
  const uint32_t flat = row * C;  // < 2^32: the counter's high word is 0
  const uint32_t codes = BITS == 8 ? C : C / 2;

  // t * kTile < C: the tile's first column.
  bool valid = NCH > 1 || static_cast<uint32_t>(lane) * 8u < C - t * kTile;
  uint4 cur[NCH][W];
  load_tile<T, NCH>(src, t * kTile, valid, cur);
  for (;;) {
    const uint32_t wcol = t * kTile;
    const uint32_t next = t + stride;
    const bool more = next < tiles;
    const bool next_valid =
        more && (NCH > 1 ||
                 static_cast<uint32_t>(lane) * 8u < C - next * kTile);
    uint4 nxt[NCH][W];
    load_tile<T, NCH>(src, next * kTile, next_valid, nxt);

    float v[NCH][8];
#pragma unroll
    for (int j = 0; j < NCH; ++j) Vec8<T>::decode(cur[j], v[j]);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = max_nan(amax, fabsf(v[j][k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < seg_lanes)
        amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const uint32_t pe = scale_field<BITS>(amax);
    const float scale = __uint_as_float(pe << 23);
    const float inv = inv_scale(pe);

#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const uint32_t col = wcol + (j * 32 + lane) * 8;
      float kf[8];  // the dither bytes (128: nearest rounding's 1/2)
      if (stochastic) {
        uint32_t x0[8], x1[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          x0[k] = 0u;
          x1[k] = flat + col + k;
        }
        threefry2x32<8>(k0, k1, x0, x1);
#pragma unroll
        for (int k = 0; k < 8; ++k) kf[k] = dither_byte(x0[k], x1[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) kf[k] = 128.f;
      }
      int q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        q[k] = clip_floor<BITS>(add_dither(__fmul_rn(v[j][k], inv), kf[k]));
      if (valid) {
        store_codes<BITS, STORE>(out + (BITS == 8 ? col : col / 2), q);
        if (res != nullptr) {
          float rv[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            rv[k] = __fsub_rn(v[j][k], dequant<T>(q[k], scale));
          Vec8<T>::store(res + col, rv);
        }
      }
    }
    if (valid && (lane & (seg_lanes - 1)) == 0) {
      // The bf16 of a power of two is its f32's high half, exactly.
      const uint32_t blk =
          (wcol + static_cast<uint32_t>(lane) * 8u) >> block_log2;
      *reinterpret_cast<uint16_t*>(out + codes + 2 * blk) =
          static_cast<uint16_t>(pe << 7);
    }
    if (!more) break;
    t = next;
    valid = next_valid;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int i = 0; i < W; ++i) cur[j][i] = nxt[j][i];
  }
}

// ---------------------------------------------------------------------------
// unpack_dequantize
// ---------------------------------------------------------------------------

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

struct OnePassArgs {
  const void* rows;
  void* wire;
  void* resid;
  uint32_t r, C, frame;
  int block, stochastic;
  uint32_t k0, k1;
  cudaStream_t stream;
};

template <typename T, int BITS, int NCH, int STORE>
cudaError_t launch_one_pass(const OnePassArgs& a) {
  auto kernel = quant_pack_one_pass_kernel<T, BITS, NCH, STORE>;
  // As many blocks as stay resident on the card, shared by the rows (the
  // warps then walk their row's tiles), or fewer for a small launch.
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    resident = sms * per_sm;
  }
  const uint32_t tiles = (a.C + 256u * NCH - 1) / (256u * NCH);
  const uint32_t wanted = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  uint32_t per_row = static_cast<uint32_t>(resident) / a.r;
  per_row = per_row < 1 ? 1 : (per_row > wanted ? wanted : per_row);
  int log2 = 0;
  while ((1 << log2) < a.block) ++log2;
  kernel<<<dim3(per_row, a.r), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.rows), static_cast<uint8_t*>(a.wire),
      static_cast<T*>(a.resid), a.C, a.frame, tiles,
      a.block / 8 < 32 ? a.block / 8 : 32, log2, a.stochastic, a.k0, a.k1);
  return cudaGetLastError();
}

template <typename T, int NCH>
cudaError_t one_pass_store(const OnePassArgs& a, int bits, int store) {
  if (bits == 8 && store == 8) return launch_one_pass<T, 8, NCH, 8>(a);
  if (bits == 8 && store == 4) return launch_one_pass<T, 8, NCH, 4>(a);
  if (bits == 8 && store == 2) return launch_one_pass<T, 8, NCH, 2>(a);
  if (bits == 4 && store == 4) return launch_one_pass<T, 4, NCH, 4>(a);
  if (bits == 4 && store == 2) return launch_one_pass<T, 4, NCH, 2>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t one_pass_dtype(const OnePassArgs& a, int bits, int store) {
  switch (a.block) {
    case 64:
    case 128:
    case 256:
      return one_pass_store<T, 1>(a, bits, store);
    case 512:
      return one_pass_store<T, 2>(a, bits, store);
    case 1024:
      return one_pass_store<T, 4>(a, bits, store);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hvdquant

// The first form.  dtype: 0 f32, 1 bf16, 2 f16.  bits: 8 or 4.  resid
// may be null.  Returns the launch's cudaError_t (cudaErrorInvalidValue
// for arguments the kernel does not take).
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

// The one-pass form: the same arguments, and the code store's width in
// bytes (8, 4 or 2 for int8; 4 or 2 for int4), which every row's start
// in the wire must be aligned to.  Refuses (cudaErrorInvalidValue) what
// ops/quant.py quant_pack_form sends to the first form.
extern "C" int hvd_quant_pack_one_pass(const void* rows, void* wire,
                                       void* resid, long long r, long long C,
                                       int dtype, int bits, int block,
                                       int stochastic, unsigned int k0,
                                       unsigned int k1, int store,
                                       void* stream) {
  const long long frame = C * bits / 8 + 2 * (C / (block > 0 ? block : 1));
  const bool pow2 = block >= 64 && block <= 1024 && !(block & (block - 1));
  if ((bits != 8 && bits != 4) || !pow2 || C % block || r > 65535 ||
      r * C >= (1LL << 32) ||
      reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(resid) % 16 ||
      reinterpret_cast<uintptr_t>(wire) % 8 || (bits == 4 && frame % 2) ||
      (r > 1 && frame % store))
    return cudaErrorInvalidValue;
  if (r == 0 || C == 0) return cudaSuccess;
  const hvdquant::OnePassArgs a{
      rows, wire, resid, static_cast<uint32_t>(r), static_cast<uint32_t>(C),
      static_cast<uint32_t>(frame), block, stochastic, k0, k1,
      static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return hvdquant::one_pass_dtype<float>(a, bits, store);
    case 1:
      return hvdquant::one_pass_dtype<__nv_bfloat16>(a, bits, store);
    case 2:
      return hvdquant::one_pass_dtype<__half>(a, bits, store);
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
