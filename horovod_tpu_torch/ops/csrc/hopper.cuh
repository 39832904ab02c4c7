// Hopper (sm_90a) building blocks of the redesigned bf16 flash kernels
// (flash_fwd_sm90.cuh, flash_bwd_dkdv_sm90.cuh, flash_bwd_dq_sm90.cuh)
// and serving kernels (serving_gemm_sm90.cuh, cache_attention_sm90.cuh):
// mbarriers, TMA tile loads, wgmma with f32 accumulators in registers,
// cluster barriers, and the host-side tensor maps.  Inline PTX only, so a
// build takes seconds.
//
// Shared-memory tiles.  A [rows, D] bf16 tile is stored as panels<D> =
// ceil(D/64) panels of [rows, 64]: each panel row is 128 bytes, written by
// TMA with the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B), which is the
// layout the wgmma descriptors below describe (layout type 1).  Every
// panel starts on a 1024-byte boundary (one swizzle atom = 8 rows x 128
// bytes), so the descriptors' base offset is 0.  At D 80 and 96 the
// second panel is partial: the tensor map's width is D, so TMA zero-fills
// its columns D..127 (and still counts them towards the barrier's bytes).
// Products that sum over D stop at D/16 k steps; products whose N is D
// run over the whole padded panel and the epilogues store columns below D
// only, so the zeros cost tensor-core work (1.33x at D 96, 1.6x at 80 in
// those products) but never reach a result.
//
// wgmma fragments (m64nNk16, f32 accumulator, per warpgroup of 128
// threads): thread t = 32 w + l holds, for each 8-column chunk j of N,
//   d[4j + 0], d[4j + 1]  at row 16 w + l / 4,     columns 8 j + 2 (l % 4) + {0, 1}
//   d[4j + 2], d[4j + 3]  at row 16 w + l / 4 + 8, the same columns.
// The bf16 A fragment of a register-A wgmma (k16) has the same
// row/column map over 16 columns, two values per 32-bit register, so an
// f32 accumulator over N columns becomes N/16 A fragments by packing
// pairs (acc_to_a below) without moving data between threads.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no -lcuda: see encode_fn()
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace hvdflash {
namespace sm90 {

// Warp-specialised blocks: two consumer warpgroups and one producer.
constexpr int kConsumers = 2;
constexpr int kBlockThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Shared memory addresses and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to every thread and to the
// async (TMA) proxy; the caller then synchronises the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a [box_rows, 64] box of a 3-D [bh, seq, d] tensor
// into shared memory; rows past seq are zero-filled and still count
// towards the barrier's transaction bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row,
                                            int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// 64-column panels of a [rows, D] tile, and D padded to whole panels.
template <int D>
constexpr int panels = (D + 63) / 64;
template <int D>
constexpr int padded = 64 * panels<D>;

// All panels<D> panels of rows [row, row + box_rows) of slice bh.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, int panel_bytes,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int bh) {
#pragma unroll
  for (int p = 0; p < panels<D>; ++p)
    tma_load_3d(dst + p * panel_bytes, map, bar, 64 * p, row, bh);
}

// The same for a 2-D map (serving_gemm's x and w: make_map_2d) and a 4-D
// map (cache_attention's [b, rows, heads, head_dim] views: make_map_4d);
// coordinates innermost first.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Register budget of warp-specialised blocks: one producer warpgroup and
// two consumer warpgroups (384 threads, launched with at most 168
// registers a thread) hand the producer's registers to the consumers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`.
// K-major (the K dimension contiguous): rows of 128 bytes, 8-row groups
// `sbo` bytes apart; a k16 step inside a panel moves the start by 32
// bytes.  MN-major (the transpose flag): 64 MN values contiguous in one
// 128-byte row, K rows 128 bytes apart, 8-row groups `sbo` bytes apart; a
// k16 step moves the start by 16 rows = 2048 bytes.  Both use sbo = 1024
// here (consecutive rows); the flash kernels' MN-major operands are one
// 64-wide panel, so the leading offset is not used (desc_sw128_lbo sets
// it for wider ones).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t kSbo = 1024 >> 4;
  constexpr uint64_t kLbo = 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kLbo << 16) |
         (kSbo << 32) | (1ull << 62);
}

// The same for an MN-major operand wider than one 64-value panel: the
// leading offset is the byte stride between its panels (the canonical
// MN-major 128-byte-swizzle layout: 64 MN values a 128-byte row, 8-row
// K groups sbo apart, 64-value MN panels lbo apart).
__device__ __forceinline__ uint64_t desc_sw128_lbo(uint32_t addr,
                                                   uint32_t lbo) {
  constexpr uint64_t kSbo = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) | (kSbo << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that `x` may change here: keeps reads of
// accumulators after wgmma_wait() and writes before the next wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

#define HVD_ACC8(d, b)                                                    \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define HVD_ACC32(d, b) \
  HVD_ACC8(d, b), HVD_ACC8(d, b + 8), HVD_ACC8(d, b + 16), HVD_ACC8(d, b + 24)
#define HVD_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HVD_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HVD_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HVD_ACC32(d, 0), HVD_ACC32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HVD_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A K-major and B MN-major (the
// transpose flag) in shared memory: serving_gemm's x and w tiles.
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : HVD_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A K-major and B MN-major in
// shared memory, B's two 64-column panels `lbo` bytes apart (see
// desc_sw128_lbo): serving_gemm's wide tiles.
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HVD_REGS64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : HVD_ACC32(d, 0), HVD_ACC32(d, 32)
      : "l"(a), "l"(b), "r"(1));
}

// d[:, 64 P : 64 P + 64] += A[64 x 16] B[16 x 64]: A a bf16 fragment in
// registers (a[0..3]), B MN-major in shared memory (transpose flag 1),
// into panel P (accumulator floats 32 P .. 32 P + 31) of a [64 x 64 NP]
// accumulator.
#define HVD_WGMMA_RS_N64(OFF)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_REGS32      \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
      : HVD_ACC32(d, OFF)                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <int P, int N>
__device__ __forceinline__ void wgmma_rs_panel(float (&d)[N], const uint32_t* a,
                                               uint64_t b) {
  static_assert(P == 0 || P == 1, "panels 0 and 1 (head_dim <= 128)");
  static_assert(32 * P + 32 <= N, "panel outside the accumulator");
  if constexpr (P == 0) {
    HVD_WGMMA_RS_N64(0);
  } else {
    HVD_WGMMA_RS_N64(32);
  }
}

// Two f32 values as one register of two bf16 (the lower column in the
// low half), rounding to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of an m64nN product (NA = N / 2 floats a thread)
// as N/16 bf16 A fragments of 4 registers each.
template <int NA>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NA],
                                         uint32_t (&a)[NA / 2]) {
#pragma unroll
  for (int kk = 0; kk < NA / 8; ++kk) {
    a[4 * kk + 0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// Max and sum over the four threads of a quad, which hold one row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Thread-block clusters: every thread of the cluster meeting
// (release/acquire, so shared-memory writes before it are seen after it,
// in every block of the cluster).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// that the library does not link -lcuda.
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// Map of a contiguous bf16 [bh, seq, d] tensor with [box_rows, 64] boxes,
// 128-byte swizzle and zero fill past seq and past d (the padded columns
// of a partial panel).  The third dimension keeps a ragged tile from
// reading the next slice's rows.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int bh,
                            int seq, int d, int box_rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {64u, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem_strides[3] = {1u, 1u, 1u};
  CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over a row-major bf16 [rows, cols] matrix whose rows are `ld`
// elements apart (a multiple of 8, at least cols): [64, 64] boxes,
// 128-byte swizzle and zero fill past either edge.  serving_gemm's x and
// w.
inline cudaError_t make_map_2d(CUtensorMap* map, const void* base, int rows,
                               int cols, long long ld) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (ld < cols || ld % 8) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64u, 64u};
  const cuuint32_t elem_strides[2] = {1u, 1u};
  CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-D bf16 map over a [b, rows, heads, hd] view with element strides
// (sb, sr, sh) and unit stride over hd: [64 rows, 64 hd] boxes of one
// (batch, head), 128-byte swizzle, zero fill past rows and past hd.
// cache_attention's q, K and V views.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* base, int B,
                               int rows, int H, int hd, long long sb,
                               long long sr, long long sh) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sr * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64u, 1u, 64u, 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once a device (`done` holds a bit a device, one `done` a
// kernel): a host-bound decode does not pay the driver call each launch.
inline cudaError_t set_smem_once(const void* kernel, int bytes,
                                 std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace sm90
}  // namespace hvdflash
