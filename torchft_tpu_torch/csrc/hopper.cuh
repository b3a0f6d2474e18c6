// Hopper (sm_90a) building blocks for the flash-attention kernels, in
// inline PTX: TMA tensor maps and loads, mbarriers, wgmma descriptors and
// instructions, warpgroup register reallocation.
//
// Shared-memory tiles are written by TMA with the 128-byte (or, for rows of
// 64 bytes, the 64-byte) swizzle, in "atoms": a tile of R rows and D bf16
// columns is D / AW sub-tiles of R rows x AW columns (AW = 64, or 32 when
// D = 32), each sub-tile AW * 2 bytes a row and aligned to 1024 bytes. A
// wgmma descriptor reads such a sub-tile in one of two canonical layouts
// (CUTLASS, cute/atom/mma_traits_sm90_gmma.hpp), in units of 16 bytes,
// T = 8 bf16:
//   K-major  ((8, m), (T, 2)) : ((SW/16 * T, SBO), (1, T)): rows of the
//            non-contracted dimension SW bytes apart, 8-row groups SBO
//            apart; a k16 step is +32 bytes inside the atom;
//   MN-major ((T, SW/16, m), (8, k)) : ((1, T, LBO), (SW/16 * T, SBO)):
//            SW bytes of the non-contracted dimension contiguous, further
//            atoms LBO apart; contracted rows SW bytes apart, 8-row groups
//            SBO apart; a k16 step is +16 rows.
// with SW the swizzle width (128 or 64) and SBO = 8 * SW.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is not in the runtime API: its entry point comes
// through the runtime, so the library links no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A 3-D bf16 map over rows of [n, len, d] (d contiguous), box
// [1, box_rows, aw]: TMA zero-fills the rows at or past len of each n, so a
// ragged tile never reads the next head's rows.
inline bool map_rows(CUtensorMap* m, const void* base, int n, int len, int d,
                     int box_rows, int aw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)len, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)len};
  const cuuint32_t box[3] = {(cuuint32_t)aw, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            aw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: box at (c0, c1, c2) of a 3-D map into shared memory, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Generic-proxy writes to shared memory visible to wgmma / TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A global int read with acquire semantics at GPU scope: what another
// block wrote before its matching red_release() is visible after it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Adds `v` to the global int at `p` with release semantics at GPU scope.
__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Arrival at barrier `id` (1..15) of `count` threads, without waiting:
// pairs with named_barrier() on the threads that wait.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma descriptor of a swizzled tile at `p` (see the top of this file):
// lbo and sbo in bytes, swizzle width 128 or 64 bytes.
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo,
                                         int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The same value, opaque to the compiler: offsets derived from it inside
// a loop stay inside it, as immediates, instead of being hoisted out and
// held in one register each across the loop.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define TFT_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TFT_ACC16(d) \
  TFT_ACC4(d, 0), TFT_ACC4(d, 4), TFT_ACC4(d, 8), TFT_ACC4(d, 12)
#define TFT_ACC32(d)                                                   \
  TFT_ACC16(d), TFT_ACC4(d, 16), TFT_ACC4(d, 20), TFT_ACC4(d, 24),     \
      TFT_ACC4(d, 28)
#define TFT_ACC64(d)                                                   \
  TFT_ACC32(d), TFT_ACC4(d, 32), TFT_ACC4(d, 36), TFT_ACC4(d, 40),     \
      TFT_ACC4(d, 44), TFT_ACC4(d, 48), TFT_ACC4(d, 52), TFT_ACC4(d, 56), \
      TFT_ACC4(d, 60)

// wgmma m64nNk16, bf16 inputs, f32 accumulators: each of the warpgroup's
// 128 threads holds N / 2 floats of the 64 x N tile, thread t (warp w =
// t / 32, lane l) the rows 16 w + l / 4 (+ 8) and, for each 8-column chunk
// j, the columns 8 j + 2 (l % 4) (+ 1): d[4 j + {0, 1}] in the first row,
// d[4 j + {2, 3}] in the second. TA / TB = 1 reads that operand MN-major.
// `acc` = 0 overwrites d instead of adding to it.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  // d[16] (+)= A . B, A and B in shared memory (descriptors).
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15},"
        " %16, %17, p, 1, 1, %19, %20;\n}\n"
        : TFT_ACC16(d)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d[16] (+)= A . B, A in registers (four bf16x2 a thread).
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : TFT_ACC16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

template <> struct Wgmma<64> {
  // d[32] (+)= A . B, A and B in shared memory (descriptors).
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n}\n"
        : TFT_ACC32(d)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d[32] (+)= A . B, A in registers (four bf16x2 a thread).
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : TFT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

template <> struct Wgmma<128> {
  // d[64] (+)= A . B, A and B in shared memory (descriptors).
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63},"
        " %64, %65, p, 1, 1, %67, %68;\n}\n"
        : TFT_ACC64(d)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d[64] (+)= A . B, A in registers (four bf16x2 a thread).
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : TFT_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

}  // namespace hopper
