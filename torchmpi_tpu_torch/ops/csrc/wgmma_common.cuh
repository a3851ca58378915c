// The Hopper PTX wrappers the port's warp-specialised kernels share: the
// fused loss's product (xent_wgmma.cuh) and the bf16 flash backward
// (flash_bwd_dq_wgmma.cu, flash_bwd_dkv_wgmma.cu).  mbarriers, TMA loads,
// the 128-byte-swizzle wgmma descriptor, the wgmma fences, the
// wgmma.mma_async forms the kernels issue, and, on the host, the driver's
// tensor-map encoder reached through the runtime (no -lcuda).
//
// wgmma forms (bf16 in, f32 accumulate unless named tf32; d is the
// m64nNk16 accumulator fragment: d[4 j + 2 h + c] holds row 16 w + lane / 4
// + 8 h, column 8 j + 2 (lane % 4) + c of the thread's warp w in the
// warpgroup):
//   wgmma_256<TA, TB>       m64n256k16, A and B from shared memory;
//   wgmma_tf32_128          m64n128k8 TF32, both K-major;
//   Wgmma<N>::ss<TA, TB, SD> m64nNk16, N 32, 64 or 128, A and B from
//                           shared memory; SD 1: d += A B, SD 0: d = A B
//                           (no instruction has to zero d first);
//   Wgmma<N>::rs<TB>        m64nNk16, N 64 or 128, A from registers: the
//                           m16n8k16 A fragment of the thread's warp's 16
//                           rows, {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
//                           (g + 8, 2t + 8..)} as bf16 pairs, g = lane / 4,
//                           t = lane % 4; d += A B.
// TA / TB set: that operand is MN-major (its trans flag).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmw {

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// The 64 x 64 box of map `m` at element coordinates (c0 inner, c1 outer)
// into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* m,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a rank-4 map at (c0 inner, .., c3 outer); a box's part outside
// the tensor reads as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* m,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// A wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Operands as the 128-byte swizzle lays them out: rows of 128 bytes (64
// bf16) in 8-row groups 1024 bytes apart, a wider operand in chunks of 64
// columns `chunk` bytes apart.  kmajor_desc: k-step kk (16 deep) of an
// operand whose depth runs along the rows (32 bytes a step, the next 64
// of depth in the next chunk); mnmajor_desc: k-step kk of one whose depth
// runs down the rows (16 rows, 2048 bytes, a step; the next 64 of M or N
// in the next chunk).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int chunk,
                                                int kk) {
  return sw128_desc(base + (kk / 4) * chunk + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int chunk,
                                                 int kk) {
  return sw128_desc(base + kk * 2048, chunk, 1024);
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

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TMW_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TMW_D16(i) TMW_D4(i), TMW_D4(i + 4), TMW_D4(i + 8), TMW_D4(i + 12)

// d[64 x 256] += A[64 x 16] . B[16 x 256].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %130, %131;\n"
      "}\n"
      : TMW_D16(0), TMW_D16(16), TMW_D16(32), TMW_D16(48), TMW_D16(64),
        TMW_D16(80), TMW_D16(96), TMW_D16(112)
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "n"(1));
}

// d[64 x 128] += A[64 x 8] . B[8 x 128], tf32 in (read from float32 bits,
// the low 13 ignored); both operands K-major.
__device__ __forceinline__ void wgmma_tf32_128(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : TMW_D16(0), TMW_D16(16), TMW_D16(32), TMW_D16(48)
      : "l"(da), "l"(db), "n"(1));
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int TA, int TB, int SD = 1>
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : TMW_D16(0)
        : "l"(da), "l"(db), "n"(SD), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB, int SD = 1>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : TMW_D16(0), TMW_D16(16)
        : "l"(da), "l"(db), "n"(SD), "n"(TA), "n"(TB));
  }
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : TMW_D16(0), TMW_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1),
          "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TA, int TB, int SD = 1>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : TMW_D16(0), TMW_D16(16), TMW_D16(32), TMW_D16(48)
        : "l"(da), "l"(db), "n"(SD), "n"(TA), "n"(TB));
  }
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : TMW_D16(0), TMW_D16(16), TMW_D16(32), TMW_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1),
          "n"(TB));
  }
};

#undef TMW_D16
#undef TMW_D4

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a bf16 [d3][d2][d1][d0] array at p (d0 innermost and
// contiguous; byte pitches s1, s2, s3 of dims 1-3) in boxes of 64 x 1 x
// `rows` x 1 elements with the 128-byte swizzle: one box is `rows` rows of
// 64 bf16 (128 bytes) of one (d1, d3), rows along d2.  Out-of-bounds reads
// are zeros.
inline cudaError_t make_map_bf16_4d(CUtensorMap* m, const void* p, long d0,
                                    long d1, long d2, long d3, long s1, long s2,
                                    long s3, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1, (cuuint64_t)s2, (cuuint64_t)s3};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tmw
