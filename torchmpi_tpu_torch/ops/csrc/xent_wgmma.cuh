// The Hopper product of the fused loss (xent_fwd.cu, xent_bwd_dx.cu,
// xent_bwd_dw.cu): a warp-specialised wgmma GEMM fed by TMA, with the
// epilogue run on the accumulators in registers, and the kernel that forms
// the logits' gradient g on it.
//
// One block computes one BM x BN = 128 x 256 tile of C = A . B over the
// whole depth K, in f32, and hands its accumulators to the epilogue `Epi`;
// every output element is summed by one block in one order, so two calls
// give the same bits (no atomics, no split of K across blocks).  384
// threads, three warpgroups:
//   warpgroup 0, the producer: after setmaxnreg.dec its first thread walks
//     the depth in BK = 64 steps and, per step, waits for a free stage of
//     the STAGES = 4 ring (the stage's `empty` mbarrier), arms its `full`
//     mbarrier with the stage's bytes and issues six TMA loads of 64 x 64
//     bf16 boxes (2 of A, 4 of B, 48 KB) into it;
//   warpgroups 1 and 2, the consumers (setmaxnreg.inc to 232 registers):
//     each owns 64 rows of the tile and 128 f32 accumulators a thread; per
//     step it waits for the stage's `full` barrier, issues four
//     wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate) on it, keeps
//     one step's wgmma group in flight, and releases the previous stage.
// Operands are read as they are stored, through one tensor map per tensor
// (its natural row-major [rows, cols] view, 64 x 64 boxes, 128-byte
// swizzle).  An operand is K-major when its depth runs along the stored
// rows (A = x or g, [M, K]; B = W read as [N = E, K = V]) and MN-major
// when the depth runs down the stored columns (A = x^T for dW; B = W as
// [K = E, N = V] for g, and g as [K = rows, N = V] for dW): wgmma takes
// bf16 operands of either kind from shared memory (its trans-a / trans-b
// flags).  TMA fills a box's part outside the tensor with zeros, which
// covers the ragged M, N and K edges; the epilogues mask their stores
// (and the forward's statistics the zero columns past V).
//
// The TMA path needs every row pitch a multiple of 16 bytes and 16-byte
// aligned bases: E and V multiples of 8 (tma_ok, mirrored by the
// wrapper's route choice in ops/xent.py).  Other shapes take the cp.async /
// wmma product of xent_common.cuh.
//
// Tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda), and passed as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "xent_common.cuh"

namespace tmw {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int NT = 384;                       // producer + 2 consumer warpgroups
constexpr int BOX = 64;                       // TMA box edge (128 bytes of bf16)
constexpr int BOX_BYTES = BOX * BOX * 2;      // 8 KB
constexpr int A_BOXES = BM / BOX, B_BOXES = BN / BOX;
constexpr int STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;  // 48 KB
constexpr int ACC = BN / 2;                   // f32 accumulators a consumer thread
// The ring, plus room to align it to the 1024 bytes of a swizzle atom.
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024;

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
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

// A wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of k-step `kk` (16 deep) of an operand tile whose box j
// (64 rows of M or N) starts at base + j * BOX_BYTES.  K-major: the box is
// [64 mn][64 k] with 128-byte rows; 8-row groups lie 1024 bytes apart and a
// k-step is 32 bytes along the row.  MN-major: the box is [64 k][64 mn];
// a k-step is 16 rows (2048 bytes), 8-deep groups lie 1024 bytes apart and
// the next 64 of M or N is the next box.
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int kk) {
  return MN ? sw128_desc(base + kk * 2048, BOX_BYTES, 1024)
            : sw128_desc(base + kk * 32, 16, 1024);
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
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TMW_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TMW_D16(i) TMW_D4(i), TMW_D4(i + 4), TMW_D4(i + 8), TMW_D4(i + 12)

// d[64 x 256] += A[64 x 16] . B[16 x 256], bf16 in, f32 accumulate; TA / TB
// set: the operand is MN-major.  d is the wgmma m64nNk16 accumulator
// fragment: d[4 j + 2 h + c] holds row 16 w + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + c of the thread's warp w in the warpgroup.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[ACC], uint64_t da,
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

#undef TMW_D16
#undef TMW_D4

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

// C[M, N] = A . B over depth K for the block's tile (blockIdx.x: rows of
// BM, blockIdx.y: columns of BN); then epi(d, r0, c0) with the consumer
// thread's accumulators, its first row r0 and first column c0 (the rows
// r0, r0 + 8 and columns c0 + 8 j, + 1 of the fragment above).  ta / tb:
// the tensor maps of A's and B's storage; A_MN / B_MN: MN-major.
template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, int K, const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer.  From here on the roles never meet at a block barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], STAGE_BYTES);
        unsigned char* st = smem + s * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < A_BOXES; ++j) {
          if (A_MN) tma_load(st + j * BOX_BYTES, &ta, &full[s], m0 + j * BOX, k0);
          else      tma_load(st + j * BOX_BYTES, &ta, &full[s], k0, m0 + j * BOX);
        }
#pragma unroll
        for (int j = 0; j < B_BOXES; ++j) {
          unsigned char* dst = st + (A_BOXES + j) * BOX_BYTES;
          if (B_MN) tma_load(dst, &tb, &full[s], n0 + j * BOX, k0);
          else      tma_load(dst, &tb, &full[s], k0, n0 + j * BOX);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this consumer's 64 rows of the tile
    float d[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = smem_addr(smem + s * STAGE_BYTES) + c * BOX_BYTES;
      const uint32_t b = smem_addr(smem + s * STAGE_BYTES) + A_BOXES * BOX_BYTES;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_256<A_MN, B_MN>(d, operand_desc<A_MN>(a, kk), operand_desc<B_MN>(b, kk));
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the previous step's products are done
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(d);
    const int t = threadIdx.x % 128, lane = t % 32;
    epi(d, m0 + c * 64 + (t / 32) * 16 + lane / 4, n0 + 2 * (lane % 4));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// May the TMA path read an operand with row pitch ld (elements) at p?
inline bool tma_ok(const void* p, long ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

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

// The map of a row-major bf16 [rows, cols] matrix at p (pitch cols) in
// 64 x 64 boxes with the 128-byte swizzle; out-of-bounds reads are zeros.
inline cudaError_t make_map(CUtensorMap* m, const void* p, long rows, long cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool A_MN, bool B_MN, class Epi>
inline cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                               int M, int N, int K, const Epi& epi,
                               cudaStream_t st) {
  const auto kernel = gemm_kernel<A_MN, B_MN, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, NT, SMEM_BYTES, st>>>(ta, tb, K, epi);
  return cudaGetLastError();
}

// g = bf16((exp(z - lse) - onehot) . dl) on the accumulators of z = x . W
// (see tmx::xent_grad_kernel for the function and its TPU lines).
struct GradEpi {
  const int* labels;
  const float* lse;
  const float* dl;
  bf16* g;
  int rows, V;
  __device__ __forceinline__ void operator()(const float (&d)[ACC], int r0,
                                             int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows) continue;
      float l = lse[row];
      l = isfinite(l) ? l : 0.f;
      const int lab = labels[row];
      const float s = dl[row];
      bf16* out = g + (long)row * V;
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int col = c0 + 8 * j;  // even, and V is a multiple of 8
        if (col >= V) continue;
        const float p0 = expf(d[4 * j + 2 * h] - l) - (lab == col ? 1.f : 0.f);
        const float p1 = expf(d[4 * j + 2 * h + 1] - l) - (lab == col + 1 ? 1.f : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(p0 * s, p1 * s);
      }
    }
  }
};

// g for `rows` token rows on the wgmma product: A = x [rows, E] (K-major),
// B = W [E, V] (MN-major).
inline cudaError_t launch_grad(const bf16* x, const bf16* w, const int* labels,
                               const float* lse, const float* dl, bf16* g,
                               int rows, int E, int V, cudaStream_t st) {
  CUtensorMap tx, tw;
  cudaError_t e = make_map(&tx, x, rows, E);
  if (e == cudaSuccess) e = make_map(&tw, w, E, V);
  if (e != cudaSuccess) return e;
  return launch_gemm<false, true>(tx, tw, rows, V, E,
                                  GradEpi{labels, lse, dl, g, rows, V}, st);
}

}  // namespace tmw
