// Shared pieces of the fused linear + cross-entropy kernels (xent_fwd.cu,
// xent_bwd_dx.cu, xent_bwd_dw.cu): one bf16 tensor-core tile product, the
// tile loader that masks ragged edges, and the kernel that recomputes the
// logits' gradient g.  The backward recomputes p = exp(z - lse) against the
// forward's lse, as the TPU kernels take z from one dot_general with f32
// accumulation (torchmpi_tpu/ops/xent.py:47, :93, :127).  Each kernel
// forms z here (mma_tile) on its wmma route and in xent_wgmma.cuh on its
// wgmma route, summing the same exact bf16 products in another f32 order.  That reaches p as ~1e-6 relative, far below g's
// bf16 rounding (2^-8): the kernels need not see bitwise the same logits.
//
// The product: nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators
// (mma.sync on the tensor cores).  A bf16 x bf16 product is exact in f32, so
// the tile computes the TPU kernel's function (preferred_element_type f32);
// only the order of the f32 sums differs.  Block tile BM x BN = 128 x 128,
// depth BK = 32, 8 warps of 32 x 64 each (2 x 4 fragments), operand tiles
// double-buffered in shared memory through cp.async.  The three kernels
// run on it for every shape whose operands TMA cannot read (E or V not a
// multiple of 8, or a base not 16-byte aligned); every other shape takes
// xent_wgmma.cuh's wgmma.mma_async product on TMA-loaded tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace tmx {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Finite stand-in for -inf: exp() of it is exactly 0, as in flash.
constexpr float NEG_INF = -1e30f;

constexpr int BM = 128, BN = 128, BK = 32;  // block tile and depth step
constexpr int NT = 256;                     // 8 warps: 4 (rows) x 2 (cols)
constexpr int WM = 32, WN = 64;             // one warp's share of the tile
constexpr int FM = WM / 16, FN = WN / 16;   // its 2 x 4 fragments
constexpr int CP = BN + 4;                  // f32 pitch of the staged tile

// A stored tile: ROWS rows of COLS contiguous elements, pitch COLS + 8 (a
// multiple of 8 elements, as wmma wants; the 16-byte skew spreads banks).
template <int ROWS_, int COLS_>
struct Tile {
  static constexpr int ROWS = ROWS_, COLS = COLS_, P = COLS_ + 8;
  static constexpr int ELEMS = ROWS * P;
};
// A is [M, K] row-major, or (COL) stored as its transpose [K, M]; B is
// [K, N] row-major, or (COL) stored as [N, K].
template <bool COL> using ATile = Tile<COL ? BK : BM, COL ? BM : BK>;
template <bool COL> using BTile = Tile<COL ? BN : BK, COL ? BK : BN>;

// Dynamic shared memory of every kernel here: the staged f32 output tile
// (which reuses the operand buffers once the product is done) and four
// per-row arrays.
constexpr size_t SMEM_BYTES = sizeof(float) * (BM * CP + 4 * BM);
static_assert(2 * (ATile<false>::ELEMS + BTile<true>::ELEMS) * sizeof(bf16) <=
                  sizeof(float) * BM * CP,
              "operand tiles must fit under the staged output tile");

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy the T::ROWS x T::COLS tile whose first element is (r0, c0) of a
// [rmax, cmax] matrix (leading dimension ld) into shared memory.  Elements
// past rmax or cmax read as zero: the ragged edge adds nothing to a product.
// Whole 16-byte chunks go by cp.async when `vec` (ld a multiple of 8 and the
// base 16-byte aligned); the edge chunks, and every chunk otherwise, by plain
// loads.
template <class T>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          long ld, int r0, int c0, int rmax,
                                          int cmax, bool vec) {
  constexpr int CPR = T::COLS / 8;
  for (int idx = threadIdx.x; idx < T::ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * T::P + c;
    if (vec && gr < rmax && gc + 8 <= cmax) {
      cp_async16(d, src + (long)gr * ld + gc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (gr < rmax && gc + j < cmax) ? src[(long)gr * ld + gc + j]
                                             : __float2bfloat16(0.f);
    }
  }
}

template <bool A_COL, bool B_COL>
__device__ __forceinline__ void load_stage(bf16* as, bf16* bs, const bf16* A,
                                           long lda, const bf16* B, long ldb,
                                           int M, int N, int K, int m0, int n0,
                                           int k0, bool va, bool vb) {
  if (A_COL) load_tile<ATile<true>>(as, A, lda, k0, m0, K, M, va);
  else       load_tile<ATile<false>>(as, A, lda, m0, k0, M, K, va);
  if (B_COL) load_tile<BTile<true>>(bs, B, ldb, n0, k0, N, K, vb);
  else       load_tile<BTile<false>>(bs, B, ldb, k0, n0, K, N, vb);
}

// The block's output tile C[m0:m0+BM, n0:n0+BN] = sum over k < K of
// A[m, k] B[k, n], in f32, written to shared memory `cs` ([BM][CP]) for the
// caller's epilogue.  `smem` is the block's dynamic shared memory; the
// operand tiles and cs share it.  Ends with __syncthreads.
template <bool A_COL, bool B_COL>
__device__ void mma_tile(unsigned char* smem, const bf16* __restrict__ A,
                         long lda, const bf16* __restrict__ B, long ldb, int M,
                         int N, int K, int m0, int n0, bool va, bool vb) {
  using AT = ATile<A_COL>;
  using BT = BTile<B_COL>;
  using ALayout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  bf16* as[2] = {reinterpret_cast<bf16*>(smem),
                 reinterpret_cast<bf16*>(smem) + AT::ELEMS};
  bf16* bs[2] = {as[1] + AT::ELEMS, as[1] + AT::ELEMS + BT::ELEMS};
  float* cs = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) load_stage<A_COL, B_COL>(as[0], bs[0], A, lda, B, ldb, M, N, K, m0, n0, 0, va, vb);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk)
      load_stage<A_COL, B_COL>(as[(t + 1) & 1], bs[(t + 1) & 1], A, lda, B, ldb,
                               M, N, K, m0, n0, (t + 1) * BK, va, vb);
    cp_async_commit();
    cp_async_wait1();  // stage t has landed
    __syncthreads();
    const bf16* a = as[t & 1];
    const bf16* b = bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = wr * WM + i * 16;
        wmma::load_matrix_sync(fa[i], A_COL ? a + kk * AT::P + m : a + m * AT::P + kk, AT::P);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = wc * WN + j * 16;
        wmma::load_matrix_sync(fb[j], B_COL ? b + n * BT::P + kk : b + kk * BT::P + n, BT::P);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next load overwrites this stage
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wr * WM + i * 16) * CP + wc * WN + j * 16,
                              acc[i][j], CP, wmma::mem_row_major);
  __syncthreads();
}

// May cp.async read 16-byte chunks of a bf16 matrix with leading dimension
// ld at p?
inline bool vec_ok(const void* p, long ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline cudaError_t allow_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

// g[r, v] = bf16((exp(z[r, v] - lse[r]) - (v == label[r])) * dl[r]) for the
// `rows` rows of x, z = x . W recomputed tile by tile: the TPU backward
// kernels' g (torchmpi_tpu/ops/xent.py:100-104), rounded to the operands'
// dtype where they round it before their products (:106, :140).  A
// non-finite lse reads as 0 (:302); a label outside [0, V) never matches.
// Grid (ceil(rows / BM), ceil(V / BN)).
__global__ void __launch_bounds__(NT)
xent_grad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ dl, bf16* __restrict__ g, int rows,
                 int E, int V, bool vx, bool vw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  mma_tile<false, false>(smem, x, E, w, V, rows, V, E, m0, n0, vx, vw);
  const float* cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN, row = m0 + r, col = n0 + c;
    if (row >= rows || col >= V) continue;
    float l = lse[row];
    l = isfinite(l) ? l : 0.f;
    const float p = expf(cs[r * CP + c] - l);
    const float y = labels[row] == col ? 1.f : 0.f;
    g[(long)row * V + col] = __float2bfloat16((p - y) * dl[row]);
  }
}

inline cudaError_t launch_grad(const bf16* x, const bf16* w, const int* labels,
                               const float* lse, const float* dl, bf16* g,
                               int rows, int E, int V, cudaStream_t stream) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(xent_grad_kernel));
  if (e != cudaSuccess) return e;
  dim3 grid((rows + BM - 1) / BM, (V + BN - 1) / BN);
  xent_grad_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      x, w, labels, lse, dl, g, rows, E, V, vec_ok(x, E), vec_ok(w, V));
  return cudaGetLastError();
}

}  // namespace tmx

// The text of a CUDA error code that a launcher returned.  Each kernel
// library carries its own copy; ctypes looks it up per library.
extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
