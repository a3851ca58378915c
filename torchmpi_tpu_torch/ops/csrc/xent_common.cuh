// Shared pieces of the fused linear + cross-entropy kernels (xent_fwd.cu,
// xent_bwd_dx.cu, xent_bwd_dw.cu): one tensor-core tile product on bf16 or
// float32 operands, the tile loader that masks ragged edges, and the kernel
// that recomputes the logits' gradient g.  The backward recomputes p =
// exp(z - lse) against the forward's lse, as the TPU kernels take z from
// one dot_general with f32 accumulation (torchmpi_tpu/ops/xent.py:47, :93,
// :127).  Each kernel forms z here (mma_tile) on its wmma and tf32x3 routes
// and in xent_wgmma.cuh on its wgmma route, summing the products in
// another f32 order; the kernels need not see bitwise the same logits.
//
// The product, mma_tile<T>: block tile BM x BN = 128 x 128, 8 warps of 32 x
// 64 each (2 x 4 fragments), operand tiles double-buffered in shared memory
// through cp.async, depth step Op<T>::BK.
//   bf16 (the wmma route): nvcuda::wmma bf16 16x16x16 fragments with f32
//     accumulators (mma.sync on the tensor cores), BK 32.  A bf16 x bf16
//     product is exact in f32, so the tile computes the TPU kernel's
//     function (preferred_element_type f32); only the order of the f32 sums
//     differs, which reaches p as ~1e-6 relative, far below g's bf16
//     rounding (2^-8).
//   float32 (the tf32x3 route): wmma TF32 16x16x8 fragments in the
//     three-product form of the flash kernels (flash_common.cuh, split):
//     each operand element x = hi + lo with hi = tf32(x) and lo = tf32(x -
//     hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, so a product keeps
//     f32's accuracy where TF32 alone keeps ~3 digits.  The tensor cores'
//     f32 accumulation does not round to nearest and a long sum kept in an
//     accumulator fragment drifts, so each BK step sums into a fresh
//     fragment (BK / 8 k-steps, 3 products each) and the steps are added
//     in f32 on the CUDA cores.  f32 tiles hold twice the bytes of bf16
//     ones, so BK is halved to 16 (rather than sizing the shared memory per
//     type): every kernel keeps one SMEM_BYTES and the operand tiles still
//     fit under the staged output tile.  TF32 wgmma takes K-major operands
//     only, and W is MN-major as stored for the product z = x . W; the
//     backward's wgmma_tf32 route (xent_wgmma.cuh gemm_tf32_kernel) runs
//     on K-major copies the wrapper makes (W^T, x^T and the lo parts), so
//     this product keeps the float32 forward and the backward calls whose
//     operands TMA cannot read.
// The bf16 kernels run on it for every shape whose operands TMA cannot read
// (E or V not a multiple of 8, or a base not 16-byte aligned); every other
// bf16 shape takes xent_wgmma.cuh's wgmma.mma_async product on TMA-loaded
// tiles.  The float32 forward runs on it at every shape, the float32
// backward where E or V is not a multiple of 4 or a base is not 16-byte
// aligned.
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

constexpr int BM = 128, BN = 128;            // block tile
constexpr int NT = 256;                     // 8 warps: 4 (rows) x 2 (cols)
constexpr int WM = 32, WN = 64;             // one warp's share of the tile
constexpr int FM = WM / 16, FN = WN / 16;   // its 2 x 4 fragments
constexpr int CP = BN + 4;                  // f32 pitch of the staged tile

// What the product takes of each operand type: the depth step BK, the
// fragment's depth FK and element type, and VEC elements per 16 bytes.
template <class T> struct Op;
template <> struct Op<bf16> {
  static constexpr int BK = 32, FK = 16, VEC = 8;
  using Frag = bf16;
};
template <> struct Op<float> {
  static constexpr int BK = 16, FK = 8, VEC = 4;
  using Frag = wmma::precision::tf32;
};

template <class T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// A stored tile: ROWS rows of COLS contiguous elements, pitch COLS + 8 (a
// multiple of 8 elements, as wmma wants; the skew spreads banks).
template <int ROWS_, int COLS_>
struct Tile {
  static constexpr int ROWS = ROWS_, COLS = COLS_, P = COLS_ + 8;
  static constexpr int ELEMS = ROWS * P;
};
// A is [M, K] row-major, or (COL) stored as its transpose [K, M]; B is
// [K, N] row-major, or (COL) stored as [N, K].
template <class T, bool COL>
using ATile = Tile<COL ? Op<T>::BK : BM, COL ? BM : Op<T>::BK>;
template <class T, bool COL>
using BTile = Tile<COL ? BN : Op<T>::BK, COL ? Op<T>::BK : BN>;

// Dynamic shared memory of every kernel here: the staged f32 output tile
// (which reuses the operand buffers once the product is done) and four
// per-row arrays.
constexpr size_t SMEM_BYTES = sizeof(float) * (BM * CP + 4 * BM);
template <class T>
constexpr bool fits() {
  return 2 * (ATile<T, false>::ELEMS + BTile<T, true>::ELEMS) * sizeof(T) <=
             sizeof(float) * BM * CP &&
         2 * (ATile<T, true>::ELEMS + BTile<T, false>::ELEMS) * sizeof(T) <=
             sizeof(float) * BM * CP;
}
static_assert(fits<bf16>() && fits<float>(),
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

// Copy the TT::ROWS x TT::COLS tile whose first element is (r0, c0) of a
// [rmax, cmax] matrix (leading dimension ld) into shared memory.  Elements
// past rmax or cmax read as zero: the ragged edge adds nothing to a product.
// Whole 16-byte chunks go by cp.async when `vec` (ld a multiple of 16
// bytes and the base 16-byte aligned); the edge chunks, and every chunk
// otherwise, by plain loads.
template <class T, class TT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long ld, int r0, int c0, int rmax,
                                          int cmax, bool vec) {
  constexpr int V = Op<T>::VEC, CPR = TT::COLS / V;
  for (int idx = threadIdx.x; idx < TT::ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * TT::P + c;
    if (vec && gr < rmax && gc + V <= cmax) {
      cp_async16(d, src + (long)gr * ld + gc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[j] = (gr < rmax && gc + j < cmax) ? src[(long)gr * ld + gc + j]
                                             : from_f32<T>(0.f);
    }
  }
}

template <class T, bool A_COL, bool B_COL>
__device__ __forceinline__ void load_stage(T* as, T* bs, const T* A, long lda,
                                           const T* B, long ldb, int M, int N,
                                           int K, int m0, int n0, int k0,
                                           bool va, bool vb) {
  if (A_COL) load_tile<T, ATile<T, true>>(as, A, lda, k0, m0, K, M, va);
  else       load_tile<T, ATile<T, false>>(as, A, lda, m0, k0, M, K, va);
  if (B_COL) load_tile<T, BTile<T, true>>(bs, B, ldb, n0, k0, N, K, vb);
  else       load_tile<T, BTile<T, false>>(bs, B, ldb, k0, n0, K, N, vb);
}

// x = hi + lo in TF32, element by element of a loaded fragment.
template <class F>
__device__ __forceinline__ void split_tf32(F& hi, F& lo) {
#pragma unroll
  for (int t = 0; t < hi.num_elements; ++t) {
    const float v = hi.x[t];
    hi.x[t] = wmma::__float_to_tf32(v);
    lo.x[t] = wmma::__float_to_tf32(v - hi.x[t]);
  }
}

// The block's output tile C[m0:m0+BM, n0:n0+BN] = sum over k < K of
// A[m, k] B[k, n], in f32, written to shared memory `cs` ([BM][CP]) for the
// caller's epilogue.  `smem` is the block's dynamic shared memory; the
// operand tiles and cs share it.  Ends with __syncthreads.
template <class T, bool A_COL, bool B_COL>
__device__ void mma_tile(unsigned char* smem, const T* __restrict__ A,
                         long lda, const T* __restrict__ B, long ldb, int M,
                         int N, int K, int m0, int n0, bool va, bool vb) {
  using AT = ATile<T, A_COL>;
  using BT = BTile<T, B_COL>;
  using ALayout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  constexpr int BK = Op<T>::BK, FK = Op<T>::FK;
  constexpr bool F32 = std::is_same<T, float>::value;
  using Frag = typename Op<T>::Frag;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, FK, float>;
  T* as[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + AT::ELEMS};
  T* bs[2] = {as[1] + AT::ELEMS, as[1] + AT::ELEMS + BT::ELEMS};
  float* cs = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  if (nk > 0)
    load_stage<T, A_COL, B_COL>(as[0], bs[0], A, lda, B, ldb, M, N, K, m0, n0, 0, va, vb);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk)
      load_stage<T, A_COL, B_COL>(as[(t + 1) & 1], bs[(t + 1) & 1], A, lda, B,
                                  ldb, M, N, K, m0, n0, (t + 1) * BK, va, vb);
    cp_async_commit();
    cp_async_wait1();  // stage t has landed
    __syncthreads();
    const T* a = as[t & 1];
    const T* b = bs[t & 1];
    if constexpr (!F32) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += FK) {
        wmma::fragment<wmma::matrix_a, 16, 16, FK, Frag, ALayout> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, FK, Frag, BLayout> fb[FN];
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
    } else {
      // This step's sums in fresh fragments, then added to acc in f32.
      Acc step[FM][FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(step[i][j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += FK) {
        wmma::fragment<wmma::matrix_a, 16, 16, FK, Frag, ALayout> ahi[FM], alo[FM];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int m = wr * WM + i * 16;
          wmma::load_matrix_sync(ahi[i], A_COL ? a + kk * AT::P + m : a + m * AT::P + kk, AT::P);
          split_tf32(ahi[i], alo[i]);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int n = wc * WN + j * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, FK, Frag, BLayout> bhi, blo;
          wmma::load_matrix_sync(bhi, B_COL ? b + n * BT::P + kk : b + kk * BT::P + n, BT::P);
          split_tf32(bhi, blo);
#pragma unroll
          for (int i = 0; i < FM; ++i) {
            wmma::mma_sync(step[i][j], alo[i], bhi, step[i][j]);
            wmma::mma_sync(step[i][j], ahi[i], blo, step[i][j]);
            wmma::mma_sync(step[i][j], ahi[i], bhi, step[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            acc[i][j].x[e] += step[i][j].x[e];
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

// May cp.async read 16-byte chunks of a T matrix with leading dimension ld
// at p?
template <class T>
inline bool vec_ok(const T* p, long ld) {
  return ld % Op<T>::VEC == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline cudaError_t allow_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

// g[r, v] = T((exp(z[r, v] - lse[r]) - (v == label[r])) * dl[r]) for the
// `rows` rows of x, z = x . W recomputed tile by tile: the TPU backward
// kernels' g (torchmpi_tpu/ops/xent.py:100-104), in the operands' dtype T
// where they cast it before their products (:106, :140): rounded for bf16,
// as it is for float32.  A non-finite lse reads as 0 (:302); a label
// outside [0, V) never matches.  Grid (ceil(rows / BM), ceil(V / BN)).
template <class T>
__global__ void __launch_bounds__(NT)
xent_grad_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ dl, T* __restrict__ g, int rows,
                 int E, int V, bool vx, bool vw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  mma_tile<T, false, false>(smem, x, E, w, V, rows, V, E, m0, n0, vx, vw);
  const float* cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN, row = m0 + r, col = n0 + c;
    if (row >= rows || col >= V) continue;
    float l = lse[row];
    l = isfinite(l) ? l : 0.f;
    const float p = expf(cs[r * CP + c] - l);
    const float y = labels[row] == col ? 1.f : 0.f;
    g[(long)row * V + col] = from_f32<T>((p - y) * dl[row]);
  }
}

template <class T>
inline cudaError_t launch_grad(const T* x, const T* w, const int* labels,
                               const float* lse, const float* dl, T* g,
                               int rows, int E, int V, cudaStream_t stream) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(xent_grad_kernel<T>));
  if (e != cudaSuccess) return e;
  dim3 grid((rows + BM - 1) / BM, (V + BN - 1) / BN);
  xent_grad_kernel<T><<<grid, NT, SMEM_BYTES, stream>>>(
      x, w, labels, lse, dl, g, rows, E, V, vec_ok(x, E), vec_ok(w, V));
  return cudaGetLastError();
}

// The route code of the C launchers, ops/xent.py ROUTES' order: wgmma and
// wmma take bfloat16 operands, tf32x3 and wgmma_tf32 float32 ones.
enum Route { kWgmma = 0, kWmma = 1, kTf32x3 = 2, kWgmmaTf32 = 3 };

}  // namespace tmx

// The text of a CUDA error code that a launcher returned.  Each kernel
// library carries its own copy; ctypes looks it up per library.
extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
