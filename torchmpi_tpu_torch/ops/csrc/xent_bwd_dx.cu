// xent_bwd_dx: the input gradient of the fused linear + cross-entropy,
// dx = g . W^T, for one chunk of token rows; bf16 or float32 operands, f32
// accumulation, dx in the operands' dtype.
//
// Replaces the TPU kernel _xent_bwd_dx_kernel (torchmpi_tpu/ops/xent.py:82,
// launched by pallas_call in _xent_vjp's backward, :310).
//
// What bounds it: recomputing z = x . W and the product g . W^T, 4 rows E V
// flops per chunk against the bf16 operands, so operations (at 2048 rows,
// E 2048, V 32768: 0.55 TFLOP against 264 MB a chunk; on float32 operands
// the three-product form issues 3 x that in TF32 against twice the bytes).
//
// Design: the TPU kernel carries a [block_n, E] f32 accumulator across the
// vocab blocks (512 KB at 64 x 2048): more than an SM holds.  So the wrapper
// (ops/xent.py) walks the tokens in chunks of up to 2048 rows (1024 on the
// wgmma_tf32 route), and per chunk this library runs two kernels in stream
// order:
//   (a) when make_g, g for the chunk: z = x . W on the tensor cores, then
//       g = (exp(z - lse) - onehot) . dl in W's dtype (as at :106: rounded
//       for bf16) into the [rows, V] workspace;
//   (b) dx[chunk] = g . W^T, a tensor-core product with f32 accumulators
//       over the whole vocab inside the block, cast to x's dtype at the end
//       (:111).
// With make_g = 0, (b) reads the g that a previous launch left in the
// workspace: the autograd backward forms g once per chunk and hands it to
// both this kernel and xent_bwd_dw.  No atomics: every dx element is
// summed by one block in one order.
//
// Four routes, chosen by the caller (ops/xent.py _route) from the dtype,
// the shapes and the addresses, never by a failed launch:
//   wgmma (E and V multiples of 8, 16-byte aligned bases): (a) is
//     tmw::launch_grad and (b) dx_wgmma, both the warp-specialised
//     wgmma.mma_async product of xent_wgmma.cuh on TMA-loaded tiles; (b)
//     takes A = g [rows, V] and B = W read as [N = E, K = V], both K-major,
//     in 128 x 256 tiles (a 2048 x 2048 chunk is 128 blocks on 132 SMs),
//     and casts the accumulators to bf16 in registers.  ptxas (the build
//     line of chip_smoke.py, nvcc 12.9), for both of its wgmma kernels:
//     168 registers a thread at launch, which setmaxnreg moves to 40 in
//     the producer and 232 in the consumers (128 of them the accumulator
//     fragment), no spills; 128 bytes of static and 197,632 of dynamic
//     shared memory, so one block an SM.
//   wmma (any other bf16 shape): (a) tmx::xent_grad_kernel and (b)
//     xent_dx_kernel, on mma_tile (xent_common.cuh);
//   wgmma_tf32 (float32 operands, E and V multiples of 4, 16-byte aligned
//     bases): (a) is tmw::launch_grad_tf32 and (b) dx_tf32, both
//     xent_wgmma.cuh's gemm_tf32_kernel (TF32 wgmma.mma_async m64n128k8 in
//     the three-product form on TMA-loaded hi and lo tiles, 128 x 128
//     tiles, a fresh partial sum every 128 of depth).  Its operands are
//     K-major: (a) takes A = x with its lo part x_lo and B = W^T [V, E]
//     with its lo part, copies the wrapper makes once per call
//     (tm_xent_split); it writes g and g_lo = g - trunc_tf32(g), and,
//     when the wrapper passes them for xent_bwd_dw, g^T and its lo part;
//     (b) takes A = (g, g_lo) [rows, V] and B = W as stored, [N = E, K =
//     V], with its lo part w_lo; dx comes out in float32 from the
//     registers.  g is float32 throughout, never rounded.  A 1024-row
//     chunk at E 2048 is 8 x 16 = 128 blocks of 128 x 128 on 132 SMs.
//     ptxas (the build line of chip_smoke.py, nvcc 12.9), for both of its
//     TF32 kernels: 168 registers a thread at launch (setmaxnreg: 40 in
//     the producer, 232 in the consumers, 128 of them the two fragments),
//     no spills, 197,632 bytes of dynamic shared memory: one block an
//     SM.
//   tf32x3 (float32 operands that TMA cannot read): the same two kernels
//     as wmma on mma_tile<float>, TF32 fragments in the three-product
//     form, g kept in float32.
// A refused route (wgmma or wgmma_tf32 asked for operands it cannot read,
// or a copy it needs missing) returns an error: nothing falls back.

#include "xent_wgmma.cuh"

namespace {

using tmx::BM;
using tmx::BN;
using tmx::CP;
using tmx::bf16;

// Grid (ceil(rows / BM), ceil(E / BN)).
template <class T>
__global__ void __launch_bounds__(tmx::NT)
xent_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
               T* __restrict__ dx, int rows, int E, int V, bool vg, bool vw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // B[k = v, n = e] = W[e, v]: W is the col-major [E, V] B operand.
  tmx::mma_tile<T, false, true>(smem, g, V, w, V, rows, E, V, m0, n0, vg, vw);
  const float* cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += tmx::NT) {
    const int r = idx / BN, c = idx % BN, row = m0 + r, col = n0 + c;
    if (row < rows && col < E) dx[(long)row * E + col] = tmx::from_f32<T>(cs[r * CP + c]);
  }
}

// (a) when make_g, then (b), on mma_tile<T>: the wmma and tf32x3 routes.
template <class T>
cudaError_t dx_mma(const T* x, const T* w, const int* labels, const float* lse,
                   const float* dl, T* g, T* dx, int rows, int E, int V,
                   bool make_g, cudaStream_t st) {
  cudaError_t e;
  if (make_g) {
    e = tmx::launch_grad(x, w, labels, lse, dl, g, rows, E, V, st);
    if (e != cudaSuccess) return e;
  }
  e = tmx::allow_smem(reinterpret_cast<const void*>(xent_dx_kernel<T>));
  if (e != cudaSuccess) return e;
  dim3 grid((rows + BM - 1) / BM, (E + BN - 1) / BN);
  xent_dx_kernel<T><<<grid, tmx::NT, tmx::SMEM_BYTES, st>>>(
      g, w, dx, rows, E, V, tmx::vec_ok(g, V), tmx::vec_ok(w, V));
  return cudaGetLastError();
}

// dx = bf16(acc) on the wgmma accumulators.
struct DxEpi {
  bf16* dx;
  int rows, E;
  __device__ __forceinline__ void operator()(const float (&d)[tmw::ACC], int r0,
                                             int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < tmw::ACC / 4; ++j) {
        const int col = c0 + 8 * j;  // even, and E is a multiple of 8
        if (col < E)
          *reinterpret_cast<__nv_bfloat162*>(dx + (long)row * E + col) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
};

// dx = acc in float32, on the TF32 fragment.
struct DxF32Epi {
  float* dx;
  int rows, E;
  __device__ __forceinline__ void operator()(const float (&d)[tmw::TACC], int r0,
                                             int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < tmw::TACC / 4; ++j) {
        const int col = c0 + 8 * j;  // even, and E is a multiple of 4
        if (col < E)
          *reinterpret_cast<float2*>(dx + (long)row * E + col) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
};

// (a) when make_g, then (b), on the TF32 wgmma product.
cudaError_t dx_tf32(const float* x, const float* w, const int* labels,
                    const float* lse, const float* dl, float* g, float* dx,
                    int rows, int E, int V, bool make_g, const tmw::Tf32Ops& o,
                    cudaStream_t st) {
  if (make_g) {
    const cudaError_t e = tmw::launch_grad_tf32(
        x, o.x_lo, o.wt, o.wt_lo, labels, lse, dl, g, o.g_lo, o.gt, o.gt_lo,
        rows, E, V, st);
    if (e != cudaSuccess) return e;
  }
  return tmw::launch_gemm_tf32(g, o.g_lo, V, w, o.w_lo, V, rows, E, V,
                               DxF32Epi{dx, rows, E}, st);
}

cudaError_t dx_wgmma(const bf16* g, const bf16* w, bf16* dx, int rows, int E,
                     int V, cudaStream_t st) {
  CUtensorMap tg, tw;
  cudaError_t e = tmw::make_map(&tg, g, rows, V);
  if (e == cudaSuccess) e = tmw::make_map(&tw, w, E, V);
  if (e != cudaSuccess) return e;
  return tmw::launch_gemm<false, false>(tg, tw, rows, E, V, DxEpi{dx, rows, E}, st);
}

}  // namespace

// One chunk: x [rows, E], labels / lse / dl [rows], dx [rows, E] (pointers
// at the chunk's first row), w [E, V], g [rows, V] workspace; x, w, g and
// dx of the route's dtype (tmx::Route: 0 wgmma and 1 wmma bfloat16, 2
// tf32x3 and 3 wgmma_tf32 float32), labels int32, lse / dl f32;
// contiguous, on the device.  make_g: form g first (else read the
// workspace as it is).  The wgmma route needs E and V multiples of 8 and
// x, w, g and dx 16-byte aligned; the wgmma_tf32 route E and V multiples
// of 4, those four 16-byte aligned, and the copies of tmw::Tf32Ops (x_lo
// to g_lo; with make_g also x_lo, wt, wt_lo; gt and gt_lo, when given,
// are written too), else the launch is refused.  The copies are ignored
// on the other routes.  Returns the CUDA error code.
extern "C" int tm_xent_bwd_dx(const void* x, const void* w, const int* labels,
                              const float* lse, const float* dl, void* g,
                              void* dx, int rows, int E, int V, int make_g,
                              int route, const float* x_lo, const float* xt,
                              const float* xt_lo, const float* wt,
                              const float* wt_lo, const float* w_lo,
                              float* g_lo, float* gt, float* gt_lo,
                              void* stream) {
  if (rows <= 0 || E <= 0 || V <= 0 || route < tmx::kWgmma ||
      route > tmx::kWgmmaTf32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == tmx::kWgmmaTf32) {
    const tmw::Tf32Ops o{x_lo, xt, xt_lo, wt, wt_lo, w_lo, g_lo, gt, gt_lo};
    if (!(tmw::tma_ok_f32(w, V) && tmw::tma_ok_f32(g, V) &&
          tmw::tma_ok_f32(dx, E) && tmw::tma_ok_f32(o.w_lo, V) &&
          tmw::tma_ok_f32(o.g_lo, V)))
      return (int)cudaErrorInvalidValue;
    if (make_g && !(tmw::tma_ok_f32(x, E) && tmw::tma_ok_f32(o.x_lo, E) &&
                    tmw::tma_ok_f32(o.wt, E) && tmw::tma_ok_f32(o.wt_lo, E)))
      return (int)cudaErrorInvalidValue;
    return (int)dx_tf32(static_cast<const float*>(x), static_cast<const float*>(w),
                        labels, lse, dl, static_cast<float*>(g),
                        static_cast<float*>(dx), rows, E, V, make_g != 0, o, st);
  }
  if (route == tmx::kTf32x3)
    return (int)dx_mma(static_cast<const float*>(x), static_cast<const float*>(w),
                       labels, lse, dl, static_cast<float*>(g),
                       static_cast<float*>(dx), rows, E, V, make_g != 0, st);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* gb = static_cast<bf16*>(g);
  bf16* dxb = static_cast<bf16*>(dx);
  if (route == tmx::kWmma)
    return (int)dx_mma(xb, wb, labels, lse, dl, gb, dxb, rows, E, V,
                       make_g != 0, st);
  if (!(tmw::tma_ok(x, E) && tmw::tma_ok(w, V) && tmw::tma_ok(g, V) &&
        tmw::tma_ok(dx, E)))
    return (int)cudaErrorInvalidValue;
  if (make_g) {
    const cudaError_t e = tmw::launch_grad(xb, wb, labels, lse, dl, gb, rows, E, V, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)dx_wgmma(gb, wb, dxb, rows, E, V, st);
}
