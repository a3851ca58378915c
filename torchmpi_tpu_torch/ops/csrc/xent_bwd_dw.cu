// xent_bwd_dw: the weight gradient of the fused linear + cross-entropy,
// dW += x^T . g, for one chunk of token rows; bf16 or float32 operands, f32
// accumulation across chunks, dW in the operands' dtype after the last
// chunk.
//
// Replaces the TPU kernel _xent_bwd_dw_kernel (torchmpi_tpu/ops/xent.py:114,
// launched by pallas_call in _xent_vjp's backward, :330).
//
// What bounds it: recomputing z = x . W and the product x^T . g, 4 rows E V
// flops per chunk against the bf16 operands, so operations (at 2048 rows,
// E 2048, V 32768: 0.55 TFLOP against 144 MB of operands and 512 MB of f32
// accumulator traffic a middle chunk; on float32 operands the three-product
// form issues 3 x the flops in TF32).
//
// Design: the TPU kernel carries an [E, block_v] f32 accumulator across the
// token blocks (4 MiB at 2048 x 512): far more than an SM holds.  Here the
// token axis is cut into chunks by the wrapper (ops/xent.py), and the f32
// accumulator is the TPU's own f32 out_shape (:332), a [E, V] buffer in
// device memory.  Per chunk this library runs, in stream order:
//   (a) when make_g, g for the chunk in x's dtype (as at :140: rounded for
//       bf16) into the [rows, V] workspace;
//   (b) one block per tile of dW forms x^T . g over the chunk's rows on the
//       tensor cores and adds it to the accumulator: the first chunk writes
//       it, later chunks add to it, and the last chunk writes bf16(sum) to
//       dW instead (:145).
// The chunks run in order on one stream and every element is summed by one
// block, so the result is deterministic: no atomics.
//
// Four routes, chosen by the caller (ops/xent.py _route) from the dtype,
// the shapes and the addresses, never by a failed launch:
//   wgmma (E and V multiples of 8, 16-byte aligned bases): (a) is
//     tmw::launch_grad and (b) dw_wgmma, the warp-specialised
//     wgmma.mma_async product of xent_wgmma.cuh on TMA-loaded tiles; (b)
//     takes A = x^T (x [rows, E] read MN-major) and B = g [rows, V]
//     (MN-major), so neither is transposed in memory, in 128 x 256 tiles of
//     dW, and adds to the accumulator from the registers.  ptxas (the build
//     line of chip_smoke.py, nvcc 12.9), for both of its wgmma kernels:
//     168 registers a thread at launch, which setmaxnreg moves to 40 in
//     the producer and 232 in the consumers (128 of them the accumulator
//     fragment), no spills; 128 bytes of static and 197,632 of dynamic
//     shared memory, so one block an SM.
//   wmma (any other bf16 shape): (a) tmx::xent_grad_kernel and (b)
//     xent_dw_kernel, on mma_tile (xent_common.cuh);
//   wgmma_tf32 (float32 operands, E and V multiples of 4, 16-byte aligned
//     bases): (a) is tmw::launch_grad_tf32 writing g^T and its lo part
//     only, and (b) dw_tf32, both xent_wgmma.cuh's gemm_tf32_kernel (TF32
//     wgmma.mma_async m64n128k8 in the three-product form on TMA-loaded hi
//     and lo tiles, 128 x 128 tiles of dW, a fresh partial sum every 128
//     of depth).  The depth here is the chunk's rows, the outer axis of
//     both x and g as stored, and TF32 wgmma takes K-major operands only,
//     so (b) reads the chunk's x^T [E, ldt] and g^T [V, ldt] with their lo
//     parts: the wrapper makes x^T per chunk (tm_xent_split), and g^T is
//     written by whichever launch forms g (this one with make_g, else
//     xent_bwd_dx's).  ldt = rows rounded up to 4 (tmw::tf32_pitch); the
//     TMA maps end at `rows`, so the padding is never read.  dW and the
//     accumulator are float32, added to from the registers.  ptxas (nvcc
//     12.9): 168 registers a thread at launch, no spills, one block an
//     SM, as xent_bwd_dx's TF32 kernels.
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

// Grid (ceil(E / BM), ceil(V / BN)).
template <class T>
__global__ void __launch_bounds__(tmx::NT)
xent_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
               float* __restrict__ acc, T* __restrict__ dw, int rows, int E,
               int V, bool first, bool last, bool vx, bool vg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // A[m = e, k = r] = x[r, e]: x is the col-major [rows, E] A operand.
  tmx::mma_tile<T, true, false>(smem, x, E, g, V, E, V, rows, m0, n0, vx, vg);
  const float* cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += tmx::NT) {
    const int r = idx / BN, c = idx % BN, e = m0 + r, v = n0 + c;
    if (e >= E || v >= V) continue;
    const long o = (long)e * V + v;
    const float s = first ? cs[r * CP + c] : acc[o] + cs[r * CP + c];
    if (last) dw[o] = tmx::from_f32<T>(s);
    else acc[o] = s;
  }
}

// (a) when make_g, then (b), on mma_tile<T>: the wmma and tf32x3 routes.
template <class T>
cudaError_t dw_mma(const T* x, const T* w, const int* labels, const float* lse,
                   const float* dl, T* g, float* acc, T* dw, int rows, int E,
                   int V, bool make_g, bool first, bool last, cudaStream_t st) {
  cudaError_t e;
  if (make_g) {
    e = tmx::launch_grad(x, w, labels, lse, dl, g, rows, E, V, st);
    if (e != cudaSuccess) return e;
  }
  e = tmx::allow_smem(reinterpret_cast<const void*>(xent_dw_kernel<T>));
  if (e != cudaSuccess) return e;
  dim3 grid((E + BM - 1) / BM, (V + BN - 1) / BN);
  xent_dw_kernel<T><<<grid, tmx::NT, tmx::SMEM_BYTES, st>>>(
      x, g, acc, dw, rows, E, V, first, last, tmx::vec_ok(x, E),
      tmx::vec_ok(g, V));
  return cudaGetLastError();
}

// acc (+)= the wgmma accumulators, or dW = bf16(acc + them) on the last
// chunk.  The accumulator's reads go out in groups of G before the group's
// stores: the compiler cannot tell that the stores miss the later reads,
// and would otherwise wait out one device-memory round trip per pair.
struct DwEpi {
  float* acc;
  bf16* dw;
  int E, V;
  bool first, last;
  static constexpr int G = 16;
  __device__ __forceinline__ void operator()(const float (&d)[tmw::ACC], int r0,
                                             int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = r0 + 8 * h;
      if (e >= E) continue;
      float* arow = acc + (long)e * V;
      bf16* drow = dw + (long)e * V;
#pragma unroll
      for (int j0 = 0; j0 < tmw::ACC / 4; j0 += G) {
        float2 a[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int v = c0 + 8 * (j0 + i);  // even, and V is a multiple of 8
          a[i] = (!first && v < V) ? *reinterpret_cast<const float2*>(arow + v)
                                   : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int v = c0 + 8 * (j0 + i), j = j0 + i;
          if (v >= V) continue;
          const float d0 = d[4 * j + 2 * h], d1 = d[4 * j + 2 * h + 1];
          const float2 s = first ? make_float2(d0, d1)
                                 : make_float2(a[i].x + d0, a[i].y + d1);
          if (last)
            *reinterpret_cast<__nv_bfloat162*>(drow + v) =
                __floats2bfloat162_rn(s.x, s.y);
          else
            *reinterpret_cast<float2*>(arow + v) = s;
        }
      }
    }
  }
};

// acc (+)= the TF32 fragment, or dW = acc + it on the last chunk, in
// float32; reads grouped before stores as DwEpi's.
struct DwF32Epi {
  float* acc;
  float* dw;
  int E, V;
  bool first, last;
  __device__ __forceinline__ void operator()(const float (&d)[tmw::TACC], int r0,
                                             int c0) const {
    constexpr int J = tmw::TACC / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = r0 + 8 * h;
      if (e >= E) continue;
      float* arow = acc + (long)e * V;
      float* drow = dw + (long)e * V;
      float2 a[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int v = c0 + 8 * j;  // even, and V is a multiple of 4
        a[j] = (!first && v < V) ? *reinterpret_cast<const float2*>(arow + v)
                                 : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int v = c0 + 8 * j;
        if (v >= V) continue;
        const float d0 = d[4 * j + 2 * h], d1 = d[4 * j + 2 * h + 1];
        const float2 s = first ? make_float2(d0, d1)
                               : make_float2(a[j].x + d0, a[j].y + d1);
        *reinterpret_cast<float2*>((last ? drow : arow) + v) = s;
      }
    }
  }
};

// (a) when make_g, then (b), on the TF32 wgmma product.
cudaError_t dw_tf32(const float* x, const int* labels, const float* lse,
                    const float* dl, float* acc, float* dw, int rows, int E,
                    int V, bool make_g, bool first, bool last,
                    const tmw::Tf32Ops& o, cudaStream_t st) {
  if (make_g) {
    const cudaError_t e = tmw::launch_grad_tf32(
        x, o.x_lo, o.wt, o.wt_lo, labels, lse, dl, nullptr, nullptr,
        o.gt, o.gt_lo, rows, E, V, st);
    if (e != cudaSuccess) return e;
  }
  const int ldt = tmw::tf32_pitch(rows);
  return tmw::launch_gemm_tf32(o.xt, o.xt_lo, ldt, o.gt, o.gt_lo, ldt, E, V,
                               rows, DwF32Epi{acc, dw, E, V, first, last}, st);
}

cudaError_t dw_wgmma(const bf16* x, const bf16* g, float* acc, bf16* dw,
                     int rows, int E, int V, bool first, bool last,
                     cudaStream_t st) {
  CUtensorMap tx, tg;
  cudaError_t e = tmw::make_map(&tx, x, rows, E);
  if (e == cudaSuccess) e = tmw::make_map(&tg, g, rows, V);
  if (e != cudaSuccess) return e;
  return tmw::launch_gemm<true, true>(tx, tg, E, V, rows,
                                      DwEpi{acc, dw, E, V, first, last}, st);
}

}  // namespace

// One chunk: x [rows, E], labels / lse / dl [rows] (pointers at the chunk's
// first row), w [E, V], g [rows, V] workspace, acc [E, V] f32 (unused when
// the chunk is both first and last), dw [E, V]; x, w, g and dw of the
// route's dtype (tmx::Route: 0 wgmma and 1 wmma bfloat16, 2 tf32x3 and 3
// wgmma_tf32 float32), labels int32, lse / dl / acc f32; contiguous, on
// the device.  make_g: form g first (else read the workspace as it is;
// on wgmma_tf32, g^T and its lo part instead of g).  The wgmma route needs
// E and V multiples of 8 and x, w, g, acc and dw 16-byte aligned; the
// wgmma_tf32 route E and V multiples of 4, dw and acc 16-byte aligned, and
// the copies of tmw::Tf32Ops (xt, xt_lo, gt, gt_lo; with make_g also x,
// x_lo, wt, wt_lo; g is not read), else the launch is refused.  The copies
// are ignored on the other routes.  Returns the CUDA error code.
extern "C" int tm_xent_bwd_dw(const void* x, const void* w, const int* labels,
                              const float* lse, const float* dl, void* g,
                              float* acc, void* dw, int rows, int E, int V,
                              int make_g, int first, int last, int route,
                              const float* x_lo, const float* xt,
                              const float* xt_lo, const float* wt,
                              const float* wt_lo, const float* w_lo,
                              float* g_lo, float* gt, float* gt_lo,
                              void* stream) {
  if (rows <= 0 || E <= 0 || V <= 0 || route < tmx::kWgmma ||
      route > tmx::kWgmmaTf32)
    return (int)cudaErrorInvalidValue;
  if (!(first && last) && acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == tmx::kWgmmaTf32) {
    const tmw::Tf32Ops o{x_lo, xt, xt_lo, wt, wt_lo, w_lo, g_lo, gt, gt_lo};
    const int ldt = tmw::tf32_pitch(rows);
    if (!(tmw::tma_ok_f32(dw, V) &&
          ((first && last) || tmw::tma_ok_f32(acc, V)) &&
          tmw::tma_ok_f32(o.xt, ldt) && tmw::tma_ok_f32(o.xt_lo, ldt) &&
          tmw::tma_ok_f32(o.gt, ldt) && tmw::tma_ok_f32(o.gt_lo, ldt)))
      return (int)cudaErrorInvalidValue;
    if (make_g && !(tmw::tma_ok_f32(x, E) && tmw::tma_ok_f32(o.x_lo, E) &&
                    tmw::tma_ok_f32(o.wt, E) && tmw::tma_ok_f32(o.wt_lo, E)))
      return (int)cudaErrorInvalidValue;
    return (int)dw_tf32(static_cast<const float*>(x), labels, lse, dl, acc,
                        static_cast<float*>(dw), rows, E, V, make_g != 0,
                        first != 0, last != 0, o, st);
  }
  if (route == tmx::kTf32x3)
    return (int)dw_mma(static_cast<const float*>(x), static_cast<const float*>(w),
                       labels, lse, dl, static_cast<float*>(g), acc,
                       static_cast<float*>(dw), rows, E, V, make_g != 0,
                       first != 0, last != 0, st);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* gb = static_cast<bf16*>(g);
  bf16* dwb = static_cast<bf16*>(dw);
  if (route == tmx::kWmma)
    return (int)dw_mma(xb, wb, labels, lse, dl, gb, acc, dwb, rows, E, V,
                       make_g != 0, first != 0, last != 0, st);
  if (!(tmw::tma_ok(x, E) && tmw::tma_ok(w, V) && tmw::tma_ok(g, V) &&
        tmw::tma_ok(acc, V) && tmw::tma_ok(dw, V)))
    return (int)cudaErrorInvalidValue;
  if (make_g) {
    const cudaError_t e = tmw::launch_grad(xb, wb, labels, lse, dl, gb, rows, E, V, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)dw_wgmma(xb, gb, acc, dwb, rows, E, V, first != 0, last != 0, st);
}
