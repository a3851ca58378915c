// xent_bwd_dw: the weight gradient of the fused linear + cross-entropy,
// dW += x^T . g, for one chunk of token rows; bf16 operands, f32
// accumulation across chunks, dW in bf16 after the last chunk.
//
// Replaces the TPU kernel _xent_bwd_dw_kernel (torchmpi_tpu/ops/xent.py:114,
// launched by pallas_call in _xent_vjp's backward, :330).
//
// What bounds it: recomputing z = x . W and the product x^T . g, 4 rows E V
// flops per chunk against the bf16 operands, so operations.
//
// Design: the TPU kernel carries an [E, block_v] f32 accumulator across the
// token blocks (4 MiB at 2048 x 512): far more than an SM holds.  Here the
// token axis is cut into chunks by the wrapper (ops/xent.py), and the f32
// accumulator is the TPU's own f32 out_shape (:332), a [E, V] buffer in
// device memory.  Per chunk this library runs, in stream order:
//   (a) xent_grad_kernel (xent_common.cuh), when make_g: g for the chunk,
//       rounded to bf16 (x's dtype, as at :140) into the [rows, V] workspace;
//   (b) xent_dw_kernel: one block per [128 x 128] tile of dW forms x^T . g
//       over the chunk's rows on the tensor cores (x read as the col-major A
//       operand) and adds it to the accumulator: the first chunk writes it,
//       later chunks add to it, and the last chunk writes bf16(sum) to dW
//       instead (:145).
// The chunks run in order on one stream and every element is summed by one
// block, so the result is deterministic: no atomics.

#include "xent_common.cuh"

namespace {

using tmx::BM;
using tmx::BN;
using tmx::CP;
using tmx::bf16;

// Grid (ceil(E / BM), ceil(V / BN)).
__global__ void __launch_bounds__(tmx::NT)
xent_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               float* __restrict__ acc, bf16* __restrict__ dw, int rows, int E,
               int V, bool first, bool last, bool vx, bool vg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // A[m = e, k = r] = x[r, e]: x is the col-major [rows, E] A operand.
  tmx::mma_tile<true, false>(smem, x, E, g, V, E, V, rows, m0, n0, vx, vg);
  const float* cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += tmx::NT) {
    const int r = idx / BN, c = idx % BN, e = m0 + r, v = n0 + c;
    if (e >= E || v >= V) continue;
    const long o = (long)e * V + v;
    const float s = first ? cs[r * CP + c] : acc[o] + cs[r * CP + c];
    if (last) dw[o] = __float2bfloat16(s);
    else acc[o] = s;
  }
}

}  // namespace

// One chunk: x [rows, E], labels / lse / dl [rows] (pointers at the chunk's
// first row), w [E, V], g [rows, V] workspace, acc [E, V] f32 (unused when
// the chunk is both first and last), dw [E, V]; bf16 except labels (int32)
// and lse / dl / acc (f32); contiguous, on the device.  make_g: form g first
// (else read the workspace as it is).  Returns the CUDA error code.
extern "C" int tm_xent_bwd_dw(const bf16* x, const bf16* w, const int* labels,
                              const float* lse, const float* dl, bf16* g,
                              float* acc, bf16* dw, int rows, int E, int V,
                              int make_g, int first, int last, void* stream) {
  if (rows <= 0 || E <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (!(first && last) && acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (make_g) {
    e = tmx::launch_grad(x, w, labels, lse, dl, g, rows, E, V, st);
    if (e != cudaSuccess) return (int)e;
  }
  e = tmx::allow_smem(reinterpret_cast<const void*>(xent_dw_kernel));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((E + BM - 1) / BM, (V + BN - 1) / BN);
  xent_dw_kernel<<<grid, tmx::NT, tmx::SMEM_BYTES, st>>>(
      x, g, acc, dw, rows, E, V, first != 0, last != 0, tmx::vec_ok(x, E),
      tmx::vec_ok(g, V));
  return (int)cudaGetLastError();
}
