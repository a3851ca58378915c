// xent_bwd_dx: the input gradient of the fused linear + cross-entropy,
// dx = g . W^T, for one chunk of token rows; bf16 operands, f32
// accumulation, dx in bf16.
//
// Replaces the TPU kernel _xent_bwd_dx_kernel (torchmpi_tpu/ops/xent.py:82,
// launched by pallas_call in _xent_vjp's backward, :310).
//
// What bounds it: recomputing z = x . W and the product g . W^T, 4 rows E V
// flops per chunk against the bf16 operands, so operations.
//
// Design: the TPU kernel carries a [block_n, E] f32 accumulator across the
// vocab blocks (512 KB at 64 x 2048): more than an SM holds.  So the wrapper
// (ops/xent.py) walks the tokens in chunks of up to 2048 rows, and per chunk
// this library runs two kernels in stream order:
//   (a) xent_grad_kernel (xent_common.cuh), when make_g: z for the chunk on
//       the tensor cores, then g = (exp(z - lse) - onehot) . dl rounded to
//       bf16 into the [rows, V] workspace, W's dtype as at :106;
//   (b) xent_dx_kernel: dx[chunk] = g . W^T, a bf16 tensor-core product with
//       f32 accumulators over the whole vocab inside the block (W read as
//       the col-major B operand), cast to x's dtype at the end (:111).
// With make_g = 0, (b) reads the g that a previous launch left in the
// workspace: the autograd backward forms g once per chunk and hands it to
// both this kernel and xent_bwd_dw.  No atomics: every dx element is
// summed by one block in one order.

#include "xent_common.cuh"

namespace {

using tmx::BM;
using tmx::BN;
using tmx::CP;
using tmx::bf16;

// Grid (ceil(rows / BM), ceil(E / BN)).
__global__ void __launch_bounds__(tmx::NT)
xent_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
               bf16* __restrict__ dx, int rows, int E, int V, bool vg, bool vw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // B[k = v, n = e] = W[e, v]: W is the col-major [E, V] B operand.
  tmx::mma_tile<false, true>(smem, g, V, w, V, rows, E, V, m0, n0, vg, vw);
  const float* cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += tmx::NT) {
    const int r = idx / BN, c = idx % BN, row = m0 + r, col = n0 + c;
    if (row < rows && col < E) dx[(long)row * E + col] = __float2bfloat16(cs[r * CP + c]);
  }
}

}  // namespace

// One chunk: x [rows, E], labels / lse / dl [rows], dx [rows, E] (pointers
// at the chunk's first row), w [E, V], g [rows, V] workspace; bf16 except
// labels (int32) and lse / dl (f32); contiguous, on the device.  make_g: form
// g first (else read the workspace as it is).  Returns the CUDA error code.
extern "C" int tm_xent_bwd_dx(const bf16* x, const bf16* w, const int* labels,
                              const float* lse, const float* dl, bf16* g,
                              bf16* dx, int rows, int E, int V, int make_g,
                              void* stream) {
  if (rows <= 0 || E <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (make_g) {
    e = tmx::launch_grad(x, w, labels, lse, dl, g, rows, E, V, st);
    if (e != cudaSuccess) return (int)e;
  }
  e = tmx::allow_smem(reinterpret_cast<const void*>(xent_dx_kernel));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((rows + BM - 1) / BM, (E + BN - 1) / BN);
  xent_dx_kernel<<<grid, tmx::NT, tmx::SMEM_BYTES, st>>>(
      g, w, dx, rows, E, V, tmx::vec_ok(g, V), tmx::vec_ok(w, V));
  return (int)cudaGetLastError();
}
