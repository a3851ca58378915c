// xent_fwd: per-token softmax cross-entropy of x . W without the logits in
// device memory; bf16 operands, f32 loss and lse.
//
// Replaces the TPU kernel _xent_fwd_kernel (torchmpi_tpu/ops/xent.py:35,
// launched by pallas_call in _fused_xent_fwd, :231).
//
// What bounds it: 2 N E V flops of the product against N E + E V bf16
// operands (at N 8188, E 2048, V 32768: 1.1 TFLOP against 168 MB), so it is
// bound by operations; the product runs on the tensor cores (mma_tile in
// xent_common.cuh), and the softmax statistics ride in its epilogue.
//
// Design: the TPU walks the vocab blocks of one token block in order on one
// core, carrying (m, l, t) in scratch.  Here a block owns BM = 128 token rows
// and one of `splits` contiguous runs of vocab tiles (BN = 128 columns each),
// so that N / 128 x splits blocks fill the 132 SMs.  Per vocab tile it forms
// z = x . W on the tensor cores into shared memory, then one warp per 16 rows
// folds the tile into the row's running max m, denominator l, and label logit
// t (picked up when the label's column passes, as at :69-72).  Columns past V
// are masked to NEG_INF (:57); a label outside [0, V) never matches (t = 0).
// Each block writes its partial (m, l, t); a second, per-row kernel merges
// the splits in order, so the result does not depend on block timing, and
// writes lse = m + log(max(l, 1e-37)) and loss = lse - t (:76-78).

#include "xent_common.cuh"

namespace {

using tmx::BM;
using tmx::BN;
using tmx::CP;
using tmx::NEG_INF;
using tmx::bf16;

// part: [3][splits][N] f32 = (m, l, t) of each split.
__global__ void __launch_bounds__(tmx::NT)
xent_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ part, int N,
                int E, int V, int splits, bool vx, bool vw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* cs = reinterpret_cast<const float*>(smem);
  float* m_s = reinterpret_cast<float*>(smem) + BM * CP;
  float* l_s = m_s + BM;
  float* t_s = l_s + BM;
  int* lab_s = reinterpret_cast<int*>(t_s + BM);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, s = blockIdx.y;
  const int nt = (V + BN - 1) / BN, per = (nt + splits - 1) / splits;
  const int j0 = s * per, j1 = min(nt, j0 + per);
  if (tid < BM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    t_s[tid] = 0.f;
    lab_s[tid] = m0 + tid < N ? labels[m0 + tid] : -1;
  }
  // (the first mma_tile's trailing __syncthreads publishes these)

  for (int j = j0; j < j1; ++j) {
    const int n0 = j * BN;
    tmx::mma_tile<false, false>(smem, x, E, w, V, N, V, E, m0, n0, vx, vw);
    for (int rr = 0; rr < BM / 8; ++rr) {  // warp `warp` owns 16 rows
      const int r = warp * (BM / 8) + rr;
      float z[BN / 32];
      float zmax = NEG_INF;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        const int c = lane + 32 * q;
        z[q] = n0 + c < V ? cs[r * CP + c] : NEG_INF;
        zmax = fmaxf(zmax, z[q]);
      }
      zmax = tmx::warp_max(zmax);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, zmax);
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) sum += expf(z[q] - m_new);
      sum = tmx::warp_sum(sum);  // every lane has read m_s[r] by here
      if (lane == 0) {
        const int lab = lab_s[r];
        if (lab >= n0 && lab < n0 + BN && lab < V) t_s[r] += cs[r * CP + lab - n0];
        l_s[r] = l_s[r] * expf(m_prev - m_new) + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // the next tile's operands overwrite cs
  }
  if (tid < BM && m0 + tid < N) {
    const long o = (long)s * N + m0 + tid, stride = (long)splits * N;
    part[o] = m_s[tid];
    part[stride + o] = l_s[tid];
    part[2 * stride + o] = t_s[tid];
  }
}

__global__ void xent_fwd_merge_kernel(const float* __restrict__ part,
                                      float* __restrict__ loss,
                                      float* __restrict__ lse, int N,
                                      int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long stride = (long)splits * N;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[(long)s * N + row]);
  float l = 0.f, t = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long o = (long)s * N + row;
    l += part[stride + o] * expf(part[o] - m);
    t += part[2 * stride + o];
  }
  const float ls = m + logf(fmaxf(l, 1e-37f));
  lse[row] = ls;
  loss[row] = ls - t;
}

}  // namespace

// x [N, E] bf16, w [E, V] bf16, labels [N] int32, part [3, splits, N] f32
// (workspace), loss / lse [N] f32; all contiguous, on the device.  Returns
// the CUDA error code of the launches (0 on success).
extern "C" int tm_xent_fwd(const bf16* x, const bf16* w, const int* labels,
                           float* part, float* loss, float* lse, int N, int E,
                           int V, int splits, void* stream) {
  if (N <= 0 || V <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = tmx::allow_smem(reinterpret_cast<const void*>(xent_fwd_kernel));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BM - 1) / BM, splits);
  xent_fwd_kernel<<<grid, tmx::NT, tmx::SMEM_BYTES, st>>>(
      x, w, labels, part, N, E, V, splits, tmx::vec_ok(x, E), tmx::vec_ok(w, V));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  xent_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, loss, lse, N, splits);
  return (int)cudaGetLastError();
}
