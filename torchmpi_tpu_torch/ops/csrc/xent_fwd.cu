// xent_fwd: per-token softmax cross-entropy of x . W without the logits in
// device memory; bf16 or float32 operands, f32 loss and lse.
//
// Replaces the TPU kernel _xent_fwd_kernel (torchmpi_tpu/ops/xent.py:35,
// launched by pallas_call in _fused_xent_fwd, :231).
//
// What bounds it: 2 N E V flops of the product against N E + E V bf16
// operands (at N 8188, E 2048, V 32768: 1.1 TFLOP against 168 MB), so it is
// bound by operations; the product runs on the tensor cores, and the
// softmax statistics ride in its epilogue.  On float32 operands the
// three-product form issues 3 x 2 N E V TF32 flops against twice the bytes
// (plus, on wgmma_tf32, the K-major copies: W^T and its lo part, x's lo
// part, 2 E V + N E float32 written and read once), still bound by
// operations.
//
// Design: the TPU walks the vocab blocks of one token block in order on one
// core, carrying (m, l, t) in scratch.  Here blocks own tiles of z = x . W,
// and each writes per-row partials (m, l, t) of its columns: the tile's max
// m, l = sum of exp(z - m) over its columns, and the label's logit t when
// the label's column is among them, else 0 (as at :66-69).  Columns past V
// are masked (:57: NEG_INF, whose exp is 0, so they are left out of m and
// l); a label outside [0, V) never matches (t = 0).  A second, per-row
// kernel merges the partials in column order, so the result does not
// depend on block timing, and writes lse = m + log(max(l, 1e-37)) and loss
// = lse - t (:73-78).
//
// Four routes, chosen by the caller (ops/xent.py _route) from the dtype,
// the shapes and the addresses, never by a failed launch:
//   wgmma (bf16; E and V multiples of 8, x and W 16-byte aligned): one
//     tmw::gemm_kernel per 128 x 256 tile of z (xent_wgmma.cuh: TMA-fed,
//     warp-specialised wgmma.mma_async, A = x K-major, B = W MN-major, the
//     g kernel's product), its accumulators folded in registers by StatEpi:
//     a row's 256 columns sit in the 4 lanes of a quad, so each thread
//     folds its 64 values in a fixed order and two xor shuffles finish the
//     row; one partial per row and 256-column tile, ceil(V / 256) of them.
//     ptxas (the build line of chip_smoke.py, nvcc 12.9): 168 registers a
//     thread at launch and no spills, as the g kernel's.
//   wgmma_tf32 (float32; E and V multiples of 4, x and W 16-byte aligned):
//     one tmw::gemm_tf32_kernel per 128 x 128 tile of z, the float32 g
//     kernel's product (TF32 wgmma in the three-product form on K-major hi
//     and lo tiles, a fresh partial sum every 128 of depth), A = (x, x_lo),
//     B = (W^T, W^T's lo part), copies the wrapper makes per call; its
//     fragment folded by StatF32Epi, StatEpi's fold on 128 columns (32
//     values a thread a row); one partial per row and 128-column tile,
//     ceil(V / 128) of them.
//   wmma (any other bf16 shape): a block of tmx::NT threads owns BM = 128
//     token rows and one of `splits` contiguous runs of vocab tiles (BN =
//     128 columns each), so that N / 128 x splits blocks fill the 132 SMs.
//     Per vocab tile it forms z on the tensor cores into shared memory
//     (mma_tile, xent_common.cuh), then one warp per 16 rows folds the tile
//     into the row's running (m, l, t).
//   tf32x3 (any other float32 shape or address): the wmma route's grid and
//     fold on mma_tile<float>, TF32 fragments in the three-product form.
// A refused route (a TMA route asked for operands it cannot read) returns
// an error: nothing falls back.

#include "xent_wgmma.cuh"

namespace {

using tmx::BM;
using tmx::BN;
using tmx::CP;
using tmx::NEG_INF;
using tmx::bf16;

// part: [3][splits][N] f32 = (m, l, t) of each split.
template <class T>
__global__ void __launch_bounds__(tmx::NT)
xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
    tmx::mma_tile<T, false, false>(smem, x, E, w, V, N, V, E, m0, n0, vx, vw);
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

// The partials of the wgmma routes: (m, l, t) of each row over the block's
// TILE columns, into part[3][nt][N] at tile blockIdx.y, from the consumer
// thread's NACC-register fragment (wgmma_256's layout: d[4 j + 2 h + c] is
// row r0 + 8 h, column c0 + 8 j + c, so a row's TILE columns sit in the 4
// lanes of a quad).  Each thread folds its NACC / 2 values of each of its
// two rows in a fixed order, and two xor shuffles finish the row.  Every
// lane of the warp runs the shuffles (rows past N only skip the store).
// The column mask is tested only in the ragged last tile (`all`: every
// column below V); tested per element in every tile it made the bf16
// forward 14-36% slower on an H100 (scripts/torch_xent_fwd_variants.py).
template <int NACC, int TILE>
struct StatFold {
  const int* labels;
  float* part;
  int N, V, nt;
  __device__ __forceinline__ void operator()(const float (&d)[NACC], int r0,
                                             int c0) const {
    const long o0 = (long)blockIdx.y * N, stride = (long)nt * N;
    const bool all = (int)(blockIdx.y + 1) * TILE <= V;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int lab = row < N ? labels[row] : -1;
      float m = NEG_INF;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = c0 + 8 * j;
        if (all || col < V) m = fmaxf(m, d[4 * j + 2 * h]);
        if (all || col + 1 < V) m = fmaxf(m, d[4 * j + 2 * h + 1]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l = 0.f, t = 0.f;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = c0 + 8 * j;
        if (all || col < V) {
          l += expf(d[4 * j + 2 * h] - m);
          if (lab == col) t = d[4 * j + 2 * h];
        }
        if (all || col + 1 < V) {
          l += expf(d[4 * j + 2 * h + 1] - m);
          if (lab == col + 1) t = d[4 * j + 2 * h + 1];
        }
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      t += __shfl_xor_sync(0xffffffffu, t, 1);  // one lane of the quad holds t
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      if (row < N && (threadIdx.x & 3) == 0) {
        part[o0 + row] = m;
        part[stride + o0 + row] = l;
        part[2 * stride + o0 + row] = t;
      }
    }
  }
};

// The wgmma route's fold: 128 x 256 bf16-product tiles, 128 accumulators a
// consumer thread.
struct StatEpi : StatFold<tmw::ACC, tmw::BN> {};
// The wgmma_tf32 route's fold: 128 x 128 TF32-product tiles, 64.
struct StatF32Epi : StatFold<tmw::TACC, tmw::TBN> {};

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

template <class T>
cudaError_t launch_fwd(const T* x, const T* w, const int* labels, float* part,
                       int N, int E, int V, int splits, cudaStream_t st) {
  cudaError_t e = tmx::allow_smem(reinterpret_cast<const void*>(xent_fwd_kernel<T>));
  if (e != cudaSuccess) return e;
  dim3 grid((N + BM - 1) / BM, splits);
  xent_fwd_kernel<T><<<grid, tmx::NT, tmx::SMEM_BYTES, st>>>(
      x, w, labels, part, N, E, V, splits, tmx::vec_ok(x, E), tmx::vec_ok(w, V));
  return cudaGetLastError();
}

}  // namespace

// x [N, E], w [E, V] of the route's dtype (tmx::Route: 0 wgmma and 1 wmma
// bfloat16, 2 tf32x3 and 3 wgmma_tf32 float32), labels [N] int32, part [3,
// splits, N] f32 (workspace), loss / lse [N] f32; on wgmma_tf32 also the
// K-major copies x_lo [N, E] and wt, wt_lo [V, E] (tm_xent_split makes
// them; w itself is not read there), null on the other routes; all
// contiguous, on the device.  The wgmma route needs E and V multiples of
// 8, x and w 16-byte aligned and splits = ceil(V / 256); wgmma_tf32 needs
// x, x_lo, wt and wt_lo readable by TMA at pitch E (tmw::tma_ok_f32) and
// splits = ceil(V / 128); else the launch is refused.  Returns the CUDA
// error code of the launches (0 on success).
extern "C" int tm_xent_fwd(const void* x, const void* w, const int* labels,
                           float* part, float* loss, float* lse, int N, int E,
                           int V, int splits, int route, const float* x_lo,
                           const float* wt, const float* wt_lo, void* stream) {
  if (N <= 0 || E <= 0 || V <= 0 || splits <= 0 || route < tmx::kWgmma ||
      route > tmx::kWgmmaTf32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == tmx::kTf32x3) {
    e = launch_fwd(static_cast<const float*>(x), static_cast<const float*>(w),
                   labels, part, N, E, V, splits, st);
  } else if (route == tmx::kWgmmaTf32) {
    if (!(tmw::tma_ok_f32(x, E) && tmw::tma_ok_f32(x_lo, E) &&
          tmw::tma_ok_f32(wt, E) && tmw::tma_ok_f32(wt_lo, E)) ||
        splits != (V + tmw::TBN - 1) / tmw::TBN)
      return (int)cudaErrorInvalidValue;
    e = tmw::launch_gemm_tf32(static_cast<const float*>(x), x_lo, E, wt, wt_lo,
                              E, N, V, E,
                              StatF32Epi{{labels, part, N, V, splits}}, st);
  } else if (route == tmx::kWgmma) {
    if (!(tmw::tma_ok(x, E) && tmw::tma_ok(w, V)) ||
        splits != (V + tmw::BN - 1) / tmw::BN)
      return (int)cudaErrorInvalidValue;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    CUtensorMap tx, tw;
    e = tmw::make_map(&tx, xb, N, E);
    if (e == cudaSuccess) e = tmw::make_map(&tw, wb, E, V);
    if (e == cudaSuccess)
      e = tmw::launch_gemm<false, true>(tx, tw, N, V, E,
                                        StatEpi{{labels, part, N, V, splits}}, st);
  } else {
    e = launch_fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   labels, part, N, E, V, splits, st);
  }
  if (e != cudaSuccess) return (int)e;
  xent_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, loss, lse, N, splits);
  return (int)cudaGetLastError();
}
