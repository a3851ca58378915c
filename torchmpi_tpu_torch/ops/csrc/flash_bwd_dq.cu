// flash_bwd_dq: the dQ half of the flash-attention backward, f32.
//
// Replaces the TPU kernel _flash_bwd_dq_kernel (torchmpi_tpu/ops/flash.py:358,
// launched by pallas_call in flash_attention_bwd, :707).
//
//   dq_i = scale * sum_j p_ij (dO_i . v_j - D_i) k_j,   p_ij = exp(s_ij - lse_i)
//
// with p recomputed from the forward's lse and D_i = dO_i . O_i supplied by
// the caller, so the [T, T] probabilities never exist in memory.
//
// What bounds it: three products of 2 D flops per live (q, k) pair (Q K^T,
// dO V^T, dS K) against a few reads per row: operations.  f32 FMA on the
// CUDA cores, as in flash_fwd.cu.
//
// Design: one thread block per (q block of 64 rows, q head, batch); a loop
// inside the block walks the live kv blocks of 32 keys (the same
// block_live skip as the forward) and accumulates dq in registers
// (4 rows x D/16 columns per thread).  Each step computes S and dP together
// (4 x 2 of each per thread), forms dS in shared memory, then dq += dS K.
// Rows past Tq and fully masked rows carry lse = +1e30, so their p is 0.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;

template <int D>
__global__ void __launch_bounds__(tmf::NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, int Tq, int Tkv, int H, int Hkv,
                    float scale, tmf::Band band) {
  constexpr int DP = D + 1;
  constexpr int CW = D / 16;
  constexpr int PP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][DP]
  float* dos = qs + BQ * DP;     // [BQ][DP]
  float* ks = dos + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][DP]
  float* dss = vs + BK * DP;     // [BQ][PP]
  float* lse_s = dss + BQ * PP;  // [BQ]
  float* dv_s = lse_s + BQ;      // [BQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long qoff = (long)b * Tq * qstride + (long)h * D;
  const float* kb = k + (long)b * Tkv * kvstride + (long)hk * D;
  const float* vb = v + (long)b * Tkv * kvstride + (long)hk * D;

  tmf::load_rows<D>(qs, DP, q + qoff, qstride, q0, BQ, Tq);
  tmf::load_rows<D>(dos, DP, dout + qoff, qstride, q0, BQ, Tq);
  if (tid < BQ) {
    const long row = ((long)b * H + h) * Tq + q0 + tid;
    const bool in = q0 + tid < Tq;
    lse_s[tid] = in ? lse[row] : -tmf::NEG_INF;
    dv_s[tid] = in ? dvec[row] : 0.f;
  }
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  __syncthreads();

  const int qg0 = band.q_offset + q0;
  const int nk = (Tkv + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int kg0 = band.kv_offset + j * BK;
    if (!tmf::block_live(band, qg0, BQ, kg0, BK)) continue;
    tmf::load_rows<D>(ks, DP, kb, kvstride, j * BK, BK, Tkv);
    tmf::load_rows<D>(vs, DP, vb, kvstride, j * BK, BK, Tkv);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * DP + d];
        dov[i] = dos[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        kv[c] = ks[(tx + 16 * c) * DP + d];
        vv[c] = vs[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        const float x = tmf::valid(band, qg0 + r, kg0 + col) ? s[i][c] * scale
                                                              : tmf::NEG_INF;
        const float p = expf(x - lse_s[r]);
        dss[r * PP + col] = p * (dp[i][c] - dv_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CW; ++c) kv[c] = ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
    __syncthreads();
  }

  float* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) dqb[(long)t * qstride + tx + 16 * c] = scale * acc[i][c];
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dvec,
                   float* dq, int B, int Tq, int Tkv, int H, int Hkv,
                   float scale, tmf::Band band, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, tmf::NT, smem, stream>>>(
      q, k, v, dout, lse, dvec, dq, Tq, Tkv, H, Hkv, scale, band);
  return cudaGetLastError();
}

}  // namespace

// q / dout / dq [B, Tq, H, D], k / v [B, Tkv, Hkv, D], lse / dvec [B, H, Tq];
// all f32, contiguous, on the device.  Returns the launch's CUDA error code.
extern "C" int tm_flash_bwd_dq(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* dvec, float* dq, int B, int Tq,
                               int Tkv, int H, int Hkv, int D, float scale,
                               int causal, int window, int q_offset,
                               int kv_offset, void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 32: return launch<32>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 64: return launch<64>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
