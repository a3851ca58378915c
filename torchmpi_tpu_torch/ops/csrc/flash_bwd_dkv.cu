// flash_bwd_dkv: the dK / dV half of the flash-attention backward, f32.
//
// Replaces the TPU kernel _flash_bwd_dkv_kernel (torchmpi_tpu/ops/flash.py:424,
// launched by pallas_call in flash_attention_bwd, :737).
//
//   dv_j = sum_h sum_i p_ij dO_i
//   dk_j = scale * sum_h sum_i p_ij (dO_i . v_j - D_i) q_i
//
// where h runs over the q heads of kv head j's GQA group.  The TPU kernel
// writes one partial per q head and sums the group afterwards; here the
// block loops over the group itself, so the sum happens in registers, with
// no atomics and no [B, H, T, D] partials in memory.
//
// What bounds it: four products of 2 D flops per live (q, k) pair
// (Q K^T, dO V^T, P^T dO, dS^T Q): operations.  f32 FMA on the CUDA cores.
//
// Design: one thread block per (kv block of 64 keys, kv head, batch),
// holding K and V of the block and the dK / dV accumulators (4 keys x D/16
// columns of each per thread).  A loop inside the block walks the group's
// q heads and, per head, the live q blocks of 32 rows (the block_live skip
// of the forward, seen from the key side).  Each step computes S and dP
// (2 x 4 of each per thread), then dv += P^T dO and dk += dS^T Q from one
// shared tile that holds P, then dS.

#include "flash_common.cuh"

namespace {

constexpr int BKV = 64;  // keys per block
constexpr int BQ = 32;   // q rows per inner step

template <int D>
__global__ void __launch_bounds__(tmf::NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq,
                     int Tkv, int H, int Hkv, float scale, tmf::Band band) {
  constexpr int DP = D + 1;
  constexpr int CW = D / 16;
  constexpr int PP = BKV + 1;
  extern __shared__ float smem[];
  float* ks = smem;               // [BKV][DP]
  float* vs = ks + BKV * DP;      // [BKV][DP]
  float* qs = vs + BKV * DP;      // [BQ][DP]
  float* dos = qs + BQ * DP;      // [BQ][DP]
  float* ts = dos + BQ * DP;      // [BQ][PP]: P, then dS
  float* lse_s = ts + BQ * PP;    // [BQ]
  float* dv_s = lse_s + BQ;       // [BQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long kvoff = (long)b * Tkv * kvstride + (long)hk * D;

  tmf::load_rows<D>(ks, DP, k + kvoff, kvstride, k0, BKV, Tkv);
  tmf::load_rows<D>(vs, DP, v + kvoff, kvstride, k0, BKV, Tkv);
  float dk_acc[4][CW], dv_acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int kg0 = band.kv_offset + k0;
  const int nq = (Tq + BQ - 1) / BQ;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const long qoff = (long)b * Tq * qstride + (long)h * D;
    const long srow = ((long)b * H + h) * Tq;
    for (int i0 = 0; i0 < nq; ++i0) {
      const int q0 = i0 * BQ;
      const int qg0 = band.q_offset + q0;
      if (!tmf::block_live(band, qg0, BQ, kg0, BKV)) continue;
      __syncthreads();  // the previous step's readers of qs / dos / ts are done
      tmf::load_rows<D>(qs, DP, q + qoff, qstride, q0, BQ, Tq);
      tmf::load_rows<D>(dos, DP, dout + qoff, qstride, q0, BQ, Tq);
      if (tid < BQ) {
        const bool in = q0 + tid < Tq;
        lse_s[tid] = in ? lse[srow + q0 + tid] : -tmf::NEG_INF;
        dv_s[tid] = in ? dvec[srow + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S[r][c] and dP[r][c] for q rows r = ty + 16 i (i < 2) and keys
      // c = tx + 16 c' (c' < 4) of this block.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[2], dov[2], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          qv[i] = qs[(ty + 16 * i) * DP + d];
          dov[i] = dos[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = ks[(tx + 16 * c) * DP + d];
          vv[c] = vs[(tx + 16 * c) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
            dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
          }
      }
      float ds[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = ty + 16 * i, col = tx + 16 * c;
          const float x = tmf::valid(band, qg0 + r, kg0 + col) ? s[i][c] * scale
                                                                : tmf::NEG_INF;
          const float p = expf(x - lse_s[r]);
          ts[r * PP + col] = p;
          ds[i][c] = p * (dp[i][c] - dv_s[r]);
        }
      __syncthreads();

      // dv[key][col] += sum_r P[r][key] dO[r][col]; keys ty + 16 i (i < 4).
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dov[CW];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ts[r * PP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CW; ++c) dov[c] = dos[r * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c) dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) ts[(ty + 16 * i) * PP + tx + 16 * c] = ds[i][c];
      __syncthreads();

      // dk[key][col] += sum_r dS[r][key] q[r][col].
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float dsv[4], qv[CW];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = ts[r * PP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CW; ++c) qv[c] = qs[r * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c) dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
      }
    }
  }

  float* dkb = dk + kvoff;
  float* dvb = dv + kvoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= Tkv) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      dkb[(long)t * kvstride + tx + 16 * c] = scale * dk_acc[i][c];
      dvb[(long)t * kvstride + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dvec,
                   float* dk, float* dv, int B, int Tq, int Tkv, int H, int Hkv,
                   float scale, tmf::Band band, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * BKV * (D + 1) + 2 * BQ * (D + 1) + BQ * (BKV + 1) + 2 * BQ);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tkv + BKV - 1) / BKV, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, tmf::NT, smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, Tq, Tkv, H, Hkv, scale, band);
  return cudaGetLastError();
}

}  // namespace

// q / dout [B, Tq, H, D], k / v / dk / dv [B, Tkv, Hkv, D],
// lse / dvec [B, H, Tq]; all f32, contiguous, on the device.  Returns the
// launch's CUDA error code.
extern "C" int tm_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                const float* dout, const float* lse,
                                const float* dvec, float* dk, float* dv, int B,
                                int Tq, int Tkv, int H, int Hkv, int D,
                                float scale, int causal, int window,
                                int q_offset, int kv_offset, void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, dout, lse, dvec, dk, dv, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 32: return launch<32>(q, k, v, dout, lse, dvec, dk, dv, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 64: return launch<64>(q, k, v, dout, lse, dvec, dk, dv, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128>(q, k, v, dout, lse, dvec, dk, dv, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
