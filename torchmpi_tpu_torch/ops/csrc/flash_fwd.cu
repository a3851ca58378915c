// flash_fwd: blocked online-softmax attention forward, f32 in, f32 out.
//
// Replaces the TPU kernel _flash_kernel (torchmpi_tpu/ops/flash.py:265,
// launched by pallas_call in flash_attention, :599).
//
// What bounds it: at the training shapes (T 2048, window 1024, D 128) the
// work is ~4 D flops per live (q, k) pair against ~2 reads of q and o per
// row, so it is bound by operations, not bytes.  The inputs are f32 (the
// model casts q/k/v to f32 before attention), so this first version does
// f32 FMA on the CUDA cores with register tiles fed from shared memory;
// tensor cores (TF32 or bf16 wgmma) are a later change of design.
//
// Design: one thread block per (q block of 64 rows, q head, batch).  A loop
// inside the block walks the kv blocks of 32 keys that hold any valid score
// (block_live), which takes the place of the TPU's sequential minor grid
// dimension; dead blocks outside the causal / window band cost one test.
// Each live block: S = Q K^T (4 x 2 scores per thread), scale and mask,
// online softmax per row (one warp per 8 rows, one lane per key), then
// acc = alpha * acc + P V (4 rows x D/16 columns per thread).  GQA: q head
// h reads kv head h / (H / Hkv) straight from the Hkv-headed tensors.
// Fully masked rows give o = 0 and lse = +1e30, as on the TPU.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 32;  // keys per inner step (one per lane)

template <int D>
__global__ void __launch_bounds__(tmf::NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tkv, int H, int Hkv,
                 float scale, tmf::Band band) {
  constexpr int DP = D + 1;  // padded pitch: column reads hit distinct banks
  constexpr int CW = D / 16;
  constexpr int PP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][DP]
  float* ks = qs + BQ * DP;      // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][D]
  float* ps = vs + BK * D;       // [BQ][PP] scores, then probabilities
  float* m_s = ps + BQ * PP;     // [BQ] running max
  float* l_s = m_s + BQ;         // [BQ] running denominator
  float* a_s = l_s + BQ;         // [BQ] rescale of this step

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const float* qb = q + (long)b * Tq * qstride + (long)h * D;
  const float* kb = k + (long)b * Tkv * kvstride + (long)hk * D;
  const float* vb = v + (long)b * Tkv * kvstride + (long)hk * D;

  tmf::load_rows<D>(qs, DP, qb, qstride, q0, BQ, Tq);
  if (tid < BQ) {
    m_s[tid] = tmf::NEG_INF;
    l_s[tid] = 0.f;
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
    tmf::load_rows<D>(vs, D, vb, kvstride, j * BK, BK, Tkv);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int c = 0; c < 2; ++c) kv[c] = ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        const float x = s[i][c] * scale;
        ps[r * PP + col] = tmf::valid(band, qg0 + r, kg0 + col) ? x : tmf::NEG_INF;
      }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, lane = key.
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float x = ps[r * PP + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tmf::warp_max(x));
      // Rows masked so far keep m == NEG_INF: exponentiate against 0 so
      // their p is exp(NEG_INF) == 0, never exp(0) == 1.
      const float m_safe = m_new > 0.5f * tmf::NEG_INF ? m_new : 0.f;
      const float p = expf(x - m_safe);
      ps[r * PP + lane] = p;
      const float sum = tmf::warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CW; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // ks / vs / ps are overwritten by the next step
  }

  float* ob = o + (long)b * Tq * qstride + (long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= Tq) continue;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) ob[(long)t * qstride + tx + 16 * c] = acc[i][c] / denom;
  }
  if (tid < BQ && q0 + tid < Tq) {
    const float l = l_s[tid];
    lse[((long)b * H + h) * Tq + q0 + tid] =
        l > 0.f ? m_s[tid] + logf(fmaxf(l, 1e-37f)) : -tmf::NEG_INF;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int Tq, int Tkv, int H, int Hkv,
                   float scale, tmf::Band band, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, tmf::NT, smem, stream>>>(q, k, v, o, lse, Tq, Tkv,
                                                       H, Hkv, scale, band);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tkv, Hkv, D], o [B, Tq, H, D], lse [B, H, Tq];
// all f32, contiguous, on the device.  window <= 0 means no window.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int tm_flash_fwd(const float* q, const float* k, const float* v,
                            float* o, float* lse, int B, int Tq, int Tkv, int H,
                            int Hkv, int D, float scale, int causal, int window,
                            int q_offset, int kv_offset, void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 32: return launch<32>(q, k, v, o, lse, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 64: return launch<64>(q, k, v, o, lse, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128>(q, k, v, o, lse, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
