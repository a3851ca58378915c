// flash_fwd: blocked online-softmax attention forward, f32 in and out, its
// two products on the tensor cores.
//
// Replaces the TPU kernel _flash_kernel (torchmpi_tpu/ops/flash.py:265,
// launched by pallas_call in flash_attention, :599).
//
//   o_i = sum_j softmax_j(masked q_i . k_j * scale) v_j,   lse_i
//
// What bounds it: operations.  Two products of 2 D flops per live (q, k)
// pair (Q K^T, P V), 4 D in all, against reads of q, k, v and writes of o.
//
// Design.  One block of 8 warps per (q block, group of HB q heads of one kv
// head, batch); each warp owns 16 q rows of one head, so a block holds 128
// rows: HB = 4 heads x 32 rows where the GQA group allows it, else 2 x 64
// or 1 x 128 (the launcher picks HB).  Every K / V tile in shared memory
// then serves all HB heads, and the mask and the block skip are the same
// for all of them.  A loop inside the block walks the kv blocks of 64
// keys that hold any valid score (block_live; the live blocks of a band
// are contiguous), which takes the place of the TPU's sequential minor
// grid dimension; a warp whose 16 rows see no valid key in a live block
// skips it (that leaves its m, l and o exactly as they were).  Per block:
//   1. S = Q K^T, [16 rows x 64 keys] a warp, two k-steps at a time on the
//      tensor cores (Q's A fragments and K's B fragments by ldmatrix from
//      swizzled tiles), then summed in f32.
//   2. Scale, and mask only when the warp's block is partial (block_full).
//      Online softmax in registers: a row's 16 scores of a lane reduce in
//      order, then across the quad of lanes that holds the row
//      (__shfl_xor_sync 1, 2), which gives every lane of the quad the same
//      max and sum; o and l are rescaled by alpha = exp(m_old - m_new).
//   3. O += P V: this block's 64 keys summed on the tensor cores, then
//      added to o in f32.  P is used where it is, in S's C fragments: lane
//      (g, t) holds P at keys 2t and 2t + 1 of each 8-key n-tile, and A's
//      k-columns t and t + 4 may stand for any two keys as long as B's
//      k-rows t and t + 4 are read at the same keys.  So k-step kk takes
//      keys 8kk + 2t and 8kk + 2t + 1 from V, and no P moves between lanes
//      or through shared memory.  The V tile's swizzle (kRows2T) keeps
//      those reads of rows 2t / 2t + 1 on 32 distinct banks.
// Every product is mma.sync m16n8k8 TF32 in the three-product form (mma3,
// flash_common.cuh), each operand split as its fragment is loaded.  Beside
// the mma.sync passes, the splits and the fragment loads' addresses are
// most of what a warp issues, so both are kept short: the split is
// kTruncate (one logical op and one add an element, where cvt.rna adds a
// compare and a select), and the loads from the swizzled tiles add
// compile-time constants to per-lane offsets (Offs2T), so the loops
// compute no swizzle.  Q is copied once a block and
// the K / V tiles of the next live kv block with cp.async into the other
// of two stages while the current one computes.  Same inputs, same order
// of operations: two calls give the same bits.  Fully masked rows give
// o = 0 and lse = +1e30, as on the TPU.
//
// The epilogue divides o by l and writes lse = m + log(l); the residual
// form ring attention needs (the un-normalized o, m and l) would store the
// same three register sets before that division.
//
// Resources at D 128: 192 KB of shared memory (Q 64 KB, two stages of K
// and V 128 KB), so one block of 8 warps an SM; 255 registers a thread, no
// spills (ptxas, the `build` line of chip_smoke.py; PERF.md).

#include "flash_common.cuh"

namespace {

using tmf::FragA;
using tmf::FragB;
using tmf::kRows2T;
using tmf::kTruncate;

constexpr int NWARP = tmf::NT / 32;  // 8
constexpr int ROWS = 16 * NWARP;     // q rows a block: HB heads x BQ rows
constexpr int BK = 64;               // keys a kv block

template <int D>
struct Smem {
  static constexpr int P = tmf::pitch<D>();
  static constexpr int qTile = ROWS * P, kTile = BK * P;
  // qs [ROWS][P] (head-major: HB heads of BQ rows); ks, vs [2 stages][BK][P].
  static constexpr size_t bytes = sizeof(float) * (qTile + 4 * kTile);
};

template <int D>
__global__ void __launch_bounds__(tmf::NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tkv, int H, int Hkv,
                 int hb, float scale, tmf::Band band) {
  using S = Smem<D>;
  constexpr int NT8 = D / 8;   // 8-column n-tiles of o
  constexpr int NK8 = BK / 8;  // 8-key n-tiles of S, k-steps of P V
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + S::qTile;      // [2][kTile]
  float* vs = ks + 2 * S::kTile;  // [2][kTile]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;    // mma fragment coordinates
  const int bq = ROWS / hb;                // q rows a head
  const int q0 = blockIdx.x * bq, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int hk = h0 / (H / Hkv);
  const int h = h0 + warp / (NWARP / hb);     // this warp's head
  const int wr = (warp % (NWARP / hb)) * 16;  // its first row in the q block
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long kvoff = (long)b * Tkv * kvstride + (long)hk * D;
  const int qg0 = band.q_offset + q0;

  // The live kv blocks of this q block: a contiguous range [jlo, jhi).
  const int nk = (Tkv + BK - 1) / BK;
  int jlo = nk, jhi = nk;
  for (int j = 0; j < nk; ++j) {
    if (tmf::block_live(band, qg0, bq, band.kv_offset + j * BK, BK)) {
      if (jlo == nk) jlo = j;
      jhi = j + 1;
    }
  }

  auto issue_kv = [&](int j, int st) {
    tmf::load_tile<D, kRows2T>(ks + st * S::kTile, k + kvoff, kvstride,
                               j * BK, BK, Tkv);
    tmf::load_tile<D, kRows2T>(vs + st * S::kTile, v + kvoff, kvstride,
                               j * BK, BK, Tkv);
  };
  for (int i = 0; i < hb; ++i)
    tmf::load_tile<D, kRows2T>(qs + i * bq * S::P,
                               q + (long)b * Tq * qstride + (long)(h0 + i) * D,
                               qstride, q0, bq, Tq);
  if (jlo < jhi) issue_kv(jlo, 0);
  tmf::cp_async_commit();

  // Rows g and g + 8 of the warp: running max, denominator, and o.
  float m[2] = {tmf::NEG_INF, tmf::NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float* qw = qs + 16 * warp * S::P;  // the warp's 16 rows of Q
  const tmf::Offs2T<D> off(lane);
  for (int j = jlo; j < jhi; ++j) {
    const int st = (j - jlo) & 1;
    if (j + 1 < jhi) issue_kv(j + 1, st ^ 1);
    tmf::cp_async_commit();
    tmf::cp_async_wait<1>();  // this thread's copies of block j have landed
    __syncthreads();          // and everyone's

    const float* kst = ks + st * S::kTile;
    const float* vst = vs + st * S::kTile;
    const int kg0 = band.kv_offset + j * BK;
    if (tmf::block_live(band, qg0 + wr, 16, kg0, BK)) {
      // 1. S = Q K^T.
      float s[NK8][4];
      tmf::product_abt<D, NK8>(s, qw, kst, off);

      // 2. Element e of n-tile n sits at row wr + g (+ 8 for e >= 2), key
      // 8 n + 2 t (+ 1 for odd e).  Scale, mask, online softmax.
      const bool full = tmf::block_full(band, qg0 + wr, 16, kg0, BK);
      float mx[2] = {tmf::NEG_INF, tmf::NEG_INF};
#pragma unroll
      for (int n = 0; n < NK8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (!full && !tmf::valid(band, qg0 + wr + g + (e >= 2 ? 8 : 0),
                                   kg0 + 8 * n + 2 * t + (e & 1)))
            x = tmf::NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], msafe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // Rows masked so far keep m == NEG_INF: exponentiate against 0 so
        // their p is exp(NEG_INF) == 0, never exp(0) == 1.
        msafe[i] = m_new > 0.5f * tmf::NEG_INF ? m_new : 0.f;
        alpha[i] = expf(m[i] - msafe[i]);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NK8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - msafe[e >> 1]);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = alpha[i] * l[i] + sum[i];
      }

      // 3. O = alpha O + P V, this block's part summed on the tensor cores.
      float part[NT8][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK8; ++kk) {
        const float x[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        FragA a;
        a.set<kTruncate>(x);
        const float* vk = vst + 8 * kk * S::P;
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          FragB bv;
          bv.set<kTruncate>(vk[off.v0[n % 4] + 32 * (n / 4)],
                            vk[off.v1[n % 4] + 32 * (n / 4)]);
          tmf::mma3(part[n], a, bv);
        }
      }
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = alpha[e >> 1] * acc[n][e] + part[n][e];
    }
    __syncthreads();  // stage st is free again
  }
  tmf::cp_async_wait<0>();

  // Epilogue: o = acc / l, lse = m + log(l); a row with no valid key has
  // l == 0 and gets o = 0 and lse = +1e30.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tq) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    float* orow = o + ((long)b * Tq + row) * qstride + (long)h * D;
#pragma unroll
    for (int n = 0; n < NT8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    if (t == 0)
      lse[((long)b * H + h) * Tq + row] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : -tmf::NEG_INF;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int Tq, int Tkv, int H, int Hkv,
                   float scale, tmf::Band band, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int group = H / Hkv;
  const int hb = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
  const int bq = ROWS / hb;
  dim3 grid((Tq + bq - 1) / bq, H / hb, B);
  flash_fwd_kernel<D><<<grid, tmf::NT, smem, stream>>>(
      q, k, v, o, lse, Tq, Tkv, H, Hkv, hb, scale, band);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tkv, Hkv, D], o [B, Tq, H, D], lse [B, H, Tq];
// all f32, contiguous, on the device, q / k / v 16-byte aligned.  window
// <= 0 means no window.  Returns the CUDA error code of the launch (0 on
// success).
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
