// flash_fwd: blocked online-softmax attention forward, its two products on
// the tensor cores; f32 or bf16 operands (two routes, one kernel).
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
// The epilogue is a compile-time choice.  The plain form divides o by l and
// writes lse = m + log(l).  The residual form (RES; the launcher
// tm_flash_fwd_residual, JAX's return_residuals=True, which each step of
// ring attention runs) stores the same three register sets before that
// division: the un-normalized o as num [B, Tq, H, D] and m and l as
// [B, H, Tq], all f32.  A row with no valid key keeps its initial m =
// NEG_INF, l = 0 and num = 0, as the TPU kernel's do.  One main loop
// serves both forms.
//
// Resources at D 128: 192 KB of shared memory (Q 64 KB, two stages of K
// and V 128 KB), so one block of 8 warps an SM; 255 registers a thread, no
// spills (ptxas, the `build` line of chip_smoke.py; PERF.md).
//
// The bf16 route (BF; tm_flash_fwd_bf16, tm_flash_fwd_residual_bf16): the
// same blocks, warps, band and epilogues on bf16 tiles (96 KB at D 128).
// S = Q K^T is one m16n8k16 bf16 product a k-step (Q's A and K's B
// fragments by ldmatrix), P = exp(S - m) in f32 with l summed from the
// f32 P, and P V takes P rounded to bf16 (JAX :321) from S's C fragments
// as they are (m16n8k16's A pairs are the C fragment's pairs) against V's
// B fragments by transposed ldmatrix, accumulated into o in f32.  o is
// stored in bf16 (JAX :346, :355); the residual form's num, m and l stay
// f32 (JAX :590).  What bounds it: operations, at the bf16 tensor-core
// rate.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using tmf::FragA;
using tmf::FragB;
using tmf::kRows2T;
using tmf::kTruncate;

constexpr int NWARP = tmf::NT / 32;  // 8
constexpr int ROWS = 16 * NWARP;     // q rows a block: HB heads x BQ rows
constexpr int BK = 64;               // keys a kv block

// The operand type of a route, and the output type of its plain epilogue.
template <bool BF>
using In = std::conditional_t<BF, tmf::bf16, float>;
template <bool BF, bool RES>
using Out = std::conditional_t<BF && !RES, tmf::bf16, float>;

template <int D, bool BF>
struct Smem {
  static constexpr int P = BF ? tmf::pitch_bf<D>() : tmf::pitch<D>();
  static constexpr int qTile = ROWS * P, kTile = BK * P;
  // qs [ROWS][P] (head-major: HB heads of BQ rows); ks, vs [2 stages][BK][P].
  static constexpr size_t bytes = sizeof(In<BF>) * (qTile + 4 * kTile);
};

// o: the output (RES: num).  st0: lse (RES: m).  st1: unused (RES: l).
template <int D, bool RES, bool BF>
__global__ void __launch_bounds__(tmf::NT)
flash_fwd_kernel(const In<BF>* __restrict__ q, const In<BF>* __restrict__ k,
                 const In<BF>* __restrict__ v, Out<BF, RES>* __restrict__ o,
                 float* __restrict__ st0, float* __restrict__ st1, int Tq,
                 int Tkv, int H, int Hkv, int hb, float scale,
                 tmf::Band band) {
  using S = Smem<D, BF>;
  using T = In<BF>;
  constexpr int NT8 = D / 8;   // 8-column n-tiles of o
  constexpr int NK8 = BK / 8;  // 8-key n-tiles of S, k-steps of P V
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + S::qTile;      // [2][kTile]
  T* vs = ks + 2 * S::kTile;  // [2][kTile]

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
    tmf::load_in<D, kRows2T>(ks + st * S::kTile, k + kvoff, kvstride, j * BK,
                             BK, Tkv);
    tmf::load_in<D, kRows2T>(vs + st * S::kTile, v + kvoff, kvstride, j * BK,
                             BK, Tkv);
  };
  for (int i = 0; i < hb; ++i)
    tmf::load_in<D, kRows2T>(qs + i * bq * S::P,
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

  const T* qw = qs + 16 * warp * S::P;  // the warp's 16 rows of Q
  const tmf::Offs2T<D> off(lane);
  for (int j = jlo; j < jhi; ++j) {
    const int st = (j - jlo) & 1;
    if (j + 1 < jhi) issue_kv(j + 1, st ^ 1);
    tmf::cp_async_commit();
    tmf::cp_async_wait<1>();  // this thread's copies of block j have landed
    __syncthreads();          // and everyone's

    const T* kst = ks + st * S::kTile;
    const T* vst = vs + st * S::kTile;
    const int kg0 = band.kv_offset + j * BK;
    if (tmf::block_live(band, qg0 + wr, 16, kg0, BK)) {
      // 1. S = Q K^T.
      float s[NK8][4];
      if constexpr (BF)
        tmf::product_abt_bf<D, NK8>(s, qs, 16 * warp, kst, lane);
      else
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
      if constexpr (BF) {
        // P rounded to bf16 (JAX :321), accumulated into o in f32.
#pragma unroll
        for (int n = 0; n < NT8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
        for (int kk = 0; kk < NK8 / 2; ++kk) {
          unsigned a[4];
          tmf::c_as_a_bf<NK8>(a, s, kk);
#pragma unroll
          for (int np = 0; np < NT8 / 2; ++np) {
            unsigned fb[4];
            tmf::ldbt_bf<D>(fb, vst, 16 * kk, 16 * np, lane);
            tmf::mma_bf16(acc[2 * np], a, fb[0], fb[1]);
            tmf::mma_bf16(acc[2 * np + 1], a, fb[2], fb[3]);
          }
        }
      } else {
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
    }
    __syncthreads();  // stage st is free again
  }
  tmf::cp_async_wait<0>();

  // Epilogue.  Plain: o = acc / l, lse = m + log(l); a row with no valid
  // key has l == 0 and gets o = 0 and lse = +1e30.  Residual: acc, m and l
  // as they are.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tq) continue;
    const float denom = RES ? 1.f : (l[i] > 0.f ? l[i] : 1.f);
    Out<BF, RES>* orow = o + ((long)b * Tq + row) * qstride + (long)h * D;
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const float2 x = RES ? make_float2(acc[n][2 * i], acc[n][2 * i + 1])
                           : make_float2(acc[n][2 * i] / denom,
                                         acc[n][2 * i + 1] / denom);
      if constexpr (BF && !RES)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
            __floats2bfloat162_rn(x.x, x.y);
      else
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = x;
    }
    if (t == 0) {
      const long srow = ((long)b * H + h) * Tq + row;
      if (RES) {
        st0[srow] = m[i];
        st1[srow] = l[i];
      } else {
        st0[srow] =
            l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : -tmf::NEG_INF;
      }
    }
  }
}

template <int D, bool RES, bool BF>
cudaError_t launch(const In<BF>* q, const In<BF>* k, const In<BF>* v,
                   Out<BF, RES>* o, float* st0, float* st1, int B, int Tq,
                   int Tkv, int H, int Hkv, float scale, tmf::Band band,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<D, BF>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, RES, BF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int group = H / Hkv;
  const int hb = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
  const int bq = ROWS / hb;
  dim3 grid((Tq + bq - 1) / bq, H / hb, B);
  flash_fwd_kernel<D, RES, BF><<<grid, tmf::NT, smem, stream>>>(
      q, k, v, o, st0, st1, Tq, Tkv, H, Hkv, hb, scale, band);
  return cudaGetLastError();
}

template <bool RES, bool BF>
int dispatch(const void* qp, const void* kp, const void* vp, void* op,
             float* st0, float* st1, int B, int Tq, int Tkv, int H, int Hkv,
             int D, float scale, int causal, int window, int q_offset,
             int kv_offset, void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const In<BF>*>(qp);
  const auto* k = static_cast<const In<BF>*>(kp);
  const auto* v = static_cast<const In<BF>*>(vp);
  auto* o = static_cast<Out<BF, RES>*>(op);
  switch (D) {
    case 16: return launch<16, RES, BF>(q, k, v, o, st0, st1, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 32: return launch<32, RES, BF>(q, k, v, o, st0, st1, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 64: return launch<64, RES, BF>(q, k, v, o, st0, st1, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128, RES, BF>(q, k, v, o, st0, st1, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  return dispatch<false, false>(q, k, v, o, lse, nullptr, B, Tq, Tkv, H,
                                Hkv, D, scale, causal, window, q_offset,
                                kv_offset, stream);
}

// The residual form: num [B, Tq, H, D] (o before the division by l), m and
// l [B, H, Tq]; the other arguments as tm_flash_fwd's.
extern "C" int tm_flash_fwd_residual(const float* q, const float* k,
                                     const float* v, float* num, float* m,
                                     float* l, int B, int Tq, int Tkv, int H,
                                     int Hkv, int D, float scale, int causal,
                                     int window, int q_offset, int kv_offset,
                                     void* stream) {
  return dispatch<true, false>(q, k, v, num, m, l, B, Tq, Tkv, H, Hkv, D,
                               scale, causal, window, q_offset, kv_offset,
                               stream);
}

// The bf16 route: q / k / v and o bf16, lse f32; the other arguments as
// tm_flash_fwd's.
extern "C" int tm_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int Tq, int Tkv,
                                 int H, int Hkv, int D, float scale, int causal,
                                 int window, int q_offset, int kv_offset,
                                 void* stream) {
  return dispatch<false, true>(q, k, v, o, lse, nullptr, B, Tq, Tkv, H, Hkv,
                               D, scale, causal, window, q_offset, kv_offset,
                               stream);
}

// The bf16 route of the residual form: q / k / v bf16; num, m and l f32.
extern "C" int tm_flash_fwd_residual_bf16(const void* q, const void* k,
                                          const void* v, float* num, float* m,
                                          float* l, int B, int Tq, int Tkv,
                                          int H, int Hkv, int D, float scale,
                                          int causal, int window, int q_offset,
                                          int kv_offset, void* stream) {
  return dispatch<true, true>(q, k, v, num, m, l, B, Tq, Tkv, H, Hkv, D,
                              scale, causal, window, q_offset, kv_offset,
                              stream);
}
