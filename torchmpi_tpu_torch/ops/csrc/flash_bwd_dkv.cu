// flash_bwd_dkv: the dK / dV half of the flash-attention backward, f32 in
// and out, its four products on the tensor cores.
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
// What bounds it: operations.  Four products of 2 D flops per live (q, k)
// pair (K Q^T, V dO^T, P^T dO, dS^T Q), 8 D in all.
//
// Design.  One block of 8 warps per (kv block of 64 keys, kv head, batch).
// A loop inside the block walks the group's q heads and, per head, the
// live q blocks of 32 rows (the forward's block_live, seen from the key
// side; the live blocks of a band are contiguous).  Per q block:
//   1. S^T = K Q^T and dP^T = V dO^T, [64 keys x 32 rows], contracted over
//      D: warps 0-3 compute S^T, warps 4-7 dP^T, one 16-key m-tile each
//      over all 32 rows.  The S warps turn S into P = exp(S scale - lse),
//      masking only when the block is partial (block_full, JAX's
//      _block_full); P^T and dP^T go to two shared tiles.
//   2. dV += P^T dO and dK += dS^T Q, [64 keys x D], contracted over the 32
//      rows, dS = P (dP - D) formed as the A operand is loaded.  Each warp
//      owns a [16 MT keys x 8 NTL columns] tile of both sums, kept in
//      registers until the block stores them.
// Every product is mma.sync m16n8k8 in TF32 in the error-compensated
// three-product form: x = x_hi + x_lo with x_hi = tf32(x) (round to
// nearest) and x_lo = x - x_hi (the mma reads its top 19 bits), and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, so the result keeps f32's
// accuracy (TF32 alone keeps ~3 digits; the kernel is held to 1e-4 of the
// f32 plain version).  The split (kNearest; split, FragA / FragB and mma3
// live in flash_common.cuh) is made as each fragment is loaded.  The
// tensor cores' f32 accumulation does not round to nearest, and a long sum
// kept in an mma accumulator drifts (to 4e-5 of the result at the
// flagship's shapes), so they sum only short runs, two k-steps (16 terms)
// in step 1 and one q block's 32 rows in step 2, and the long sums across
// k-steps and q blocks are f32 adds on the CUDA cores.  Q, dO, lse and D of
// the next live q block are copied with cp.async into the other of two
// stages while the current one computes.  K, V, Q and dO sit in shared
// memory with rows swizzled in 16-byte groups (swz), so that both fragment
// patterns, rows across the lanes' groups and rows across the lanes within
// a group, hit 32 banks; the P^T / dP^T tiles are padded to a pitch of 36.
// Fragments whose rows run across the lanes' groups load with ldmatrix.
// Where one key holds more than half of a q row's probability (P > 1/2, at
// most one key a row), dP - D cancels: D is then mostly that same dP, and
// dS is set by the rounding of dP.  The kernel evaluates that one dP again
// as an f32 FMA chain over d in order, the order of the f32 plain
// version's matmul, so the two agree there too (on the diagonal of a
// window of 1, every dK is that rounding).  It costs a block nothing when
// no row of its q block has such a key.
// Same inputs, same order of operations: two calls give the same bits.
//
// Above its bound (PERF.md): it issues three mma.sync passes and the
// splits, loads and exp between them from one block of 8 warps per SM
// (150 KB of shared memory at D 128).

#include "flash_common.cuh"

namespace {

using tmf::cp_async4;
using tmf::cp_async_commit;
using tmf::cp_async_wait;
using tmf::FragA;
using tmf::FragB;
using tmf::ldsm4;
using tmf::load_tile;
using tmf::mma3;
using tmf::pitch;
using tmf::swz;

constexpr int BKV = 64;                 // keys per block
constexpr int BQ = 32;                  // q rows per inner step
constexpr int NWARP = tmf::NT / 32;     // 8
constexpr int TP = BQ + 4;              // pitch of the P^T / dP^T tiles

template <int D>
struct Smem {
  static constexpr int P = pitch<D>();
  static constexpr int kTile = BKV * P, qTile = BQ * P, pTile = BKV * TP;
  // ks, vs [BKV][P]; qs, dos [2 stages][BQ][P]; pt, dpt [BKV][TP];
  // lse, dvec [2 stages][BQ].
  static constexpr int floats = 2 * kTile + 4 * qTile + 2 * pTile + 4 * BQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int D>
__global__ void __launch_bounds__(tmf::NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq,
                     int Tkv, int H, int Hkv, float scale, tmf::Band band) {
  using S = Smem<D>;
  // Phase 2's warp grid: WR x WC warps over [64 keys] x [D columns].
  constexpr int WC = D / 8 < 4 ? D / 8 : 4;
  constexpr int WR = NWARP / WC;
  constexpr int MT = BKV / 16 / WR;  // 16-key m-tiles a warp
  constexpr int NTL = D / 8 / WC;    // 8-column n-tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + S::kTile;
  float* qs = vs + S::kTile;         // [2][qTile]
  float* dos = qs + 2 * S::qTile;    // [2][qTile]
  float* pt = dos + 2 * S::qTile;    // P^T [BKV][TP]
  float* dpt = pt + S::pTile;        // dP^T [BKV][TP]
  float* lse_s = dpt + S::pTile;     // [2][BQ]
  float* dv_s = lse_s + 2 * BQ;      // [2][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int li = lane % 8, lj = lane / 8;  // ldmatrix row and block
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long kvoff = (long)b * Tkv * kvstride + (long)hk * D;
  const int kg0 = band.kv_offset + k0;

  // The live q blocks of this kv block: a contiguous range [ilo, ihi).
  const int nq = (Tq + BQ - 1) / BQ;
  int ilo = nq, ihi = nq;
  for (int i = 0; i < nq; ++i) {
    if (tmf::block_live(band, band.q_offset + i * BQ, BQ, kg0, BKV)) {
      if (ilo == nq) ilo = i;
      ihi = i + 1;
    }
  }
  const int nlive = ihi - ilo;
  const int items = group * nlive;

  // Q, dO, lse and D of item it (q head, q block) into stage st.
  auto issue = [&](int it, int st) {
    const int h = hk * group + it / nlive;
    const int q0 = (ilo + it % nlive) * BQ;
    const long qoff = (long)b * Tq * qstride + (long)h * D;
    load_tile<D>(qs + st * S::qTile, q + qoff, qstride, q0, BQ, Tq);
    load_tile<D>(dos + st * S::qTile, dout + qoff, qstride, q0, BQ, Tq);
    const long srow = ((long)b * H + h) * Tq + q0;
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool is_lse = tid < BQ;
      float* dst = (is_lse ? lse_s : dv_s) + st * BQ + r;
      if (q0 + r < Tq)
        cp_async4(dst, (is_lse ? lse : dvec) + srow + r);
      else
        *dst = is_lse ? -tmf::NEG_INF : 0.f;  // a row past Tq: p = 0
    }
  };

  load_tile<D>(ks, k + kvoff, kvstride, k0, BKV, Tkv);
  load_tile<D>(vs, v + kvoff, kvstride, k0, BKV, Tkv);
  if (items > 0) issue(0, 0);
  cp_async_commit();

  float acc_dk[MT][NTL][4], acc_dv[MT][NTL][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dk[m][n][e] = acc_dv[m][n][e] = 0.f;

  // Phase 1's roles: S^T (warps 0-3) or dP^T (4-7), keys 16 m1 .. + 16.
  const bool is_s = warp < 4;
  const int m1 = warp & 3;
  const float* a1 = is_s ? ks : vs;
  // Phase 2's tile: keys 16 (wr MT + m) + ..., columns 8 (wc NTL + n) + ....
  const int wr = warp / WC, wc = warp % WC;

  for (int it = 0; it < items; ++it) {
    const int st = it & 1;
    if (it + 1 < items) issue(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of item it have landed
    __syncthreads();     // and everyone's

    const float* qst = qs + st * S::qTile;
    const float* dost = dos + st * S::qTile;
    const float* b1 = is_s ? qst : dost;
    const int q0 = (ilo + it % nlive) * BQ;
    const int qg0 = band.q_offset + q0;

    // 1. [16 keys x 32 rows] of S^T or dP^T, two k-steps at a time on the
    // tensor cores.  ldmatrix blocks: A's rows 0-7 / 8-15 by columns 0-3 /
    // 4-7; B's rows (q) of n-tiles n / n + 1 by columns 0-3 / 4-7.
    float c1[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; kk += 2) {
      float part[BQ / 8][4] = {};
#pragma unroll
      for (int k8 = 8 * kk; k8 < 8 * kk + 16; k8 += 8) {
        float x[4];
        ldsm4(x, a1 + swz<D>(16 * m1 + li + 8 * (lj & 1), k8 + 4 * (lj >> 1)));
        FragA a;
        a.set(x);
#pragma unroll
        for (int n = 0; n < BQ / 8; n += 2) {
          float y[4];
          ldsm4(y, b1 + swz<D>(8 * (n + (lj >> 1)) + li, k8 + 4 * (lj & 1)));
          FragB bn, bn1;
          bn.set(y[0], y[1]);
          bn1.set(y[2], y[3]);
          mma3(part[n], a, bn);
          mma3(part[n + 1], a, bn1);
        }
      }
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c1[n][e] += part[n][e];
    }
    // Element e of n-tile n sits at key 16 m1 + g (+ 8 for e >= 2), row
    // 8 n + 2 t (+ 1 for odd e).
    float* out1 = is_s ? pt : dpt;
    float pmax = 0.f;
    if (is_s) {
      const bool full = tmf::block_full(band, qg0, BQ, kg0, BKV);
      const float* lst = lse_s + st * BQ;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * m1 + g + (e >= 2 ? 8 : 0);
          const int row = 8 * n + 2 * t + (e & 1);
          float x = c1[n][e] * scale;
          if (!full && !tmf::valid(band, qg0 + row, kg0 + key))
            x = tmf::NEG_INF;
          c1[n][e] = expf(x - lst[row]);
          pmax = fmaxf(pmax, c1[n][e]);
        }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const int key = 16 * m1 + g, row = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(out1 + key * TP + row) =
          make_float2(c1[n][0], c1[n][1]);
      *reinterpret_cast<float2*>(out1 + (key + 8) * TP + row) =
          make_float2(c1[n][2], c1[n][3]);
    }
    if (__syncthreads_or(pmax > 0.5f)) {
      // 1b. Row lane's key with P > 1/2, if any: its dP in the plain
      // version's order (see above).
      if (warp == 0) {
        int key = -1;
        for (int j = 0; j < BKV; ++j)
          if (pt[j * TP + lane] > 0.5f) key = j;
        if (key >= 0) {
          float acc = 0.f;
          for (int d = 0; d < D; ++d)
            acc = fmaf(dost[swz<D>(lane, d)], vs[swz<D>(key, d)], acc);
          dpt[key * TP + lane] = acc;
        }
      }
      __syncthreads();
    }

    // 2. dV += P^T dO, dK += dS^T Q over the 32 rows: this q block's part
    // summed on the tensor cores, then added to the sums in f32.
    const float* dvst = dv_s + st * BQ;
    float t_dk[MT][NTL][4], t_dv[MT][NTL][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t_dk[m][n][e] = t_dv[m][n][e] = 0.f;
#pragma unroll
    for (int ks8 = 0; ks8 < BQ / 8; ++ks8) {
      const int c = 8 * ks8 + t;
      const float d_lo = dvst[c], d_hi = dvst[c + 4];
      FragA ap[MT], ad[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int at = (16 * (wr * MT + m) + li + 8 * (lj & 1)) * TP +
                       8 * ks8 + 4 * (lj >> 1);
        float p[4], ds[4];
        ldsm4(p, pt + at);
        ldsm4(ds, dpt + at);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[i] = p[i] * (ds[i] - (i < 2 ? d_lo : d_hi));
        ap[m].set(p);
        ad[m].set(ds);
      }
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const int col = 8 * (wc * NTL + n) + g;
        FragB bdo, bq;
        bdo.set(dost[swz<D>(c, col)], dost[swz<D>(c + 4, col)]);
        bq.set(qst[swz<D>(c, col)], qst[swz<D>(c + 4, col)]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma3(t_dv[m][n], ap[m], bdo);
          mma3(t_dk[m][n], ad[m], bq);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_dv[m][n][e] += t_dv[m][n][e];
          acc_dk[m][n][e] += t_dk[m][n][e];
        }
    __syncthreads();  // stage st and the P^T / dP^T tiles are free again
  }
  cp_async_wait<0>();

  float* dkb = dk + kvoff;
  float* dvb = dv + kvoff;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int key = k0 + 16 * (wr * MT + m) + g + 8 * h8;
        if (key >= Tkv) continue;
        const long at = (long)key * kvstride + 8 * (wc * NTL + n) + 2 * t;
        *reinterpret_cast<float2*>(dkb + at) =
            make_float2(scale * acc_dk[m][n][2 * h8],
                        scale * acc_dk[m][n][2 * h8 + 1]);
        *reinterpret_cast<float2*>(dvb + at) =
            make_float2(acc_dv[m][n][2 * h8], acc_dv[m][n][2 * h8 + 1]);
      }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dvec,
                   float* dk, float* dv, int B, int Tq, int Tkv, int H, int Hkv,
                   float scale, tmf::Band band, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::bytes;
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
// lse / dvec [B, H, Tq]; all f32, contiguous, on the device, q / k / v /
// dout / dk / dv 16-byte aligned.  Returns the launch's CUDA error code.
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
