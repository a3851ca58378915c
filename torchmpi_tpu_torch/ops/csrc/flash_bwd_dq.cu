// flash_bwd_dq: the dQ half of the flash-attention backward, its three
// products on the tensor cores; q / k / v in f32 or bf16 (two routes, one
// kernel), dO, lse, D and dq in f32.
//
// Replaces the TPU kernel _flash_bwd_dq_kernel (torchmpi_tpu/ops/flash.py:358,
// launched by pallas_call in flash_attention_bwd, :707).
//
//   dq_i = scale * sum_j p_ij (dO_i . v_j - D_i) k_j,   p_ij = exp(s_ij - lse_i)
//
// with p recomputed from the forward's lse and D_i = dO_i . O_i supplied by
// the caller, so the [T, T] probabilities never exist in memory.
//
// What bounds it: operations.  Three products of 2 D flops per live (q, k)
// pair (Q K^T, dO V^T, dS K), 6 D in all, against a few reads per row.
//
// Design.  The forward's (flash_fwd.cu): one block of 8 warps per (q block,
// group of HB q heads of one kv head, batch), each warp 16 q rows of one
// head, 128 rows a block, so each K / V tile serves the HB heads; a loop
// inside the block walks the live kv blocks, here of 32 keys (Q, dO, and
// two stages of K and V fill 192 KB at D 128).  Per block and warp:
//   1. S = Q K^T, then P = exp(S scale - lse) (masked only when the warp's
//      block is partial), and dP = dO V^T, [16 rows x 32 keys] each, two
//      k-steps at a time on the tensor cores, summed in f32.  S before dP,
//      so the two short-run sums are never live together.
//   2. dS = P (dP - D) in registers.
//   3. dq += dS K: this block's 32 keys summed on the tensor cores, then
//      added to dq in f32.  dS is used where it is, in dP's C fragments,
//      with K's rows read at the same permuted keys (8kk + 2t, 8kk + 2t +
//      1), as flash_fwd.cu uses P; K's tile swizzle (kRows2T) keeps those
//      reads on 32 distinct banks and its ldmatrix reads for step 1
//      conflict-free.
// Every product is mma.sync m16n8k8 TF32 in the three-product form (mma3,
// flash_common.cuh), with flash_fwd.cu's kTruncate split and per-lane
// load offsets (Offs2T).  Q, dO, lse and D load once a block; K and V of
// the next live kv block with cp.async into the other of two stages while
// the current one computes.
// Where one key holds more than half of a q row's probability (P > 1/2, at
// most one key a row), dP - D cancels: D is then mostly that same dP, and
// dS is set by the rounding of dP.  The lane that holds such a P evaluates
// its dP again as an f32 FMA chain over d in order, the order of the f32
// plain version's matmul, so the two agree there too (on the diagonal of
// a window of 1, every dq is that rounding).  The dK/dV kernel takes a
// block-wide __syncthreads_or for this, since its P passes through shared
// memory; here each warp holds its own rows' P in registers, so a warp
// vote (__any_sync) decides, and no warp waits for another.  It costs a
// warp nothing when none of its rows has such a key.
// Rows past Tq and fully masked rows carry lse = +1e30, so their p is 0.
// No atomics and a fixed order of every sum: two calls give the same bits.
//
// Resources at D 128: 192 KB of shared memory (Q and dO 128 KB, two stages
// of K and V 64 KB), so one block of 8 warps an SM; 239 registers a
// thread, no spills (ptxas, the `build` line of chip_smoke.py; PERF.md).
//
// The bf16 route (BF; tm_flash_bwd_dq_bf16): Q and K in bf16 tiles, dO in
// f32 (the JAX wrapper upcasts it, :667), V converted to an f32 tile as it
// is loaded.  S = Q K^T is one m16n8k16 bf16 product; dP = dO V^T stays on
// mma3, an f32 product as in JAX (V's TF32 lo part is zero); dS is rounded
// to bf16 (JAX :407) and dS K is one bf16 product against K's B fragments
// by transposed ldmatrix.  144 KB of shared memory at D 128.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using tmf::FragA;
using tmf::FragB;
using tmf::kRows2T;
using tmf::kTruncate;

constexpr int NWARP = tmf::NT / 32;  // 8
constexpr int ROWS = 16 * NWARP;     // q rows a block: HB heads x BQ rows
constexpr int BK = 32;               // keys a kv block

template <bool BF>
using In = std::conditional_t<BF, tmf::bf16, float>;

template <int D, bool BF>
struct Smem {
  static constexpr int P = tmf::pitch<D>();  // f32 tiles
  static constexpr int PI = BF ? tmf::pitch_bf<D>() : P;  // Q and K tiles
  static constexpr int qTile = ROWS * P, kTile = BK * P;
  static constexpr int qTileI = ROWS * PI, kTileI = BK * PI;
  // f32: dos [ROWS][P] (head-major: HB heads of BQ rows), vs [2 stages]
  // [BK][P]; then in the operand type: qs [ROWS][PI], ks [2][BK][PI].
  static constexpr size_t bytes = sizeof(float) * (qTile + 2 * kTile) +
                                  sizeof(In<BF>) * (qTileI + 2 * kTileI);
};

template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return tmf::swz<D, kRows2T>(r, c);
}

template <int D, bool BF>
__global__ void __launch_bounds__(tmf::NT)
flash_bwd_dq_kernel(const In<BF>* __restrict__ q, const In<BF>* __restrict__ k,
                    const In<BF>* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, int Tq, int Tkv, int H, int Hkv,
                    int hb, float scale, tmf::Band band) {
  using S = Smem<D, BF>;
  using T = In<BF>;
  constexpr int NT8 = D / 8;   // 8-column n-tiles of dq
  constexpr int NK8 = BK / 8;  // 8-key n-tiles of S / dP, k-steps of dS K
  extern __shared__ __align__(16) float smem[];
  float* dos = smem;
  float* vs = dos + S::qTile;                      // [2][kTile]
  T* qs = reinterpret_cast<T*>(vs + 2 * S::kTile);
  T* ks = qs + S::qTileI;                          // [2][kTileI]

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
    tmf::load_in<D, kRows2T>(ks + st * S::kTileI, k + kvoff, kvstride,
                             j * BK, BK, Tkv);
    if constexpr (BF)
      tmf::load_tile_cvt<D, kRows2T>(vs + st * S::kTile, v + kvoff, kvstride,
                                     j * BK, BK, Tkv);
    else
      tmf::load_tile<D, kRows2T>(vs + st * S::kTile, v + kvoff, kvstride,
                                 j * BK, BK, Tkv);
  };
  for (int i = 0; i < hb; ++i) {
    const long off = (long)b * Tq * qstride + (long)(h0 + i) * D;
    tmf::load_in<D, kRows2T>(qs + i * bq * S::PI, q + off, qstride, q0, bq,
                             Tq);
    tmf::load_tile<D, kRows2T>(dos + i * bq * S::P, dout + off, qstride, q0,
                               bq, Tq);
  }
  if (jlo < jhi) issue_kv(jlo, 0);
  tmf::cp_async_commit();

  // lse and D of rows g and g + 8 of the warp; a row past Tq gets p = 0.
  float lse_r[2], dv_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    const long at = ((long)b * H + h) * Tq + row;
    lse_r[i] = row < Tq ? lse[at] : -tmf::NEG_INF;
    dv_r[i] = row < Tq ? dvec[at] : 0.f;
  }
  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const T* qw = qs + 16 * warp * S::PI;  // the warp's 16 rows of Q, dO
  const float* dow = dos + 16 * warp * S::P;
  const tmf::Offs2T<D> off(lane);
  for (int j = jlo; j < jhi; ++j) {
    const int st = (j - jlo) & 1;
    if (j + 1 < jhi) issue_kv(j + 1, st ^ 1);
    tmf::cp_async_commit();
    tmf::cp_async_wait<1>();  // this thread's copies of block j have landed
    __syncthreads();          // and everyone's

    const T* kst = ks + st * S::kTileI;
    const float* vst = vs + st * S::kTile;
    const int kg0 = band.kv_offset + j * BK;
    if (tmf::block_live(band, qg0 + wr, 16, kg0, BK)) {
      // 1. Element e of n-tile n sits at row wr + g (+ 8 for e >= 2), key
      // 8 n + 2 t (+ 1 for odd e).
      float p[NK8][4];
      if constexpr (BF)
        tmf::product_abt_bf<D, NK8>(p, qs, 16 * warp, kst, lane);
      else
        tmf::product_abt<D, NK8>(p, qw, kst, off);
      const bool full = tmf::block_full(band, qg0 + wr, 16, kg0, BK);
      float pmax = 0.f;
#pragma unroll
      for (int n = 0; n < NK8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = p[n][e] * scale;
          if (!full && !tmf::valid(band, qg0 + wr + g + (e >= 2 ? 8 : 0),
                                   kg0 + 8 * n + 2 * t + (e & 1)))
            x = tmf::NEG_INF;
          p[n][e] = expf(x - lse_r[e >> 1]);
          pmax = fmaxf(pmax, p[n][e]);
        }
      float ds[NK8][4];
      tmf::product_abt<D, NK8>(ds, dow, vst, off);
      if (__any_sync(0xffffffffu, pmax > 0.5f)) {
        // A key with P > 1/2 in its row: its dP in the plain version's
        // order (see above).
#pragma unroll
        for (int n = 0; n < NK8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p[n][e] > 0.5f) {
              const int row = 16 * warp + g + (e >= 2 ? 8 : 0);
              const int key = 8 * n + 2 * t + (e & 1);
              float a = 0.f;
              for (int d = 0; d < D; ++d)
                a = fmaf(dos[swz<D>(row, d)], vst[swz<D>(key, d)], a);
              ds[n][e] = a;
            }
      }
      // 2. dS = P (dP - D).
#pragma unroll
      for (int n = 0; n < NK8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - dv_r[e >> 1]);

      // 3. dq += dS K, this block's part summed on the tensor cores.
      if constexpr (BF) {
        // dS rounded to bf16 (JAX :407), accumulated into dq in f32.
#pragma unroll
        for (int kk = 0; kk < NK8 / 2; ++kk) {
          unsigned a[4];
          tmf::c_as_a_bf<NK8>(a, ds, kk);
#pragma unroll
          for (int np = 0; np < NT8 / 2; ++np) {
            unsigned fb[4];
            tmf::ldbt_bf<D>(fb, kst, 16 * kk, 16 * np, lane);
            tmf::mma_bf16(acc[2 * np], a, fb[0], fb[1]);
            tmf::mma_bf16(acc[2 * np + 1], a, fb[2], fb[3]);
          }
        }
      } else {
        float part[NT8][4] = {};
#pragma unroll
        for (int kk = 0; kk < NK8; ++kk) {
          const float x[4] = {ds[kk][0], ds[kk][2], ds[kk][1], ds[kk][3]};
          FragA a;
          a.set<kTruncate>(x);
          const float* kk8 = kst + 8 * kk * S::P;
#pragma unroll
          for (int n = 0; n < NT8; ++n) {
            FragB bk;
            bk.set<kTruncate>(kk8[off.v0[n % 4] + 32 * (n / 4)],
                              kk8[off.v1[n % 4] + 32 * (n / 4)]);
            tmf::mma3(part[n], a, bk);
          }
        }
#pragma unroll
        for (int n = 0; n < NT8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
    }
    __syncthreads();  // stage st is free again
  }
  tmf::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tq) continue;
    float* drow = dq + ((long)b * Tq + row) * qstride + (long)h * D;
#pragma unroll
    for (int n = 0; n < NT8; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n + 2 * t) =
          make_float2(scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

template <int D, bool BF>
cudaError_t launch(const In<BF>* q, const In<BF>* k, const In<BF>* v,
                   const float* dout, const float* lse, const float* dvec,
                   float* dq, int B, int Tq, int Tkv, int H, int Hkv,
                   float scale, tmf::Band band, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, BF>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int group = H / Hkv;
  const int hb = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
  const int bq = ROWS / hb;
  dim3 grid((Tq + bq - 1) / bq, H / hb, B);
  flash_bwd_dq_kernel<D, BF><<<grid, tmf::NT, smem, stream>>>(
      q, k, v, dout, lse, dvec, dq, Tq, Tkv, H, Hkv, hb, scale, band);
  return cudaGetLastError();
}

template <bool BF>
int dispatch(const void* qp, const void* kp, const void* vp, const float* dout,
             const float* lse, const float* dvec, float* dq, int B, int Tq,
             int Tkv, int H, int Hkv, int D, float scale, int causal,
             int window, int q_offset, int kv_offset, void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const In<BF>*>(qp);
  const auto* k = static_cast<const In<BF>*>(kp);
  const auto* v = static_cast<const In<BF>*>(vp);
  switch (D) {
    case 16: return launch<16, BF>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 32: return launch<32, BF>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 64: return launch<64, BF>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128, BF>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q / dout / dq [B, Tq, H, D], k / v [B, Tkv, Hkv, D], lse / dvec [B, H, Tq];
// all f32, contiguous, on the device, q / k / v / dout 16-byte aligned.
// Returns the launch's CUDA error code.
extern "C" int tm_flash_bwd_dq(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* dvec, float* dq, int B, int Tq,
                               int Tkv, int H, int Hkv, int D, float scale,
                               int causal, int window, int q_offset,
                               int kv_offset, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, D,
                         scale, causal, window, q_offset, kv_offset, stream);
}

// The bf16 route: q / k / v bf16; dout, lse, dvec and dq f32.
extern "C" int tm_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const float* dout,
                                    const float* lse, const float* dvec,
                                    float* dq, int B, int Tq, int Tkv, int H,
                                    int Hkv, int D, float scale, int causal,
                                    int window, int q_offset, int kv_offset,
                                    void* stream) {
  return dispatch<true>(q, k, v, dout, lse, dvec, dq, B, Tq, Tkv, H, Hkv, D,
                        scale, causal, window, q_offset, kv_offset, stream);
}
