// flash_bwd_dq_wgmma: the dQ half of the flash-attention backward on bf16
// q / k / v (the "wgmma_bf16" route of ops/flash.py; head dims 64 and 128,
// smaller ones zero-padded to 64 by the wrapper; dq in f32), on Hopper's
// wgmma fed by TMA; and the dO split pre-pass both bf16 backward kernels
// read (flash_bwd_split).
//
// Replaces the TPU kernel _flash_bwd_dq_kernel (torchmpi_tpu/ops/flash.py:358,
// launched by pallas_call in flash_attention_bwd, :707) on bf16 operands;
// flash_bwd_dq.cu is the f32 route.
//
//   dq_i = scale * sum_j bf16(p_ij (dO_i . v_j - D_i)) k_j
//
// The JAX semantics: dO is float32 (JAX :667), so dP = dO V^T has a float32
// operand; dS is rounded to bf16 before dS K (:407).
//
// What bounds it: operations.  4 bf16 products of 2 D flops per live
// (q, k) pair in the split form (3 when dO's lo part is zero), against 3
// of the all-bf16 bound (6 D flops a pair).
//
// dP = dO V^T as bf16 splits (flash_bwd_dkv_wgmma.cu's note has the error
// budget): dO = dO_hi + dO_lo, dO_hi = bf16(dO), dO_lo = bf16(dO - dO_hi),
// made once for both kernels by flash_bwd_split below, and
//   dP = dO_hi V^T + dO_lo V^T      (V is bf16-exact),
// off by at most 2^-16 sum |dO| |V|; a bf16 dO comes with no lo part (LO
// false) and the same products are exact.  Where P > 1/2 the lane that
// holds it evaluates that dP again as an f32 FMA chain over d in order
// from dO and V in device memory, as flash_bwd_dq.cu does (on the
// diagonal of a window of 1 every dq is that rounding).
//
// Design (hopper-kernels guide 1; the shape of xent_wgmma.cuh).  One block
// of 384 threads per (128 q rows, group of HB q heads of one kv head,
// batch): the 128 rows are HB heads x 128 / HB positions, so each K / V
// tile serves the HB heads, as flash_bwd_dq.cu's blocks do.
//   warpgroup 0, the producer: its first thread loads Q, dO_hi and dO_lo
//     of the block once (TMA, 128-byte swizzle, bf16; rows past Tq read as
//     zeros), then walks the live kv blocks of BK keys (block_live: a
//     contiguous range) and per block waits for a free stage of the ring
//     and issues the TMA loads of K and V (keys past Tkv read as zeros);
//   warpgroups 1 and 2, the consumers (setmaxnreg.inc to 232), 64 rows
//     each, per kv block:
//       S = Q K^T, dP = dO_hi V^T (+ dO_lo V^T): wgmma m64nBKk16, both
//         operands K-major from shared memory;
//       P = exp(S scale - lse) (masked only when block_full says the block
//         holds a masked score), dS = P (dP - D) in registers, rounded to
//         bf16;
//       dq += dS K: wgmma m64nDk16 with A from registers (the accumulator
//         fragment repacked as bf16 A fragments) and B = K MN-major from
//         the stage; then the stage is released.
//   dq stays in registers (D / 2 f32 a thread) until the block stores it.
// lse and D of the thread's two rows are read once, from device memory.
// Resources at D 128 with dO's lo part: Q, dO_hi and dO_lo 96 KB, four
// stages of K and V 128 KB (225 KB), one block an SM; no spills (ptxas,
// the `build` and `flash_bf16` lines of chip_smoke.py).
// Masks and block skips are flash_common.cuh's valid / block_live /
// block_full.  Same inputs, same order: two calls give the same bits.
//
// Tile size: BK (TMF_DQ_BK, default 64) keys a step;
// scripts/torch_flash_bwd_bf16_variants.py builds the other.

#include <cuda.h>
#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

#ifndef TMF_DQ_BK
#define TMF_DQ_BK 64
#endif

namespace {

using tmf::bf16;
using tmw::kmajor_desc;
using tmw::mnmajor_desc;

constexpr int NT = 384;        // producer + 2 consumer warpgroups
constexpr int ROWS = 128;      // q rows a block, 64 a consumer
constexpr int BK = TMF_DQ_BK;  // keys a step
static_assert(BK == 64 || BK == 128, "BK: 64 or 128 keys a step");
constexpr int SMEM_LIMIT = 232448;

template <int D, bool LO>
struct Layout {
  static constexpr int Q_CHUNK = ROWS * 128;       // bytes: 128 rows x 64 d
  static constexpr int RES_TILE = D / 64 * Q_CHUNK;  // Q, dO_hi or dO_lo
  static constexpr int NRES = LO ? 3 : 2;
  static constexpr int K_CHUNK = BK * 128;         // bytes: BK keys x 64 d
  static constexpr int KV_TILE = D / 64 * K_CHUNK;  // K or V
  static constexpr int STAGE = 2 * KV_TILE;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - NRES * RES_TILE) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr size_t BYTES =
      1024 + (size_t)NRES * RES_TILE + (size_t)STAGES * STAGE;
};

// Start S = Q K^T and dP = dO V^T (dO's parts summed) of one warpgroup's
// 64 rows (Q at qa, dO_hi and dO_lo a resident tile apart) against
// the kv block of the stage at ka (K, then V a tile apart), one commit
// group; each sum's first product writes its accumulator (scale-d 0).
template <int D, bool LO>
__device__ __forceinline__ void issue_sdp(float (&sc)[BK / 2],
                                          float (&dp)[BK / 2], uint32_t qa,
                                          uint32_t ka) {
  using L = Layout<D, LO>;
  const uint32_t va = ka + L::KV_TILE;
  const auto q_at = [](uint32_t a, int kk) {
    return kmajor_desc(a, L::Q_CHUNK, kk);
  };
  const auto kv_at = [](uint32_t a, int kk) {
    return kmajor_desc(a, L::K_CHUNK, kk);
  };
  tmw::wgmma_fence();
  tmw::Wgmma<BK>::template ss<0, 0, 0>(sc, q_at(qa, 0), kv_at(ka, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    tmw::Wgmma<BK>::template ss<0, 0>(sc, q_at(qa, kk), kv_at(ka, kk));
  // dO_hi, then dO_lo (one resident tile apart).
  tmw::Wgmma<BK>::template ss<0, 0, 0>(dp, q_at(qa + L::RES_TILE, 0),
                                       kv_at(va, 0));
#pragma unroll
  for (int t = 0; t < (LO ? 2 : 1); ++t)
#pragma unroll
    for (int kk = t == 0 ? 1 : 0; kk < D / 16; ++kk)
      tmw::Wgmma<BK>::template ss<0, 0>(
          dp, q_at(qa + (1 + t) * L::RES_TILE, kk), kv_at(va, kk));
  tmw::wgmma_commit();
}

template <int D, bool LO>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdh,
    const __grid_constant__ CUtensorMap tdl,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ v,
    const bf16* __restrict__ dohi, const float* __restrict__ dof,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dq, int Tq, int Tkv, int H, int Hkv, int hb,
    float scale, tmf::Band band) {
  using L = Layout<D, LO>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[L::STAGES], empty[L::STAGES];
  const uint32_t raw = tmw::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* ring = smem + L::NRES * L::RES_TILE;

  const int wg = threadIdx.x / 128;
  const int bq = ROWS / hb;  // q rows a head
  const int q0 = blockIdx.x * bq, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int hk = h0 / (H / Hkv);
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

  if (threadIdx.x == 0) {
    tmw::mbar_init(&qbar, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      tmw::mbar_init(&full[s], 1);
      tmw::mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer.  From here on the roles never meet at a block barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0 && jlo < jhi) {
      tmw::mbar_arrive_tx(&qbar, L::NRES * L::RES_TILE);
      for (int i = 0; i < hb; ++i) {
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          const int at = ch * L::Q_CHUNK + i * bq * 128;
          tmw::tma_load_4d(smem + at, &tq, &qbar, 64 * ch, h0 + i, q0, b);
          tmw::tma_load_4d(smem + L::RES_TILE + at, &tdh, &qbar, 64 * ch,
                           h0 + i, q0, b);
          if (LO)
            tmw::tma_load_4d(smem + 2 * L::RES_TILE + at, &tdl, &qbar, 64 * ch,
                             h0 + i, q0, b);
        }
      }
      for (int j = jlo; j < jhi; ++j) {
        const int it = j - jlo, s = it % L::STAGES;
        if (it >= L::STAGES) tmw::mbar_wait(&empty[s], ((it / L::STAGES) - 1) & 1);
        tmw::mbar_arrive_tx(&full[s], L::STAGE);
        unsigned char* st = ring + s * L::STAGE;
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          tmw::tma_load_4d(st + ch * L::K_CHUNK, &tk, &full[s], 64 * ch, hk,
                           j * BK, b);
          tmw::tma_load_4d(st + L::KV_TILE + ch * L::K_CHUNK, &tv, &full[s],
                           64 * ch, hk, j * BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this consumer's 64 rows of the block
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const long qstride = (long)H * D, kvstride = (long)Hkv * D;

    // The thread's rows 16 w + g + 8 hh of the consumer's 64: head, position,
    // lse and D (a row past Tq gets p = 0).
    int head[2], pos[2];
    float lse_r[2], dv_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * c + 16 * w + g + 8 * hh;
      head[hh] = h0 + r / bq;
      pos[hh] = q0 + r % bq;
      const long at = ((long)b * H + head[hh]) * Tq + pos[hh];
      const bool in = pos[hh] < Tq;
      lse_r[hh] = in ? lse[at] : -tmf::NEG_INF;
      dv_r[hh] = in ? dvec[at] : 0.f;
    }
    // Where the in-order dP of a row reads dO (f32 when LO, else bf16)
    // and, plus key x kvstride, V.
    const long orow[2] = {
        ((long)b * Tq + pos[0]) * qstride + (long)head[0] * D,
        ((long)b * Tq + pos[1]) * qstride + (long)head[1] * D};
    const long vcol = (long)b * Tkv * kvstride + (long)hk * D;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (jlo < jhi) tmw::mbar_wait(&qbar, 0);
    const uint32_t qa = tmw::smem_addr(smem) + c * 64 * 128;

    // S and dP, [64 rows x BK keys]: element i = 4 jj + 2 hh + cc at row
    // 16 w + g + 8 hh, key 8 jj + 2 tq4 + cc.  Per live kv block: S and
    // dP, then P and dS in their registers once both are done, then dq +=
    // dS K; the other consumer warpgroup's products run meanwhile.  No
    // instruction touches an accumulator while a wgmma is in flight:
    // ptxas would serialize every wgmma (its notes C7514, C7515).
    float sc[BK / 2], dp[BK / 2];
    for (int j = jlo; j < jhi; ++j) {
      const int it = j - jlo, s = it % L::STAGES;
      const uint32_t ka = tmw::smem_addr(ring + s * L::STAGE);
      tmw::mbar_wait(&full[s], (it / L::STAGES) & 1);
      issue_sdp<D, LO>(sc, dp, qa, ka);
      tmw::wgmma_wait<0>();
      tmw::fence_acc(sc);
      tmw::fence_acc(dp);

      const int kg0 = band.kv_offset + j * BK;
      const bool full_blk = tmf::block_full(band, qg0, bq, kg0, BK);
      float pmax = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = kg0 + 8 * (i / 4) + 2 * tq4 + (i & 1);
        float x = sc[i] * scale;
        if (!full_blk && !tmf::valid(band, band.q_offset + pos[hh], key))
          x = tmf::NEG_INF;
        sc[i] = expf(x - lse_r[hh]);
        pmax = fmaxf(pmax, sc[i]);
      }
      if (__any_sync(0xffffffffu, pmax > 0.5f)) {
        // A key with P > 1/2 in its row: its dP in the plain version's
        // order (see above), by the lane that holds it.
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (sc[i] > 0.5f) {
            const int hh = (i >> 1) & 1;
            const int key = j * BK + 8 * (i / 4) + 2 * tq4 + (i & 1);
            dp[i] = tmf::dp_in_order<D, LO>(dof, dohi, orow[hh], v,
                                       (long)key * kvstride + vcol);
          }
        }
      }

      // dS = P (dP - D) rounded to bf16, as the A fragments of k-step kk
      // (keys 16 kk ..).
      uint32_t as[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i0 = 8 * kk + 2 * r;
          const float d = dv_r[r & 1];
          const __nv_bfloat162 d2 = __floats2bfloat162_rn(
              sc[i0] * (dp[i0] - d), sc[i0 + 1] * (dp[i0 + 1] - d));
          as[kk][r] = *reinterpret_cast<const uint32_t*>(&d2);
        }
      }

      // dq += dS K: B = K [BK keys x D] MN-major, the next 64 of d in the
      // next chunk.
      tmw::fence_acc(acc);
      tmw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        tmw::Wgmma<D>::template rs<1>(acc, as[kk],
                                      mnmajor_desc(ka, L::K_CHUNK, kk));
      tmw::wgmma_commit();
      tmw::wgmma_wait<0>();
      tmw::fence_acc(acc);
      tmw::mbar_arrive(&empty[s]);
    }

    // dq: element i = 4 jj + 2 hh + cc at row hh, column 8 jj + 2 tq4 + cc.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (pos[hh] >= Tq) continue;
      float* drow = dq + orow[hh];
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<float2*>(drow + 8 * jj + 2 * tq4) =
            make_float2(scale * acc[4 * jj + 2 * hh],
                        scale * acc[4 * jj + 2 * hh + 1]);
    }
  }
}

template <int D, bool LO>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dohi, const bf16* dolo, const float* dof,
                   const float* lse, const float* dvec, float* dq, int B,
                   int Tq, int Tkv, int H, int Hkv, float scale,
                   tmf::Band band, cudaStream_t stream) {
  using L = Layout<D, LO>;
  const int group = H / Hkv;
  const int hb = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
  const int bq = ROWS / hb;
  const long e = sizeof(bf16);
  CUtensorMap tq, tdh, tdl, tk, tv;
  cudaError_t err = tmw::make_map_bf16_4d(&tq, q, D, H, Tq, B, D * e, H * D * e,
                                          (long)Tq * H * D * e, bq);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tdh, dohi, D, H, Tq, B, D * e, H * D * e,
                                (long)Tq * H * D * e, bq);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tdl, LO ? dolo : dohi, D, H, Tq, B, D * e,
                                H * D * e, (long)Tq * H * D * e, bq);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tk, k, D, Hkv, Tkv, B, D * e, Hkv * D * e,
                                (long)Tkv * Hkv * D * e, BK);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tv, v, D, Hkv, Tkv, B, D * e, Hkv * D * e,
                                (long)Tkv * Hkv * D * e, BK);
  if (err != cudaSuccess) return err;
  const auto kernel = flash_bwd_dq_wgmma_kernel<D, LO>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + bq - 1) / bq, H / hb, B);
  kernel<<<grid, NT, L::BYTES, stream>>>(tq, tdh, tdl, tk, tv, v, dohi, dof,
                                         lse, dvec, dq, Tq, Tkv, H, Hkv, hb,
                                         scale, band);
  return cudaGetLastError();
}

template <bool LO>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const bf16* dohi,
             const bf16* dolo, const float* dof, const float* lse,
             const float* dvec, float* dq, int B, int Tq, int Tkv, int H,
             int Hkv, int D, float scale, tmf::Band band, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64, LO>(q, k, v, dohi, dolo, dof, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128, LO>(q, k, v, dohi, dolo, dof, lse, dvec, dq, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The dO split: hi = bf16(x), lo = bf16(x - hi), both rounded to nearest
// even, as torch's float32 -> bfloat16 cast rounds (x - hi is exact in
// f32).  Bounded by bytes: 4 read and 4 written an element.  Eight
// elements a thread and step (two 16-byte loads, two 16-byte stores), the
// last n % 8 by the first threads one at a time.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
flash_bwd_split_kernel(const float* __restrict__ x, bf16* __restrict__ hi,
             bf16* __restrict__ lo, long n) {
  const long n8 = n / 8;
  const long step = (long)gridDim.x * blockDim.x;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long i = first; i < n8; i += step) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 c = reinterpret_cast<const float4*>(x)[2 * i + 1];
    const float f[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const __nv_bfloat162 hp = __floats2bfloat162_rn(f[2 * p], f[2 * p + 1]);
      const __nv_bfloat162 lp = __floats2bfloat162_rn(
          f[2 * p] - __low2float(hp), f[2 * p + 1] - __high2float(hp));
      h[p] = *reinterpret_cast<const uint32_t*>(&hp);
      l[p] = *reinterpret_cast<const uint32_t*>(&lp);
    }
    reinterpret_cast<uint4*>(hi)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
  const long r = 8 * n8 + first;
  if (r < n) {
    const bf16 hr = __float2bfloat16_rn(x[r]);
    hi[r] = hr;
    lo[r] = __float2bfloat16_rn(x[r] - __bfloat162float(hr));
  }
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tkv, Hkv, D] bf16 with D 64 or 128; dO as
// do_hi [B, Tq, H, D] bf16 and, for an f32 dO, its lo part do_lo (bf16)
// and dO itself dof (f32), both null for a bf16 dO; lse / dvec [B, H, Tq]
// f32; dq [B, Tq, H, D] f32.  All contiguous, 16-byte aligned, on the
// device.  Returns the launch's CUDA error code.
extern "C" int tm_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* do_hi,
                                    const void* do_lo, const float* dof,
                                    const float* lse, const float* dvec,
                                    float* dq, int B, int Tq, int Tkv, int H,
                                    int Hkv, int D, float scale, int causal,
                                    int window, int q_offset, int kv_offset,
                                    void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* hi = static_cast<const bf16*>(do_hi);
  const auto* lo = static_cast<const bf16*>(do_lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((lo == nullptr) != (dof == nullptr)) return (int)cudaErrorInvalidValue;
  return lo ? dispatch<true>(qb, kb, vb, hi, lo, dof, lse, dvec, dq, B, Tq,
                             Tkv, H, Hkv, D, scale, band, s)
            : dispatch<false>(qb, kb, vb, hi, lo, dof, lse, dvec, dq, B, Tq,
                              Tkv, H, Hkv, D, scale, band, s);
}

// hi, lo [n] bf16 = the split of x [n] f32; x, hi and lo 16-byte aligned.
// Returns the launch's CUDA error code.
extern "C" int tm_flash_bwd_split(const float* x, void* hi, void* lo, long n,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long blocks = (n / 8 + 255) / 256;
  const int grid = (int)(blocks < 1 ? 1 : blocks > 132 * 8 ? 132 * 8 : blocks);
  flash_bwd_split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<bf16*>(hi), static_cast<bf16*>(lo), n);
  return (int)cudaGetLastError();
}
