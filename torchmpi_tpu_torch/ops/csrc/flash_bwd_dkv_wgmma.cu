// flash_bwd_dkv_wgmma: the dK / dV half of the flash-attention backward on
// bf16 q / k / v (the "wgmma_bf16" route of ops/flash.py; head dims 64 and
// 128, smaller ones zero-padded to 64 by the wrapper; dk and dv in f32), on
// Hopper's wgmma fed by TMA.
//
// Replaces the TPU kernel _flash_bwd_dkv_kernel (torchmpi_tpu/ops/flash.py:424,
// launched by pallas_call in flash_attention_bwd, :737) on bf16 operands;
// flash_bwd_dkv.cu is the f32 route.
//
//   dv_j = sum_h sum_i p_ij dO_i
//   dk_j = scale * sum_h sum_i bf16(p_ij (dO_i . v_j - D_i)) q_i
//
// with h over the q heads of kv head j's GQA group, summed inside the
// block (no atomics).  The JAX semantics: dO is float32 (the JAX wrapper
// upcasts it, :667), so dP = dO V^T has a float32 operand and P is not
// rounded in P^T dO (:471); only dS is rounded to bf16, before dS^T Q
// (:478).
//
// What bounds it: operations.  In the split form below, 7 bf16 products of
// 2 D flops per live (q, k) pair (5 when dO's lo part is zero), against
// the one bf16 product each of the all-bf16 bound (4: 8 D flops a pair).
//
// The float32-operand products as bf16 splits.  The wrapper hands the
// kernel dO as dO_hi = bf16(dO) and dO_lo = bf16(dO - dO_hi) (the
// flash_bwd_split pre-pass in flash_bwd_dq_wgmma.cu), or, for a bf16 dO,
// dO itself with no lo part (LO false: the same products, exact).
//   dP^T = V dO_hi^T + V dO_lo^T            (V is bf16-exact)
//   dV  += P_hi dO_hi + P_lo dO_hi + P_hi dO_lo,   P = P_hi + P_lo the
//          same split of the f32 P in registers
// Error budget, each term against |a| |b| summed over the contraction
// (bf16 keeps 8 significant bits: rounding to nearest is off by at most
// 2^-8 of the value):
//   dO - dO_hi - dO_lo = (dO - dO_hi) - bf16(dO - dO_hi), at most 2^-8
//     |dO - dO_hi| <= 2^-16 |dO|, so dP misses at most 2^-16 sum |dO| |V|;
//   P - P_hi - P_lo: the same, 2^-16 P; the dropped P_lo dO_lo: at most
//     2^-8 P 2^-8 |dO|; so dV misses at most 3 2^-16 sum P |dO| (plus
//     terms of 2^-24);
//   the tensor cores' f32 accumulation (truncating, not rounding): about
//     2^-23 per add, over at most group x Tq terms.
// The gate is 2^-7 max |ref| per tensor (chip_smoke.py FLASH_BF16_RTOL,
// tests/test_torch_flash_bf16_kernels.py ULP).  dP's 2^-16 of sum |dO| |V|
// grows relative to dS where dP - D cancels, and dS is then rounded to
// bf16 at other points than the plain version's: at the flagship's shape
// dq, dk and dv land within 6.3e-4 max |ref| with dO in two parts, 12
// times inside the gate (scripts/torch_flash_bwd_bf16_variants.py, H100;
// a third part, dO exact, brought 2.6e-4 and cost time: PERF.md).  dV, with
// no dS rounding, is held to 2^-12 max |ref| on an f32 dO besides
// (FLASH_BF16_DV_F32_RTOL, the tests' DV_F32_ULP): a missing split term
// costs it 2^-9 or more.  tests/test_torch_flash_bwd_bf16_split.py holds
// the split arithmetic to the bounds above on adversarial magnitudes.
// dK's dS = P (dP - D) cancels
// where P > 1/2 (D is then mostly that dP): the lanes that hold such a P
// evaluate its dP again as an f32 FMA chain over d in order from the f32
// dO and V in device memory, as flash_bwd_dkv.cu does, so that a window of
// 1 (every dK pure rounding) agrees with the plain version.
//
// Design (hopper-kernels guide 1; the shape of xent_wgmma.cuh).  One block
// of 384 threads per (kv block of BKV = 128 keys, kv head, batch):
//   warpgroup 0, the producer: its first warp loads K and V of the block
//     once (TMA, 128-byte swizzle, bf16), then walks the group's q heads
//     and, per head, the live q blocks of BQ rows (block_live; the live
//     blocks of a band are contiguous), and per item waits for a free
//     stage of the ring, writes the item's lse and D rows into it (one
//     lane a row; +1e30 and 0 past Tq) and issues the TMA loads of Q,
//     dO_hi and dO_lo (rows past Tq read as zeros);
//   warpgroups 1 and 2, the consumers, 64 keys each (setmaxnreg: 240
//     registers a consumer thread, the producer's down to 24; at 232 ptxas
//     spilled 24 bytes at head dim 128), per item:
//       S^T = K Q^T, dP^T = V dO_hi^T (+ V dO_lo^T): wgmma m64nBQk16, both
//         operands K-major from shared memory;
//       P^T = exp(S^T scale - lse) (masked only where block_full says the
//         warpgroup's 64 keys hold a masked score), dS^T = P^T (dP^T - D)
//         in registers;
//       dV += P^T dO, dK += bf16(dS^T) Q: wgmma m64nDk16 with A from
//         registers (the accumulator fragment repacked as bf16 A fragments,
//         as FlashAttention-3 does) and B (dO, Q) MN-major from the stage;
//       then the stage is released.  No P or dP tile in shared memory and
//       no block-wide barrier: the ring's mbarriers are the only sync.
//   dK and dV stay in registers (2 x D / 2 f32 a thread) until the block
//   stores them.  At D 128 with dO's lo part: K and V 64 KB, three stages
//   of Q, dO_hi, dO_lo, lse and D 147 KB (212 KB), one block an SM.
// Masks and block skips are flash_common.cuh's valid / block_live /
// block_full, the functions the forward uses.  Same inputs, same order:
// two calls give the same bits.
//
// Tile size: BQ (TMF_DKV_BQ, default 64) q rows a step;
// scripts/torch_flash_bwd_bf16_variants.py builds the other.

#include <cuda.h>
#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

#ifndef TMF_DKV_BQ
#define TMF_DKV_BQ 64
#endif

namespace {

using tmf::bf16;
using tmw::kmajor_desc;
using tmw::mnmajor_desc;

constexpr int NT = 384;         // producer + 2 consumer warpgroups
constexpr int BKV = 128;        // keys a block, 64 a consumer
constexpr int BQ = TMF_DKV_BQ;  // q rows an item
static_assert(BQ == 32 || BQ == 64, "BQ: 32 or 64 q rows a step");
constexpr int SMEM_LIMIT = 232448;

template <int D, bool LO>
struct Layout {
  static constexpr int KV_CHUNK = BKV * 128;       // bytes: 128 keys x 64 d
  static constexpr int KV_BYTES = D / 64 * KV_CHUNK;  // K or V
  static constexpr int Q_CHUNK = BQ * 128;         // bytes: BQ rows x 64 d
  static constexpr int TILE = D / 64 * Q_CHUNK;    // Q, dO_hi or dO_lo
  static constexpr int NTILES = LO ? 3 : 2;
  static constexpr int LSE_OFF = NTILES * TILE;    // lse [BQ], D [BQ] f32
  static constexpr int STAGE = (LSE_OFF + 8 * BQ + 1023) / 1024 * 1024;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 2 * KV_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr size_t BYTES = 1024 + 2 * KV_BYTES + (size_t)STAGES * STAGE;
};

// Start S^T = K Q^T and dP^T = V dO^T (dO's parts summed) of one
// warpgroup's 64 keys (K at ka, V at va) against the item in the stage at
// qa (Q, then dO_hi and dO_lo a tile apart), one commit group; each
// sum's first product writes its accumulator (scale-d 0).
template <int D, bool LO>
__device__ __forceinline__ void issue_st(float (&sT)[BQ / 2],
                                         float (&dpT)[BQ / 2], uint32_t ka,
                                         uint32_t va, uint32_t qa) {
  using L = Layout<D, LO>;
  const auto kv_at = [](uint32_t a, int kk) {
    return kmajor_desc(a, L::KV_CHUNK, kk);
  };
  const auto q_at = [](uint32_t a, int kk) {
    return kmajor_desc(a, L::Q_CHUNK, kk);
  };
  tmw::wgmma_fence();
  tmw::Wgmma<BQ>::template ss<0, 0, 0>(sT, kv_at(ka, 0), q_at(qa, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    tmw::Wgmma<BQ>::template ss<0, 0>(sT, kv_at(ka, kk), q_at(qa, kk));
  // dO_hi, then dO_lo (one tile apart).
  tmw::Wgmma<BQ>::template ss<0, 0, 0>(dpT, kv_at(va, 0),
                                       q_at(qa + L::TILE, 0));
#pragma unroll
  for (int t = 0; t < (LO ? 2 : 1); ++t)
#pragma unroll
    for (int kk = t == 0 ? 1 : 0; kk < D / 16; ++kk)
      tmw::Wgmma<BQ>::template ss<0, 0>(dpT, kv_at(va, kk),
                                        q_at(qa + (1 + t) * L::TILE, kk));
  tmw::wgmma_commit();
}

template <int D, bool LO>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdh,
    const __grid_constant__ CUtensorMap tdl, const bf16* __restrict__ v,
    const bf16* __restrict__ dohi, const float* __restrict__ dof,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tkv, int H,
    int Hkv, float scale, tmf::Band band) {
  using L = Layout<D, LO>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kvbar, full[L::STAGES], empty[L::STAGES];
  const uint32_t raw = tmw::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::KV_BYTES;
  unsigned char* ring = smem + 2 * L::KV_BYTES;

  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
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

  if (threadIdx.x == 0) {
    tmw::mbar_init(&kvbar, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      tmw::mbar_init(&full[s], 32);       // the producer warp's lanes
      tmw::mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer.  From here on the roles never meet at a block barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32 && items > 0) {
      if (lane == 0) {
        tmw::mbar_arrive_tx(&kvbar, 2 * L::KV_BYTES);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          tmw::tma_load_4d(ks + ch * L::KV_CHUNK, &tk, &kvbar, 64 * ch, hk, k0, b);
          tmw::tma_load_4d(vs + ch * L::KV_CHUNK, &tv, &kvbar, 64 * ch, hk, k0, b);
        }
      }
      for (int it = 0; it < items; ++it) {
        const int s = it % L::STAGES;
        if (it >= L::STAGES) tmw::mbar_wait(&empty[s], ((it / L::STAGES) - 1) & 1);
        const int h = hk * group + it / nlive;
        const int q0 = (ilo + it % nlive) * BQ;
        unsigned char* st = ring + s * L::STAGE;
        float* ls = reinterpret_cast<float*>(st + L::LSE_OFF);
        const long srow = ((long)b * H + h) * Tq + q0;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < Tq;
          ls[r] = in ? lse[srow + r] : -tmf::NEG_INF;  // past Tq: p = 0
          ls[BQ + r] = in ? dvec[srow + r] : 0.f;
        }
        if (lane == 0) {
          tmw::mbar_arrive_tx(&full[s], L::NTILES * L::TILE);
#pragma unroll
          for (int ch = 0; ch < D / 64; ++ch) {
            tmw::tma_load_4d(st + ch * L::Q_CHUNK, &tq, &full[s], 64 * ch, h, q0, b);
            tmw::tma_load_4d(st + L::TILE + ch * L::Q_CHUNK, &tdh, &full[s],
                             64 * ch, h, q0, b);
            if (LO)
              tmw::tma_load_4d(st + 2 * L::TILE + ch * L::Q_CHUNK, &tdl,
                               &full[s], 64 * ch, h, q0, b);
          }
        } else {
          tmw::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;  // this consumer's 64 keys
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int kw0 = kg0 + 64 * c;  // global position of the consumer's key 0
    const long qstride = (long)H * D, kvstride = (long)Hkv * D;
    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    if (items > 0) tmw::mbar_wait(&kvbar, 0);
    const uint32_t ka = tmw::smem_addr(ks) + c * 64 * 128;
    const uint32_t va = tmw::smem_addr(vs) + c * 64 * 128;
    // Where the in-order dP of (row, key) reads dO (plus row x qstride,
    // q head h's column h D) and V (plus key x kvstride).
    const long obase = (long)b * Tq * qstride;
    const long vbase = (long)b * Tkv * kvstride + (long)hk * D;

    // S^T and dP^T, [64 keys x BQ rows]: element i = 4 j + 2 hh + cc at
    // key 16 w + g + 8 hh, row 8 j + 2 tq4 + cc.  Per item: S^T and dP^T,
    // then P^T and dS^T in their registers once both are done, then dV and
    // dK; the other consumer warpgroup's products run meanwhile.  No
    // instruction touches an accumulator while a wgmma is in flight:
    // ptxas would serialize every wgmma (its notes C7514, C7515).
    float sT[BQ / 2], dpT[BQ / 2];
    for (int it = 0; it < items; ++it) {
      const int s = it % L::STAGES;
      const int h = hk * group + it / nlive;
      const int q0 = (ilo + it % nlive) * BQ;
      const int qg0 = band.q_offset + q0;
      const unsigned char* st = ring + s * L::STAGE;
      const uint32_t qa = tmw::smem_addr(st);
      const uint32_t dha = qa + L::TILE;
      const float* ls = reinterpret_cast<const float*>(st + L::LSE_OFF);
      tmw::mbar_wait(&full[s], (it / L::STAGES) & 1);
      issue_st<D, LO>(sT, dpT, ka, va, qa);
      tmw::wgmma_wait<0>();
      tmw::fence_acc(sT);
      tmw::fence_acc(dpT);

      // P^T = exp(S^T scale - lse), masked where the block is partial.
      const bool full_blk = tmf::block_full(band, qg0, BQ, kw0, 64);
      float pmax = 0.f;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int row = 8 * (i / 4) + 2 * tq4 + (i & 1);
        const int key = kw0 + 16 * w + g + 8 * ((i >> 1) & 1);
        float x = sT[i] * scale;
        if (!full_blk && !tmf::valid(band, qg0 + row, key)) x = tmf::NEG_INF;
        sT[i] = expf(x - ls[row]);
        pmax = fmaxf(pmax, sT[i]);
      }
      if (__any_sync(0xffffffffu, pmax > 0.5f)) {
        // A key with P > 1/2 in its row: its dP in the plain version's
        // order (see above), by the lane that holds it.
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          if (sT[i] > 0.5f) {
            const int row = q0 + 8 * (i / 4) + 2 * tq4 + (i & 1);
            const int key = k0 + 64 * c + 16 * w + g + 8 * ((i >> 1) & 1);
            dpT[i] = tmf::dp_in_order<D, LO>(
                dof, dohi, obase + (long)row * qstride + (long)h * D, v,
                vbase + (long)key * kvstride);
          }
        }
      }

      // The A fragments of k-step kk (rows 16 kk ..): P^T split into bf16
      // hi and lo parts, and dS^T = P^T (dP^T - D) rounded to bf16.
      uint32_t ph[BQ / 16][4], pl[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i0 = 8 * kk + 2 * r;
          const int row = 8 * (i0 / 4) + 2 * tq4;
          const float p0 = sT[i0], p1 = sT[i0 + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              p0 - __low2float(hi), p1 - __high2float(hi));
          const __nv_bfloat162 d2 = __floats2bfloat162_rn(
              p0 * (dpT[i0] - ls[BQ + row]),
              p1 * (dpT[i0 + 1] - ls[BQ + row + 1]));
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
          as[kk][r] = *reinterpret_cast<const uint32_t*>(&d2);
        }
      }

      // dV += P^T dO (three split products, the small ones first), dK +=
      // dS^T Q.
      tmw::fence_acc(acc_dk);
      tmw::fence_acc(acc_dv);
      tmw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        tmw::Wgmma<D>::template rs<1>(acc_dv, pl[kk],
                                      mnmajor_desc(dha, L::Q_CHUNK, kk));
      if constexpr (LO) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          tmw::Wgmma<D>::template rs<1>(
              acc_dv, ph[kk], mnmajor_desc(dha + L::TILE, L::Q_CHUNK, kk));
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        tmw::Wgmma<D>::template rs<1>(acc_dv, ph[kk],
                                      mnmajor_desc(dha, L::Q_CHUNK, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        tmw::Wgmma<D>::template rs<1>(acc_dk, as[kk],
                                      mnmajor_desc(qa, L::Q_CHUNK, kk));
      tmw::wgmma_commit();
      tmw::wgmma_wait<0>();
      tmw::fence_acc(acc_dk);
      tmw::fence_acc(acc_dv);
      tmw::mbar_arrive(&empty[s]);
    }

    // dk, dv: element i = 4 j + 2 hh + cc at key 16 w + g + 8 hh, column
    // 8 j + 2 tq4 + cc.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + 64 * c + 16 * w + g + 8 * hh;
      if (key >= Tkv) continue;
      float* dkr = dk + vbase + (long)key * kvstride;
      float* dvr = dv + vbase + (long)key * kvstride;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * tq4;
        *reinterpret_cast<float2*>(dkr + col) =
            make_float2(scale * acc_dk[4 * j + 2 * hh],
                        scale * acc_dk[4 * j + 2 * hh + 1]);
        *reinterpret_cast<float2*>(dvr + col) =
            make_float2(acc_dv[4 * j + 2 * hh], acc_dv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <int D, bool LO>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dohi, const bf16* dolo, const float* dof,
                   const float* lse, const float* dvec, float* dk, float* dv,
                   int B, int Tq, int Tkv, int H, int Hkv, float scale,
                   tmf::Band band, cudaStream_t stream) {
  using L = Layout<D, LO>;
  const long e = sizeof(bf16);
  CUtensorMap tq, tk, tv, tdh, tdl;
  cudaError_t err =
      tmw::make_map_bf16_4d(&tq, q, D, H, Tq, B, D * e, H * D * e,
                            (long)Tq * H * D * e, BQ);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tk, k, D, Hkv, Tkv, B, D * e, Hkv * D * e,
                                (long)Tkv * Hkv * D * e, BKV);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tv, v, D, Hkv, Tkv, B, D * e, Hkv * D * e,
                                (long)Tkv * Hkv * D * e, BKV);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tdh, dohi, D, H, Tq, B, D * e, H * D * e,
                                (long)Tq * H * D * e, BQ);
  if (err == cudaSuccess)
    err = tmw::make_map_bf16_4d(&tdl, LO ? dolo : dohi, D, H, Tq, B, D * e,
                                H * D * e, (long)Tq * H * D * e, BQ);
  if (err != cudaSuccess) return err;
  const auto kernel = flash_bwd_dkv_wgmma_kernel<D, LO>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tkv + BKV - 1) / BKV, Hkv, B);
  kernel<<<grid, NT, L::BYTES, stream>>>(tq, tk, tv, tdh, tdl, v, dohi, dof,
                                         lse, dvec, dk, dv, Tq, Tkv, H, Hkv,
                                         scale, band);
  return cudaGetLastError();
}

template <bool LO>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const bf16* dohi,
             const bf16* dolo, const float* dof, const float* lse,
             const float* dvec, float* dk, float* dv, int B, int Tq, int Tkv,
             int H, int Hkv, int D, float scale, tmf::Band band,
             cudaStream_t s) {
  switch (D) {
    case 64: return launch<64, LO>(q, k, v, dohi, dolo, dof, lse, dvec, dk, dv, B, Tq, Tkv, H, Hkv, scale, band, s);
    case 128: return launch<128, LO>(q, k, v, dohi, dolo, dof, lse, dvec, dk, dv, B, Tq, Tkv, H, Hkv, scale, band, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Tq, H, D], k / v / dk / dv [B, Tkv, Hkv, D] with q / k / v bf16 and
// D 64 or 128; dO as do_hi [B, Tq, H, D] bf16 and, for an f32 dO, its lo
// part do_lo (bf16) and dO itself dof (f32), both null for a bf16 dO;
// lse / dvec [B, H, Tq] f32; dk, dv f32.  All contiguous, 16-byte aligned,
// on the device.  Returns the launch's CUDA error code.
extern "C" int tm_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* do_hi,
                                     const void* do_lo, const float* dof,
                                     const float* lse, const float* dvec,
                                     float* dk, float* dv, int B, int Tq,
                                     int Tkv, int H, int Hkv, int D,
                                     float scale, int causal, int window,
                                     int q_offset, int kv_offset,
                                     void* stream) {
  const tmf::Band band{q_offset, kv_offset, Tkv, causal, window};
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* hi = static_cast<const bf16*>(do_hi);
  const auto* lo = static_cast<const bf16*>(do_lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((lo == nullptr) != (dof == nullptr)) return (int)cudaErrorInvalidValue;
  return lo ? dispatch<true>(qb, kb, vb, hi, lo, dof, lse, dvec, dk, dv, B, Tq,
                             Tkv, H, Hkv, D, scale, band, s)
            : dispatch<false>(qb, kb, vb, hi, lo, dof, lse, dvec, dk, dv, B,
                              Tq, Tkv, H, Hkv, D, scale, band, s);
}
