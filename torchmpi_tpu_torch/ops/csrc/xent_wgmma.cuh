// The Hopper product of the fused loss (xent_fwd.cu, xent_bwd_dx.cu,
// xent_bwd_dw.cu): a warp-specialised wgmma GEMM fed by TMA, with the
// epilogue run on the accumulators in registers, and the kernel that forms
// the logits' gradient g on it.
//
// One block computes one BM x BN = 128 x 256 tile of C = A . B over the
// whole depth K, in f32, and hands its accumulators to the epilogue `Epi`;
// every output element is summed by one block in one order, so two calls
// give the same bits (no atomics, no split of K across blocks).  384
// threads, three warpgroups:
//   warpgroup 0, the producer: after setmaxnreg.dec its first thread walks
//     the depth in BK = 64 steps and, per step, waits for a free stage of
//     the STAGES = 4 ring (the stage's `empty` mbarrier), arms its `full`
//     mbarrier with the stage's bytes and issues six TMA loads of 64 x 64
//     bf16 boxes (2 of A, 4 of B, 48 KB) into it;
//   warpgroups 1 and 2, the consumers (setmaxnreg.inc to 232 registers):
//     each owns 64 rows of the tile and 128 f32 accumulators a thread; per
//     step it waits for the stage's `full` barrier, issues four
//     wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate) on it, keeps
//     one step's wgmma group in flight, and releases the previous stage.
// Operands are read as they are stored, through one tensor map per tensor
// (its natural row-major [rows, cols] view, 64 x 64 boxes, 128-byte
// swizzle).  An operand is K-major when its depth runs along the stored
// rows (A = x or g, [M, K]; B = W read as [N = E, K = V]) and MN-major
// when the depth runs down the stored columns (A = x^T for dW; B = W as
// [K = E, N = V] for g, and g as [K = rows, N = V] for dW): wgmma takes
// bf16 operands of either kind from shared memory (its trans-a / trans-b
// flags).  TMA fills a box's part outside the tensor with zeros, which
// covers the ragged M, N and K edges; the epilogues mask their stores
// (and the forward's statistics the zero columns past V).
//
// The TMA path needs every row pitch a multiple of 16 bytes and 16-byte
// aligned bases: E and V multiples of 8 (tma_ok, mirrored by the
// wrapper's route choice in ops/xent.py).  Other shapes take the cp.async /
// wmma product of xent_common.cuh.
//
// Below it, gemm_tf32_kernel: the same warp-specialised skeleton for
// float32 operands (TF32 wgmma in the three-product form on K-major hi and
// lo tiles, the wgmma_tf32 route of the forward and the backward), the
// kernel that makes its K-major copies, and the float32 g kernel on it.
//
// Tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda), and passed as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"
#include "xent_common.cuh"

namespace tmw {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int NT = 384;                       // producer + 2 consumer warpgroups
constexpr int BOX = 64;                       // TMA box edge (128 bytes of bf16)
constexpr int BOX_BYTES = BOX * BOX * 2;      // 8 KB
constexpr int A_BOXES = BM / BOX, B_BOXES = BN / BOX;
constexpr int STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;  // 48 KB
constexpr int ACC = BN / 2;                   // f32 accumulators a consumer thread
// The ring, plus room to align it to the 1024 bytes of a swizzle atom.
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024;

// The mbarrier, TMA and wgmma wrappers (smem_addr, mbar_*, tma_load,
// sw128_desc, wgmma_fence / commit / wait, fence_acc, wgmma_256,
// wgmma_tf32_128) and the host's encode_tiled live in wgmma_common.cuh,
// shared with the bf16 flash backward.

// The descriptor of k-step `kk` (16 deep) of an operand tile whose box j
// (64 rows of M or N) starts at base + j * BOX_BYTES.  K-major: the box is
// [64 mn][64 k] with 128-byte rows; 8-row groups lie 1024 bytes apart and a
// k-step is 32 bytes along the row.  MN-major: the box is [64 k][64 mn];
// a k-step is 16 rows (2048 bytes), 8-deep groups lie 1024 bytes apart and
// the next 64 of M or N is the next box.
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int kk) {
  return MN ? mnmajor_desc(base, BOX_BYTES, kk)
            : kmajor_desc(base, BOX_BYTES, kk);
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

// C[M, N] = A . B over depth K for the block's tile (blockIdx.x: rows of
// BM, blockIdx.y: columns of BN); then epi(d, r0, c0) with the consumer
// thread's accumulators, its first row r0 and first column c0 (the rows
// r0, r0 + 8 and columns c0 + 8 j, + 1 of the fragment above).  ta / tb:
// the tensor maps of A's and B's storage; A_MN / B_MN: MN-major.
template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, int K, const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer.  From here on the roles never meet at a block barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], STAGE_BYTES);
        unsigned char* st = smem + s * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < A_BOXES; ++j) {
          if (A_MN) tma_load(st + j * BOX_BYTES, &ta, &full[s], m0 + j * BOX, k0);
          else      tma_load(st + j * BOX_BYTES, &ta, &full[s], k0, m0 + j * BOX);
        }
#pragma unroll
        for (int j = 0; j < B_BOXES; ++j) {
          unsigned char* dst = st + (A_BOXES + j) * BOX_BYTES;
          if (B_MN) tma_load(dst, &tb, &full[s], n0 + j * BOX, k0);
          else      tma_load(dst, &tb, &full[s], k0, n0 + j * BOX);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this consumer's 64 rows of the tile
    float d[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = smem_addr(smem + s * STAGE_BYTES) + c * BOX_BYTES;
      const uint32_t b = smem_addr(smem + s * STAGE_BYTES) + A_BOXES * BOX_BYTES;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_256<A_MN, B_MN>(d, operand_desc<A_MN>(a, kk), operand_desc<B_MN>(b, kk));
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the previous step's products are done
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(d);
    const int t = threadIdx.x % 128, lane = t % 32;
    epi(d, m0 + c * 64 + (t / 32) * 16 + lane / 4, n0 + 2 * (lane % 4));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// May the TMA path read an operand with row pitch ld (elements) at p?
inline bool tma_ok(const void* p, long ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The map of a row-major [rows, cols] matrix of `type` at p, row pitch
// `pitch` bytes, in boxes of 128 bytes (`inner` elements) x 64 rows with the
// 128-byte swizzle; out-of-bounds reads are zeros.
inline cudaError_t encode_map(CUtensorMap* m, CUtensorMapDataType type,
                              cuuint32_t inner, const void* p, long rows,
                              long cols, long pitch) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {inner, BOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, type, 2, const_cast<void*>(p), dims, strides, box,
                         elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a row-major bf16 [rows, cols] matrix at p (pitch cols) in
// 64 x 64 boxes.
inline cudaError_t make_map(CUtensorMap* m, const void* p, long rows, long cols) {
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, BOX, p, rows, cols,
                    cols * (long)sizeof(bf16));
}

template <bool A_MN, bool B_MN, class Epi>
inline cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                               int M, int N, int K, const Epi& epi,
                               cudaStream_t st) {
  const auto kernel = gemm_kernel<A_MN, B_MN, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, NT, SMEM_BYTES, st>>>(ta, tb, K, epi);
  return cudaGetLastError();
}

// g = bf16((exp(z - lse) - onehot) . dl) on the accumulators of z = x . W
// (see tmx::xent_grad_kernel for the function and its TPU lines).
struct GradEpi {
  const int* labels;
  const float* lse;
  const float* dl;
  bf16* g;
  int rows, V;
  __device__ __forceinline__ void operator()(const float (&d)[ACC], int r0,
                                             int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows) continue;
      float l = lse[row];
      l = isfinite(l) ? l : 0.f;
      const int lab = labels[row];
      const float s = dl[row];
      bf16* out = g + (long)row * V;
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int col = c0 + 8 * j;  // even, and V is a multiple of 8
        if (col >= V) continue;
        const float p0 = expf(d[4 * j + 2 * h] - l) - (lab == col ? 1.f : 0.f);
        const float p1 = expf(d[4 * j + 2 * h + 1] - l) - (lab == col + 1 ? 1.f : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(p0 * s, p1 * s);
      }
    }
  }
};

// g for `rows` token rows on the wgmma product: A = x [rows, E] (K-major),
// B = W [E, V] (MN-major).
inline cudaError_t launch_grad(const bf16* x, const bf16* w, const int* labels,
                               const float* lse, const float* dl, bf16* g,
                               int rows, int E, int V, cudaStream_t st) {
  CUtensorMap tx, tw;
  cudaError_t e = make_map(&tx, x, rows, E);
  if (e == cudaSuccess) e = make_map(&tw, w, E, V);
  if (e != cudaSuccess) return e;
  return launch_gemm<false, true>(tx, tw, rows, V, E,
                                  GradEpi{labels, lse, dl, g, rows, V}, st);
}

// ---------------------------------------------------------------------------
// The TF32 product: float32 operands in the three-product form
// ---------------------------------------------------------------------------
//
// gemm_tf32_kernel is gemm_kernel's sibling for float32 operands (the
// wgmma_tf32 route: the forward's statistics, the g, dx and dW products).
// Each operand comes as two K-major [rows, K] matrices: hi, the float32
// values themselves, and lo = x - trunc_tf32(x) (x with its low 13 bits
// cleared), which the wrapper prepares in device memory
// (tf32_split_kernel).  The tensor core reads a float32 as TF32 by
// ignoring those 13 bits, so hi is read as trunc_tf32(x), and
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// issued in that order, misses only a_lo b_lo and the TF32 truncation of
// lo: under 2^-19 |a b| (flash_common.cuh, kTruncate), where TF32 alone
// keeps ~3 digits.  wgmma takes tf32 operands K-major only (PTX gives no
// transpose for them), hence the K-major copies.
//
// One block computes one BM x TBN = 128 x 128 tile over the whole depth, in
// stages of TBK = 32 (128 bytes of float32, one swizzle row): per stage the
// producer's first thread issues eight TMA boxes of 64 rows x 32 (8 KB
// each: A hi, A lo, B hi and B lo, two boxes each, 64 KB), into a ring of
// TSTAGES = 3 (197,632 bytes with the alignment slack, one block an SM);
// each consumer warpgroup (setmaxnreg.inc to 232 registers) owns 64 rows
// and per stage issues 4 k-steps x 3 wgmma.mma_async m64n128k8 (f32 +=
// tf32 x tf32) into a partial sum `part`.  The tensor cores' f32
// accumulation does not round to nearest, and one accumulator over dx's
// depth of 32,768 drifts, so every TFLUSH = 4 stages (128 of depth) the
// consumer waits for its products, adds `part` to the tile's sum `acc` on
// the CUDA cores in f32 and starts a fresh `part`: two 64-register
// fragments, 128 f32 registers a thread as the bf16 kernel's one 256-wide
// fragment.  One accumulator over the whole
// depth put dx at the flagship 1.28e-4 x max|ref| off the plain float32
// version, flushes every 2 to 16 stages 1.2-1.3e-5, at the same speed
// (scripts/torch_xent_tf32_variants.py, H100).  Every output element is
// summed by one block in one order: two calls give the same bits.

constexpr int TBN = 128, TBK = 32, TSTAGES = 3, TFLUSH = 4;
constexpr int TB_BOXES = TBN / BOX;
constexpr int TSTAGE_BYTES = 2 * (A_BOXES + TB_BOXES) * BOX_BYTES;  // 64 KB
constexpr int TACC = TBN / 2;  // f32 registers of one fragment a thread
constexpr size_t TSMEM_BYTES = TSTAGES * TSTAGE_BYTES + 1024;
static_assert(TBK * sizeof(float) == 128, "a stage is one 128-byte swizzle row");

// Stage layout, in BOX_BYTES boxes: A hi, A lo, B hi, B lo.
constexpr int T_A_LO = A_BOXES, T_B_HI = 2 * A_BOXES,
              T_B_LO = 2 * A_BOXES + TB_BOXES;

// One consumer warpgroup's loop (c: its 64 rows of the tile): the stages'
// products into `part`, in groups of TFLUSH stages, each group's `part`
// added to `acc` once its products are done; then the epilogue.  The
// flush is straight-line code after a group's loop: in a branch inside
// it, on a condition ptxas could not prove uniform across the warpgroup,
// ptxas serialized the wgmmas (its warning C7518).
template <class Epi>
__device__ __forceinline__ void tf32_consume(unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             int c, int nk, int m0, int n0,
                                             const Epi& epi) {
  float acc[TACC], part[TACC];
#pragma unroll
  for (int i = 0; i < TACC; ++i) acc[i] = part[i] = 0.f;
  for (int k0 = 0, k1; k0 < nk; k0 = k1) {
    k1 = min(nk, k0 + TFLUSH);
    for (int kt = k0; kt < k1; ++kt) {
      const int s = kt % TSTAGES;
      mbar_wait(&full[s], (kt / TSTAGES) & 1);
      const uint32_t st = smem_addr(smem + s * TSTAGE_BYTES);
      const uint32_t a_hi = st + c * BOX_BYTES;
      const uint32_t a_lo = st + (T_A_LO + c) * BOX_BYTES;
      const uint32_t b_hi = st + T_B_HI * BOX_BYTES;
      const uint32_t b_lo = st + T_B_LO * BOX_BYTES;
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 8; ++kk) {
        wgmma_tf32_128(part, operand_desc<false>(a_lo, kk), operand_desc<false>(b_hi, kk));
        wgmma_tf32_128(part, operand_desc<false>(a_hi, kk), operand_desc<false>(b_lo, kk));
        wgmma_tf32_128(part, operand_desc<false>(a_hi, kk), operand_desc<false>(b_hi, kk));
      }
      wgmma_commit();
      fence_acc(part);
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > k0) mbar_arrive(&empty[(kt - 1) % TSTAGES]);
    }
    wgmma_wait<0>();  // every product of the group is done
    fence_acc(part);
    mbar_arrive(&empty[(k1 - 1) % TSTAGES]);
#pragma unroll
    for (int i = 0; i < TACC; ++i) {
      acc[i] += part[i];
      part[i] = 0.f;
    }
  }
  const int t = threadIdx.x % 128, lane = t % 32;
  epi(acc, m0 + c * 64 + (t / 32) * 16 + lane / 4, n0 + 2 * (lane % 4));
}

// C[M, N] = A . B over depth K, A and B both K-major ([M, K] and [N, K]
// stored), each given as its hi map and its lo map; then epi(acc, r0, c0)
// as gemm_kernel's, on the TACC-register fragment.
template <class Epi>
__global__ void __launch_bounds__(NT, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap ta_lo,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tb_lo, int K,
                 const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[TSTAGES], empty[TSTAGES];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * TBN;
  const int nk = (K + TBK - 1) / TBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % TSTAGES, k0 = kt * TBK;
        if (kt >= TSTAGES) mbar_wait(&empty[s], ((kt / TSTAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], TSTAGE_BYTES);
        unsigned char* st = smem + s * TSTAGE_BYTES;
#pragma unroll
        for (int j = 0; j < A_BOXES; ++j) {
          tma_load(st + j * BOX_BYTES, &ta, &full[s], k0, m0 + j * BOX);
          tma_load(st + (T_A_LO + j) * BOX_BYTES, &ta_lo, &full[s], k0, m0 + j * BOX);
        }
#pragma unroll
        for (int j = 0; j < TB_BOXES; ++j) {
          tma_load(st + (T_B_HI + j) * BOX_BYTES, &tb, &full[s], k0, n0 + j * BOX);
          tma_load(st + (T_B_LO + j) * BOX_BYTES, &tb_lo, &full[s], k0, n0 + j * BOX);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    tf32_consume(smem, full, empty, wg - 1, nk, m0, n0, epi);
  }
}

// May the TMA path read a float32 operand with row pitch ld (elements) at
// p?  (Null is refused: every TF32 operand is required where it is asked.)
inline bool tma_ok_f32(const void* p, long ld) {
  return p != nullptr && ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The map of a row-major float32 [rows, cols] matrix at p with row pitch
// `pitch` elements, in boxes of 64 rows x 32.
inline cudaError_t make_map_f32(CUtensorMap* m, const float* p, long rows,
                                long cols, long pitch) {
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, TBK, p, rows, cols,
                    pitch * (long)sizeof(float));
}

// C[M, N] = A . B in the three-product form: A = (a, a_lo), [M, K] with
// row pitch lda; B = (b, b_lo), [N, K] with row pitch ldb.
template <class Epi>
inline cudaError_t launch_gemm_tf32(const float* a, const float* a_lo, long lda,
                                    const float* b, const float* b_lo, long ldb,
                                    int M, int N, int K, const Epi& epi,
                                    cudaStream_t st) {
  CUtensorMap ta, ta_lo, tb, tb_lo;
  cudaError_t e = make_map_f32(&ta, a, M, K, lda);
  if (e == cudaSuccess) e = make_map_f32(&ta_lo, a_lo, M, K, lda);
  if (e == cudaSuccess) e = make_map_f32(&tb, b, N, K, ldb);
  if (e == cudaSuccess) e = make_map_f32(&tb_lo, b_lo, N, K, ldb);
  if (e != cudaSuccess) return e;
  const auto kernel = gemm_tf32_kernel<Epi>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TSMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + TBN - 1) / TBN);
  kernel<<<grid, NT, TSMEM_BYTES, st>>>(ta, ta_lo, tb, tb_lo, K, epi);
  return cudaGetLastError();
}

// lo = x - trunc_tf32(x): exact in f32 (x and its truncation share their
// exponent), |lo| < 2^-10 |x|.  x must be finite.
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// The K-major copies of one float32 operand src [R, C] (row-major): lo
// [R, C] = tf32_lo(src) (LO), hi_t [C, ldt] = src^T and lo_t [C, ldt] =
// tf32_lo(src)^T (T; each written only where its pointer is not null; the
// transposed copies' columns R..ldt-1 are left as they are: no TMA map
// reaches them).  A 32 x 32 tile a block, transposed through shared memory
// so both the reads and the writes are coalesced.  Grid (ceil(C / 32),
// ceil(R / 32)), 32 x 8 threads.  LO and T are template flags, so that a
// profile tells the forward's copies (W^T and its lo part: T alone; x's lo
// part: LO alone) from the backward's in the step, which write both.
template <bool LO, bool T>
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ src, float* __restrict__ lo,
                  float* __restrict__ hi_t, float* __restrict__ lo_t, int R,
                  int C, int ldt) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    float v = 0.f;
    if (r < R && c < C) {
      v = src[(long)r * C + c];
      if (LO) lo[(long)r * C + c] = tf32_lo(v);
    }
    tile[i][tx] = v;
  }
  if (!T) return;
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c >= C || r >= R) continue;
    const float v = tile[tx][i];
    if (hi_t) hi_t[(long)c * ldt + r] = v;
    if (lo_t) lo_t[(long)c * ldt + r] = tf32_lo(v);
  }
}

inline cudaError_t launch_split(const float* src, float* lo, float* hi_t,
                                float* lo_t, int R, int C, int ldt,
                                cudaStream_t st) {
  const bool t = hi_t != nullptr || lo_t != nullptr;
  if (src == nullptr || (lo == nullptr && !t) || R <= 0 || C <= 0 ||
      (R + 31) / 32 > 65535 || (t && ldt < R))
    return cudaErrorInvalidValue;
  const auto kernel = !lo ? tf32_split_kernel<false, true>
                      : t ? tf32_split_kernel<true, true>
                          : tf32_split_kernel<true, false>;
  const dim3 grid((C + 31) / 32, (R + 31) / 32), block(32, 8);
  kernel<<<grid, block, 0, st>>>(src, lo, hi_t, lo_t, R, C, ldt);
  return cudaGetLastError();
}

// The row pitch of the chunk's transposed copies (x^T, g^T and their lo
// parts, [E or V, ldt]): rows rounded up to 4, a multiple of 16 bytes as
// TMA needs (ops/xent.py _tf32_pitch).
inline int tf32_pitch(int rows) { return (rows + 3) / 4 * 4; }

// g = (exp(z - lse) - onehot) . dl in float32 on the accumulators of z =
// x . W (see tmx::xent_grad_kernel for the function and its TPU lines),
// never rounded; written as each pointer that is not null asks: g and its
// lo part row-major [rows, V] (dx's A operand), g^T and its lo part [V,
// ldt] (dW's B operand).  A warp's transposed stores cover 8 consecutive
// rows of 4 columns: whole 32-byte sectors.
struct GradF32Epi {
  const int* labels;
  const float* lse;
  const float* dl;
  float* g;
  float* g_lo;
  float* gt;
  float* gt_lo;
  int rows, V, ldt;
  __device__ __forceinline__ void operator()(const float (&d)[TACC], int r0,
                                             int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows) continue;
      float l = lse[row];
      l = isfinite(l) ? l : 0.f;
      const int lab = labels[row];
      const float s = dl[row];
#pragma unroll
      for (int j = 0; j < TACC / 4; ++j) {
        const int col = c0 + 8 * j;  // even, and V is a multiple of 4
        if (col >= V) continue;
        const float v0 = (expf(d[4 * j + 2 * h] - l) - (lab == col ? 1.f : 0.f)) * s;
        const float v1 = (expf(d[4 * j + 2 * h + 1] - l) - (lab == col + 1 ? 1.f : 0.f)) * s;
        const long o = (long)row * V + col;
        if (g) *reinterpret_cast<float2*>(g + o) = make_float2(v0, v1);
        if (g_lo) *reinterpret_cast<float2*>(g_lo + o) = make_float2(tf32_lo(v0), tf32_lo(v1));
        const long t = (long)col * ldt + row;
        if (gt) {
          gt[t] = v0;
          gt[t + ldt] = v1;
        }
        if (gt_lo) {
          gt_lo[t] = tf32_lo(v0);
          gt_lo[t + ldt] = tf32_lo(v1);
        }
      }
    }
  }
};

// The wgmma_tf32 route's K-major copies as the backward launchers take them
// (ops/xent.py _tf32_workspace makes them; null where a call needs none):
// x_lo [rows, E]; xt, xt_lo [E, ldt]; wt, wt_lo [V, E]; w_lo [E, V]; g_lo
// [rows, V]; gt, gt_lo [V, ldt]; ldt = tf32_pitch(rows).
struct Tf32Ops {
  const float* x_lo;
  const float* xt;
  const float* xt_lo;
  const float* wt;
  const float* wt_lo;
  const float* w_lo;
  float* g_lo;
  float* gt;
  float* gt_lo;
};

// g for `rows` token rows on the TF32 product: A = (x, x_lo) [rows, E], B
// = (wt, wt_lo) = W^T [V, E]; the outputs as GradF32Epi.
inline cudaError_t launch_grad_tf32(const float* x, const float* x_lo,
                                    const float* wt, const float* wt_lo,
                                    const int* labels, const float* lse,
                                    const float* dl, float* g, float* g_lo,
                                    float* gt, float* gt_lo, int rows, int E,
                                    int V, cudaStream_t st) {
  return launch_gemm_tf32(
      x, x_lo, E, wt, wt_lo, E, rows, V, E,
      GradF32Epi{labels, lse, dl, g, g_lo, gt, gt_lo, rows, V, tf32_pitch(rows)},
      st);
}

}  // namespace tmw

// The K-major copies of a float32 operand for the wgmma_tf32 route
// (tmw::tf32_split_kernel): src [R, C]; lo [R, C], hi_t / lo_t [C, ldt],
// each nullable, at least one given.  Returns the CUDA error code.
extern "C" int tm_xent_split(const float* src, float* lo, float* hi_t,
                             float* lo_t, int R, int C, int ldt, void* stream) {
  return (int)tmw::launch_split(src, lo, hi_t, lo_t, R, C, ldt,
                                static_cast<cudaStream_t>(stream));
}
