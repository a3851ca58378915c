// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the score mask and the block-skip
// predicates, and the tensor-core building blocks all three use.  Forward
// and backward MUST mask and skip identically (the backward recomputes p
// against the forward's lse), so all three kernels use these functions, as
// the TPU kernels share _valid_mask and _block_live
// (torchmpi_tpu/ops/flash.py:243, :94).
//
// Tensor cores: every product is mma.sync m16n8k8 in TF32 in the
// error-compensated three-product form (mma3): x = x_hi + x_lo with x_hi
// in TF32 and x_lo the f32 rest (split, below), and a b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi in f32, so a product keeps f32's accuracy (TF32
// alone keeps ~3 digits; the kernels are held to 1e-4 of the f32 plain
// versions).  The tensor cores' f32 accumulation
// does not round to nearest and a long sum kept in an mma accumulator
// drifts, so the kernels sum only short runs there (two k-steps of a
// D-contraction, one block of a key or row contraction) and the long sums
// in f32 on the CUDA cores.
//
// bf16 operands take other routes through the same masks and block skips.
// The forward's (flash_fwd.cu, the launchers with a _bf16 suffix) keeps
// its tiles: the products whose two operands are bf16 in the JAX kernel
// (Q K^T, P V) run mma.sync m16n8k16 with bf16 operands and an f32
// accumulator, one product each, fed by ldmatrix from bf16 tiles (half the
// bytes of an f32 tile); P is rounded to bf16 where the JAX kernel rounds
// it (torchmpi_tpu/ops/flash.py:321).  The backward's are
// flash_bwd_dq_wgmma.cu and flash_bwd_dkv_wgmma.cu (wgmma on TMA tiles,
// the products with an f32 operand as bf16 splits).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tmf {

using bf16 = __nv_bfloat16;

// Finite stand-in for -inf in masked scores: exp() of it is exactly 0 and
// the running-max rescale never sees (-inf) - (-inf).
constexpr float NEG_INF = -1e30f;

// Threads per block of every flash kernel: 8 warps.
constexpr int NT = 256;

struct Band {
  int q_offset;   // global position of q row 0
  int kv_offset;  // global position of k row 0
  int kv_len;     // valid keys
  int causal;     // keep k <= q
  int window;     // > 0: also keep q - k < window
};

// Is (q, k), in global positions, a valid score?
__device__ __forceinline__ bool valid(const Band& b, int qg, int kg) {
  bool v = kg < b.kv_offset + b.kv_len;
  if (b.causal) {
    v = v && qg >= kg;
    if (b.window > 0) v = v && qg - kg < b.window;
  }
  return v;
}

// Does the block of bq query rows from q_first and bk keys from k_first
// (global positions) hold ANY valid score?  Dead blocks are skipped: for
// causal attention that halves the work, with a window the live band is
// O(window) keys per query.
__device__ __forceinline__ bool block_live(const Band& b, int q_first, int bq,
                                           int k_first, int bk) {
  bool live = k_first < b.kv_offset + b.kv_len;
  if (b.causal) {
    live = live && k_first <= q_first + (bq - 1);
    if (b.window > 0) live = live && k_first + (bk - 1) >= q_first - (b.window - 1);
  }
  return live;
}

// Does that block hold NO masked score (JAX's _block_full)?  Then the
// mask is the identity and a kernel may skip it: every key inside the kv
// length, in the causal past of the block's first q row, and (window)
// inside the window of its last q row.
__device__ __forceinline__ bool block_full(const Band& b, int q_first, int bq,
                                           int k_first, int bk) {
  const int k_last = k_first + (bk - 1);
  bool full = k_last < b.kv_offset + b.kv_len;
  if (b.causal) {
    full = full && k_last <= q_first;
    if (b.window > 0) full = full && q_first + (bq - 1) - k_first < b.window;
  }
  return full;
}

// Row pitch (floats) of the swizzled [rows][D] tiles: the swizzle XORs
// column bits 2-4, so a row spans at least 32 floats.
template <int D>
__host__ __device__ constexpr int pitch() {
  return D < 32 ? 32 : D;
}

// How a swizzled tile permutes the eight 16-byte groups of a 32-float span
// of row r.  Both keep ldmatrix conflict-free (eight consecutive rows at
// one logical group land in eight distinct groups).  kRowsT (r's bits
// 0-1 to group bits 1-2, bit 2 to bit 0) also spreads scalar reads of rows
// t = 0..3 over all 32 banks, the dK/dV kernel's B fragments; kRows2T
// (group ^ (r & 7)) spreads rows 2t and 2t + 1, the B fragments of a
// product whose A operand is a C fragment used in place (P V, dS K).
enum Swizzle { kRowsT, kRows2T };

// Offset of element (r, c) in a swizzled tile.
template <int D, Swizzle SW = kRowsT>
__device__ __forceinline__ int swz(int r, int c) {
  const int x = SW == kRowsT ? (((r & 3) << 3) | (r & 4)) : ((r & 7) << 2);
  return r * pitch<D>() + (c ^ x);
}

// Per-lane offsets (floats) of the fragment loads from kRows2T tiles, so
// that every load adds only compile-time constants to one of 16 registers
// (the swizzle XORs column bits 2-4 only, so a 32-column span moves as a
// whole).  With li, lj = lane % 8, lane / 8 and g, t = lane / 4, lane % 4:
//   A by ldmatrix, 16 rows from row 0, k-step s: a[s % 4] + 32 (s / 4);
//   B by ldmatrix, n-tiles 2p and 2p + 1 (rows 16p ..), k-step s:
//     b[s % 4] + 32 (s / 4) + 16 p P;
//   B as scalars at keys 8kk + 2t and 8kk + 2t + 1, column 8n + g (the
//   k-rows of a product whose A operand is a C fragment used in place):
//     v0[n % 4] and v1[n % 4], + 8 kk P + 32 (n / 4).
template <int D>
struct Offs2T {
  int a[4], b[4], v0[4], v1[4];
  __device__ __forceinline__ explicit Offs2T(int lane) {
    constexpr int P = pitch<D>();
    const int li = lane % 8, lj = lane / 8, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = (li + 8 * (lj & 1)) * P + ((8 * j + 4 * (lj >> 1)) ^ (4 * li));
      b[j] = (li + 8 * (lj >> 1)) * P + ((8 * j + 4 * (lj & 1)) ^ (4 * li));
      v0[j] = 2 * t * P + ((8 * j + g) ^ (8 * t));
      v1[j] = (2 * t + 1) * P + ((8 * j + g) ^ (8 * t + 4));
    }
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [t0, t0 + rows) of a [T, stride] source into a swizzled tile; rows
// past T read as zero (the ragged edge).  All NT threads take part.
template <int D, Swizzle SW = kRowsT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long stride, int t0, int rows,
                                          int T) {
  constexpr int G = D / 4;  // 16-byte groups a row
  for (int idx = threadIdx.x; idx < rows * G; idx += NT) {
    const int r = idx / G, c = (idx % G) * 4, t = t0 + r;
    cp_async16(dst + swz<D, SW>(r, c),
               src + (t < T ? (long)t * stride + c : 0), t < T);
  }
}

// Four 8 x 4 blocks of 32-bit words from shared memory (ldmatrix.x4 of
// 8 x 8 16-bit matrices): lane l gives the address of row l % 8 of block
// l / 8, and gets word l % 4 of row l / 4 of each block.
__device__ __forceinline__ void ldsm4(float (&x)[4], const float* p) {
  unsigned r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]);
}

// How x splits into x = hi + lo for the three-product form.  kNearest: hi =
// tf32(x) rounded to nearest (cvt.rna, a compare and a select besides the
// add), |lo| <= 2^-11 |x|; the dK/dV kernel's split.  kTruncate: hi is x
// itself, whose low 13 bits the mma ignores, so it reads x truncated to
// TF32, and lo = x minus that truncation (one logical op and one add),
// |lo| < 2^-10 |x|.  Either way the three products miss only a_lo b_lo and
// the TF32 truncation of lo: under 2^-19 of |a b| with kTruncate, far
// inside the kernels' 1e-4 (x must be finite).
enum Split { kNearest, kTruncate };

template <Split SP = kNearest>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  if (SP == kNearest) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
  }
}

// An A fragment (16 x 8, row-major) and a B fragment (8 x 8, k-major) of
// m16n8k8, each as its hi and lo TF32 parts.  Lane (g, t) = (lane / 4,
// lane % 4) holds A at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B
// at (k t, n g), (k t + 4, n g), and C at (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1).
struct FragA {
  unsigned hi[4], lo[4];
  template <Split SP = kNearest>
  __device__ __forceinline__ void set(const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split<SP>(x[i], hi[i], lo[i]);
  }
};
struct FragB {
  unsigned hi[2], lo[2];
  template <Split SP = kNearest>
  __device__ __forceinline__ void set(float x0, float x1) {
    split<SP>(x0, hi[0], lo[0]);
    split<SP>(x1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in the three-product form, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// c = [16 rows x 8 NK columns] of A B^T, for a warp's 16 rows of A (from
// row 0 of a) and the 8 NK rows of b, both kRows2T tiles, contracted over
// D 32 columns at a time: two k-steps a short run on the tensor cores
// (kTruncate splits), the runs summed in f32.  ldmatrix blocks: A's rows
// 0-7 / 8-15 by columns 0-3 / 4-7; B's rows of n-tiles 2p / 2p + 1 by
// columns 0-3 / 4-7.  Element e of n-tile n lands at row g (+ 8 for e >= 2),
// column 8n + 2t (+ 1 for odd e).
template <int D, int NK>
__device__ __forceinline__ void product_abt(float (&c)[NK][4], const float* a,
                                            const float* b,
                                            const Offs2T<D>& off) {
  constexpr int P = pitch<D>();
  constexpr int KC = D < 32 ? D / 8 : 4;  // k-steps of D a 32-column span
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll 1
  for (int col = 0; col < D; col += 32) {
#pragma unroll
    for (int s2 = 0; s2 < KC; s2 += 2) {
      float part[NK][4] = {};
#pragma unroll
      for (int kj = s2; kj < s2 + 2; ++kj) {
        float x[4];
        ldsm4(x, a + col + off.a[kj]);
        FragA fa;
        fa.set<kTruncate>(x);
#pragma unroll
        for (int p = 0; p < NK / 2; ++p) {
          float y[4];
          ldsm4(y, b + col + off.b[kj] + 16 * p * P);
          FragB b0, b1;
          b0.set<kTruncate>(y[0], y[1]);
          b1.set<kTruncate>(y[2], y[3]);
          mma3(part[2 * p], fa, b0);
          mma3(part[2 * p + 1], fa, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 route
// ---------------------------------------------------------------------------

// Row pitch (bf16 elements) of the swizzled bf16 tiles: the swizzle XORs
// the 16-byte group index (8 elements) with row bits 0-2, so a row spans
// at least 8 groups.  Eight consecutive rows at one logical group land in
// eight distinct groups: ldmatrix, plain or transposed, is conflict-free.
template <int D>
__host__ __device__ constexpr int pitch_bf() {
  return D < 64 ? 64 : D;
}

template <int D>
__device__ __forceinline__ int swzb(int r, int c) {
  return r * pitch_bf<D>() + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// Rows [t0, t0 + rows) of a bf16 [T, stride] source into a swizzled bf16
// tile, asynchronously; rows past T read as zero.  All NT threads.
template <int D>
__device__ __forceinline__ void load_tile_bf(bf16* dst, const bf16* src,
                                             long stride, int t0, int rows,
                                             int T) {
  constexpr int G = D / 8;  // 16-byte groups a row
  for (int idx = threadIdx.x; idx < rows * G; idx += NT) {
    const int r = idx / G, c = (idx % G) * 8, t = t0 + r;
    cp_async16(dst + swzb<D>(r, c),
               src + (t < T ? (long)t * stride + c : 0), t < T);
  }
}

// A tile of the kernel's operand type: f32 (load_tile) or bf16.
template <int D, Swizzle SW>
__device__ __forceinline__ void load_in(float* dst, const float* src,
                                        long stride, int t0, int rows, int T) {
  load_tile<D, SW>(dst, src, stride, t0, rows, T);
}
template <int D, Swizzle SW>
__device__ __forceinline__ void load_in(bf16* dst, const bf16* src,
                                        long stride, int t0, int rows, int T) {
  load_tile_bf<D>(dst, src, stride, t0, rows, T);
}

// ldmatrix of 8 x 8 bf16 matrices: x4 plain, x4 transposed.
__device__ __forceinline__ void ldsm4u(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Two f32 values rounded to nearest bf16 in one register, lo in the low
// half (the order of an m16n8k16 fragment's pair).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// d += a b, m16n8k16, bf16 operands, f32 accumulator.  Lane (g, t) holds A
// at (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..), B at
// (k 2t..2t+1, n g), (k 2t + 8.., n g), and C as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r0.. r0 + 15 and columns c0 .. c0 + 15 of a bf16
// tile: ldmatrix blocks rows 0-7 / 8-15 by columns 0-7 / 8-15.
template <int D>
__device__ __forceinline__ void lda_bf(unsigned (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  const int li = lane & 7, mi = lane >> 3;
  ldsm4u(a, tile + swzb<D>(r0 + li + 8 * (mi & 1), c0 + 8 * (mi >> 1)));
}

// The B fragments of n-tiles n0 and n0 + 8 whose n runs down the tile's
// rows and k along them (columns c0 .. c0 + 15): B = tile^T, as K in Q K^T.
// b[0], b[1] for n0; b[2], b[3] for n0 + 8.
template <int D>
__device__ __forceinline__ void ldb_bf(unsigned (&b)[4], const bf16* tile,
                                       int n0, int c0, int lane) {
  const int li = lane & 7, mi = lane >> 3;
  ldsm4u(b, tile + swzb<D>(n0 + li + 8 * (mi >> 1), c0 + 8 * (mi & 1)));
}

// The B fragments of n-tiles n0 and n0 + 8 whose k runs down the tile's
// rows (k0 .. k0 + 15) and n along them: B = tile, as V in P V (ldmatrix
// transposed).  b[0], b[1] for n0; b[2], b[3] for n0 + 8.
template <int D>
__device__ __forceinline__ void ldbt_bf(unsigned (&b)[4], const bf16* tile,
                                        int k0, int n0, int lane) {
  const int li = lane & 7, mi = lane >> 3;
  ldsm4t(b, tile + swzb<D>(k0 + li + 8 * (mi & 1), n0 + 8 * (mi >> 1)));
}

// c = [16 rows x 8 NK columns] of A B^T for rows ar0 .. ar0 + 15 of bf16
// tile a and rows 0 .. 8 NK - 1 of bf16 tile b, contracted over D on the
// tensor cores, one bf16 product (the f32 accumulator of a bf16 product
// holds its D terms far inside bf16's rounding).  Element e of n-tile n
// lands at row g (+ 8 for e >= 2), column 8n + 2t (+ 1 for odd e).
template <int D, int NK>
__device__ __forceinline__ void product_abt_bf(float (&c)[NK][4],
                                               const bf16* a, int ar0,
                                               const bf16* b, int lane) {
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 16) {
    unsigned fa[4];
    lda_bf<D>(fa, a, ar0, c0, lane);
#pragma unroll
    for (int p = 0; p < NK / 2; ++p) {
      unsigned fb[4];
      ldb_bf<D>(fb, b, 16 * p, c0, lane);
      mma_bf16(c[2 * p], fa, fb[0], fb[1]);
      mma_bf16(c[2 * p + 1], fa, fb[2], fb[3]);
    }
  }
}

// The A fragments of a product whose A operand is a C fragment used in
// place (P V, dS K): k-step kk takes n-tiles 2kk and 2kk + 1 of c, rounded
// to bf16.
template <int NK>
__device__ __forceinline__ void c_as_a_bf(unsigned (&a)[4],
                                          const float (&c)[NK][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The bf16 wgmma backward's dP of one (q row, key) as the f32 plain
// version's matmul sums it: an f32 FMA chain over d in order, from dO (f32
// when LO, else bf16) and V in device memory, at the rows' offsets.
template <int D, bool LO>
__device__ __forceinline__ float dp_in_order(const float* dof,
                                             const bf16* dohi, long orow,
                                             const bf16* v, long vrow) {
  float a = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    const float x = LO ? dof[orow + d] : __bfloat162float(dohi[orow + d]);
    a = fmaf(x, __bfloat162float(v[vrow + d]), a);
  }
  return a;
}

}  // namespace tmf

// The text of a CUDA error code that a launcher returned.  Each kernel
// library carries its own copy; ctypes looks it up per library.
extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
