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
#pragma once

#include <cuda_runtime.h>

namespace tmf {

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
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

}  // namespace tmf

// The text of a CUDA error code that a launcher returned.  Each kernel
// library carries its own copy; ctypes looks it up per library.
extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
