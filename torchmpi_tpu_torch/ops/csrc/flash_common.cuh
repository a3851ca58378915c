// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the score mask and the block-skip
// predicate.  Forward and backward MUST mask and skip identically (the
// backward recomputes p against the forward's lse), so all three kernels
// use these two functions, as the TPU kernels share _valid_mask and
// _block_live (torchmpi_tpu/ops/flash.py:243, :94).
#pragma once

#include <cuda_runtime.h>

namespace tmf {

// Finite stand-in for -inf in masked scores: exp() of it is exactly 0 and
// the running-max rescale never sees (-inf) - (-inf).
constexpr float NEG_INF = -1e30f;

// Threads per block of every flash kernel; the register tiles below assume
// 16 x 16 threads.
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` rows of D floats, starting at time step t0 of a [T, stride]
// strided source, into shared memory with row pitch `pitch`; rows past T
// read as zero (the ragged edge).
template <int D>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int pitch,
                                          const float* __restrict__ src,
                                          long stride, int t0, int rows, int T) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = t0 + r;
    dst[r * pitch + d] = t < T ? src[(long)t * stride + d] : 0.f;
  }
}

}  // namespace tmf

// The text of a CUDA error code that a launcher returned.  Each kernel
// library carries its own copy; ctypes looks it up per library.
extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
