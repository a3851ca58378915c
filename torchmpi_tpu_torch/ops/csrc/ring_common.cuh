// ring_common.cuh: the element adds of the ring kernels (ring_direct.cu),
// one per dtype, in the ring's arithmetic.
//
// The TPU kernels (torchmpi_tpu/ops/ring.py) move a ring chunk hop by hop
// with remote DMAs and add each arriving chunk to the local one.  The
// Hopper kernels walk no ring: they load every rank's value of an element
// and fold the values in the order the ring would have added them
// (ring_direct.cu), with these adds, so the result is bitwise the ring's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmr {

constexpr int kThreads = 512;

// add: one element; add4: the elements of one 16-byte vector, lane by lane.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
    uint4 r;
    r.x = __float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x));
    r.y = __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y));
    r.z = __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z));
    r.w = __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w));
    return r;
  }
};

// int32 adds wrap, as XLA's and PyTorch's do (unsigned arithmetic: no
// signed-overflow undefined behaviour).
template <>
struct Elem<int> {
  static __device__ __forceinline__ int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
    return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// bf16 adds in float32 and rounds to nearest even, as XLA's bf16 add and
// PyTorch's do (for two bf16 operands this is the correctly rounded sum).
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  float2 fx = __bfloat1622float2(x), fy = __bfloat1622float2(y);
  __nv_bfloat162 r = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
  return *reinterpret_cast<unsigned*>(&r);
}

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  static __device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
    return make_uint4(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y),
                      add_bf16x2(a.z, b.z), add_bf16x2(a.w, b.w));
  }
};

}  // namespace tmr

extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
