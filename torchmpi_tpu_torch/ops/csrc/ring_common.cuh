// ring_common.cuh: the flag protocol, the element work and the cooperative
// launch shared by the ring kernels (ring_allreduce.cu, ring_rs_ag.cu).
//
// The TPU kernels (torchmpi_tpu/ops/ring.py) move a ring chunk with a remote
// DMA into the right neighbour's comm slot and count it on a DMA semaphore;
// the receiver acknowledges the slot with a semaphore signal to its left
// neighbour.  Here every rank's buffers are device pointers (n ranks on one
// card, or peers over NVLink), so a send is plain stores into the
// neighbour's comm slot followed by a release-increment of its flag word, and
// a wait is an acquire-spin on one's own flag word.  Flags are monotonic
// counters, zeroed before every launch: waiting for "one more signal" on a
// TPU semaphore becomes waiting for the counter to reach the number of
// signals the protocol has sent so far.  Acquire and release are at system
// scope, so the same code is right when the peers are other cards.
//
// A wait that runs past kSpinTimeoutNs traps: a protocol fault fails the
// launch with a CUDA error instead of hanging the caller.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmr {

constexpr int kThreads = 512;
constexpr unsigned long long kSpinTimeoutNs = 2000000000ull;  // 2 s

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_sys(unsigned* p, unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Block-wide: returns once *flag >= target.  One thread spins; the barrier
// then orders every thread's later reads after the acquire.
__device__ __forceinline__ void wait_geq(const unsigned* flag,
                                         unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire_sys(flag) < target) {
      if (global_ns() - t0 > kSpinTimeoutNs) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Block-wide: every thread's earlier stores (and reads) are ordered before
// the increment of *flag, which a peer acquires.
__device__ __forceinline__ void signal(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    red_release_sys(flag, 1u);
  }
}

// ---------------------------------------------------------------------------
// Element work: copy, and add in the schedule's order.  16-byte vectors over
// the aligned body, one element at a time over a ragged tail.  Reads of a
// comm slot, which a peer wrote, bypass L1 (__ldcg).
// ---------------------------------------------------------------------------

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

// dst[i] = src[i] for i in [0, len); src is a peer's slot when from_peer.
template <typename T, bool from_peer>
__device__ __forceinline__ void copy(T* __restrict__ dst,
                                     const T* __restrict__ src,
                                     long long len) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const long long nv = aligned ? len / V : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x)
    d4[i] = from_peer ? __ldcg(s4 + i) : s4[i];
  for (long long i = nv * V + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = from_peer ? __ldcg(src + i) : src[i];
}

// acc[i] = acc[i] + slot[i] for i in [0, len); slot is a peer's write.
template <typename T>
__device__ __forceinline__ void add_from_peer(T* __restrict__ acc,
                                              const T* __restrict__ slot,
                                              long long len) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(acc) |
                         reinterpret_cast<uintptr_t>(slot)) & 15) == 0;
  const long long nv = aligned ? len / V : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(slot);
  uint4* a4 = reinterpret_cast<uint4*>(acc);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x)
    a4[i] = Elem<T>::add4(a4[i], __ldcg(s4 + i));
  for (long long i = nv * V + threadIdx.x; i < len; i += blockDim.x)
    acc[i] = Elem<T>::add(acc[i], __ldcg(slot + i));
}

// ---------------------------------------------------------------------------
// Ring arithmetic and the launch
// ---------------------------------------------------------------------------

__device__ __forceinline__ int mod(int a, int n) { return ((a % n) + n) % n; }

// Start of slice b of a slot of E elements split B ways, a multiple of 8
// elements (16-byte aligned for every dtype here).
__device__ __forceinline__ long long slice_start(long long E, int B, int b) {
  return b >= B ? E : (E * b / B) / 8 * 8;
}

// Cooperative launch of ``kernel(args)`` on grid ``grid`` after zeroing
// ``nflags`` flag words on the stream: every block of the grid is resident
// at once, so a spin can never starve the block it waits for.  A grid larger
// than the card holds together is refused (cudaErrorCooperativeLaunchTooLarge),
// never shrunk.  Returns a CUDA error code.
template <typename Args>
int coop_launch(void (*kernel)(Args), dim3 grid, Args args, unsigned* flags,
                size_t nflags, cudaStream_t st) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const long long blocks =
      static_cast<long long>(grid.x) * grid.y * grid.z;
  if (blocks > static_cast<long long>(per_sm) * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaMemsetAsync(flags, 0, sizeof(unsigned) * nflags, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                  dim3(kThreads), params, 0, st);
  return static_cast<int>(e);
}

}  // namespace tmr

extern "C" const char* tm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
