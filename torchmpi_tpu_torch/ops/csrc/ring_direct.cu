// ring_direct: the ring allreduces (chunked and resident, one direction
// and both), the reduce-scatters and the all-gathers (chunked and
// resident) as direct reductions and copies, in the ring's add order, over
// n ranks whose buffers are device pointers; float32, bfloat16 and int32.
//
// Replaces the eight ring kernels of torchmpi_tpu/ops/ring.py, one C
// launcher for each kind (a launcher serves a chunked and a resident
// kernel, which differ only in the ring chunk's length):
//   tm_ring_allreduce_bidir_direct _ring_allreduce_bidir_chunked_kernel :534
//                                  (pallas_call :642), row 7, and
//                                  _ring_allreduce_bidir_kernel :203
//                                  (pallas_call :859), row 12;
//   tm_ring_allreduce_direct       _ring_allreduce_chunked_kernel :511
//                                  (pallas_call :686), row 8, and
//                                  _ring_allreduce_kernel :265
//                                  (pallas_call :831), row 11;
//   tm_ring_reduce_scatter_direct  _ring_reduce_scatter_chunked_kernel :707
//                                  (pallas_call :772), row 9, and
//                                  _ring_reduce_scatter_kernel :310
//                                  (pallas_call :1045), row 13;
//   tm_ring_all_gather_direct      _ring_all_gather_chunked_kernel :733
//                                  (pallas_call :806), row 10, and
//                                  _ring_all_gather_kernel :342
//                                  (pallas_call :1097), row 14.
// The reduce-scatter's and the all-gather's plans only pad the ring chunks,
// and zeros add nothing, so rows 13 and 14 make rows 9's and 10's launch.
//
// The TPU kernels move a ring chunk hop by hop with remote DMAs.  On one
// card (and across the cards of an NVSwitch node, where every GPU reaches
// every peer directly) a hop is two trips through device memory, so these
// kernels do not walk the ring: they load every rank's value of an element
// and fold them in the order the ring would have added them.  An element's
// ring chunk fixes that order (ops/ring.py, _ring_plain and _rs_plain):
//   allreduce, chunk c = [c CE, (c + 1) CE) of the padded layout, CE = C E
//   from the plan (chunked), or the padded P / n, P = L rounded up to a
//   multiple of n TILE (resident, one slot a ring chunk): x_c, x_{c+1},
//   ..., x_{c+n-1} (ranks mod n), a left fold, written to every rank;
//   bidirectional allreduce, the halves [0, h) and [h, L), h = L / 2, half
//   1 in chunks of CE1 and half 2 of CE2: half 1 as the allreduce, half 2
//   the same schedule rotating the other way (:546, my -> -my), so chunk c
//   of it folds x_c, x_{c-1}, ..., x_{c-n+1}.  The chunked kernel pads both
//   halves to one plan (CE1 = CE2); the resident kernel pads each half on
//   its own to a multiple of n TILE, so CE1 and CE2 can differ (L 16,385,
//   n 4: 2048 and 3072);
//   reduce-scatter, chunk c = [c per, (c + 1) per): x_{c+1}, ..., x_{c+n-1},
//   x_c, written to rank c only.
// Each add is Elem<T>'s (ring_common.cuh: float32, bfloat16 rounded after
// every add, int32 wrapping), so the result is bitwise the ring
// schedule's (the plain versions') and the JAX kernels'.  The padding the TPU layout adds
// is never read or written: zeros would only be added to zeros.  The
// all-gather adds nothing: chunk s is rank s's shard, loaded once and stored
// to slice s of every rank's output (_ag_plain's result), so it is bitwise
// for any dtype.
//
// One kernel, grid (B, n) (bidirectional: (B, 2 n), chunks n to 2 n - 1 in
// half 2): blockIdx.y is the ring chunk (the all-gather's source rank), and
// the B blocks of a chunk share its units in a grid-stride loop.  Every
// thread issues up to kInFlight ranks' loads of its unit before the first
// add that consumes them.  A unit is a 16-byte vector when every source
// and destination row, the row strides and the chunk lengths are 16-byte
// aligned (the fused sync's buckets and ZeRO's flats and shards are), the
// chunk's last elements (fewer than one vector) then taken one by one;
// otherwise a unit is one element.  Half 2 starts at element h of the
// rows, which an odd half leaves off a 16-byte boundary (the flagship's
// bucket of 8,249,691 elements: h = 4,124,845); its chunks then take their
// first elements, up to 16 / itemsize - 1, one by one, and vectors from
// the boundary on.  A launch counts on the 16-byte path (*vec = 1, the
// wrapper's VECTOR_LAUNCHES) when the bulk of every chunk ran on vectors.
// Loads go through the read-only path, stores are plain: evict-first loads
// and stores (__ldcs / __stcs) timed slower at the flagship's shapes on an
// H100.
//
// What bounds it: bytes.  Every input element is read once and every
// output element written once, which is the function's own traffic:
// 2 n L itemsize for the allreduce of n ranks' L elements, (n + 1) n per
// itemsize for the reduce-scatter, (n + n^2) per itemsize for the
// all-gather of n shards of per.  The ring schedule on one card moved 2.8
// to 5 times as much (the ring-walking kernels these replaced; at n = 4
// the allreduce's schedule moved n S (2 + 9 (n - 1) / n) for S padded
// bytes a rank, 4.4 times).  A version
// whose 16-byte loads were TMA bulk copies into shared-memory stages on
// mbarriers gained a few percent at the kernel, under 1% of the gradient
// sync, for three times the code, so this one stays.

#include <mutex>
#include <vector>

#include "ring_common.cuh"

namespace {

constexpr int kBlocksPerSm = 4;

// What a launch computes.
enum Mode { kAllreduce, kScatter, kGather, kBidir };

struct Args {
  const void* x;  // [n, ldx]: rank r's elements at x + r ldx
  void* o;        // [n, ldo]: rank r's output row at o + r ldo
  long long ldx, ldo;
  long long L;     // elements of a rank's input row (AG: of its output row)
  long long seg;   // elements of one ring chunk (CE, or per; kBidir: CE1)
  long long seg2;  // kBidir: half 2's ring chunk, CE2; else seg
  long long h;     // kBidir: half 1 is [0, h), half 2 [h, L); else 0
  int n;
};

// Loads: 16-byte vectors through the read-only path; single elements are
// plain loads.
__device__ __forceinline__ uint4 ld(const uint4* p) { return __ldg(p); }
template <typename U>
__device__ __forceinline__ U ld(const U* p) { return *p; }

template <typename T>
__device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
  return tmr::Elem<T>::add4(a, b);
}
template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return tmr::Elem<T>::add(a, b);
}

// The left fold of ranks first, first + step, ..., first + (n - 1) step
// (mod n; step is +1 or -1) of unit ``off`` (a vector or an element) of
// their rows; up to kInFlight loads are issued before the adds that
// consume them.
template <typename T, typename U, int kInFlight>
__device__ __forceinline__ U fold(const T* __restrict__ x, long long ldx,
                                  long long off, int first, int step, int n) {
  U acc{};
  for (int base = 0; base < n; base += kInFlight) {
    U v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (base + k < n) {
        int r = first + step * (base + k);
        r = r >= n ? r - n : (r < 0 ? r + n : r);
        v[k] = ld(reinterpret_cast<const U*>(x + r * ldx) + off);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (base + k < n) acc = base + k == 0 ? v[k] : add<T>(acc, v[k]);
  }
  return acc;
}

// Units [lo, hi) of ring chunk c: fold from rank ``first`` in direction
// ``step``, then store to every rank's row (allreduce) or to rank c's row
// (reduce-scatter); the all-gather loads rank c's unit and stores it to
// every rank's row.  ``U`` is uint4 on the 16-byte path, T otherwise;
// offsets count units.
template <typename T, typename U, Mode kMode, int kInFlight>
__device__ __forceinline__ void reduce_units(const Args& a, int c, int first,
                                             int step, long long src,
                                             long long dst, long long lo,
                                             long long hi) {
  const T* x = static_cast<const T*>(a.x);
  T* o = static_cast<T*>(a.o);
  const int n = a.n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = lo + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < hi; j += stride) {
    U acc;
    if constexpr (kMode == kGather)
      acc = ld(reinterpret_cast<const U*>(x + c * a.ldx) + src + j);
    else
      acc = fold<T, U, kInFlight>(x, a.ldx, src + j, first, step, n);
    if constexpr (kMode == kScatter) {
      reinterpret_cast<U*>(o + c * a.ldo)[dst + j] = acc;
    } else {
#pragma unroll 4
      for (int r = 0; r < n; ++r)
        reinterpret_cast<U*>(o + r * a.ldo)[dst + j] = acc;
    }
  }
}

template <typename T, bool kVec, Mode kMode, int kInFlight>
__global__ void __launch_bounds__(tmr::kThreads)
ring_direct_kernel(Args a) {
  const int n = a.n;
  int c = blockIdx.y, step = 1;
  long long base = 0, L = a.L, seg = a.seg;
  if constexpr (kMode == kBidir) {
    if (c < n) {
      L = a.h;
    } else {  // half 2, the other rotation
      c -= n;
      step = -1;
      base = a.h;
      L = a.L - a.h;
      seg = a.seg2;
    }
  }
  const long long s0 = c * seg;
  const long long len = L - s0 < seg ? L - s0 : seg;
  if (len <= 0) return;
  // The chunk's first element in the source row (the all-gather's source
  // row is the shard itself) and in the destination row.
  const long long x0 = kMode == kGather ? 0 : base + s0;
  const long long d0 = kMode == kScatter ? 0 : base + s0;
  const int first = kMode == kScatter ? (c + 1 == n ? 0 : c + 1) : c;
  if (kVec) {
    constexpr int V = 16 / sizeof(T);
    // Half 2's elements up to the first 16-byte boundary, one by one
    // (x0 == d0 there; every other chunk starts on a boundary).
    long long head = 0;
    if constexpr (kMode == kBidir) {
      head = (V - x0 % V) % V;
      if (head > len) head = len;
      reduce_units<T, T, kMode, kInFlight>(a, c, first, step, x0, d0, 0, head);
    }
    const long long nv = (len - head) / V;
    reduce_units<T, uint4, kMode, kInFlight>(a, c, first, step, (x0 + head) / V,
                                             (d0 + head) / V, 0, nv);
    reduce_units<T, T, kMode, kInFlight>(a, c, first, step, x0, d0,
                                         head + nv * V, len);
  } else {
    reduce_units<T, T, kMode, kInFlight>(a, c, first, step, x0, d0, 0, len);
  }
}

using Kernel = void (*)(Args);

template <typename T, Mode kMode>
Kernel pick(bool vec, int n) {
  if constexpr (kMode == kGather) {  // one load a unit: none kept in flight
    return vec ? ring_direct_kernel<T, true, kMode, 1>
               : ring_direct_kernel<T, false, kMode, 1>;
  } else {
    if (vec)
      return n <= 4 ? ring_direct_kernel<T, true, kMode, 4>
                    : ring_direct_kernel<T, true, kMode, 8>;
    return n <= 4 ? ring_direct_kernel<T, false, kMode, 4>
                  : ring_direct_kernel<T, false, kMode, 8>;
  }
}

// Resident blocks of ``kernel`` on the current card: about kBlocksPerSm on
// every SM (as many as its registers allow).  Looked up once per (card,
// kernel): the lookups cost more host time than a small launch.
int resident_blocks(Kernel kernel, long long* blocks) {
  struct Entry {
    int dev;
    Kernel kernel;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache)
    if (c.dev == dev && c.kernel == kernel) {
      *blocks = c.blocks;
      return 0;
    }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      tmr::kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  *blocks = static_cast<long long>(per_sm) * sms;
  cache.push_back(Entry{dev, kernel, *blocks});
  return 0;
}

// Grid (B, chunks): the card's resident blocks shared by the chunks, and
// no more blocks for a chunk than it has units for.
int run(Kernel kernel, const Args& a, int chunks, long long units,
        cudaStream_t st) {
  long long resident = 0;
  const int e = resident_blocks(kernel, &resident);
  if (e != 0) return e;
  long long B = (resident + chunks - 1) / chunks;
  const long long need = (units + tmr::kThreads - 1) / tmr::kThreads;
  if (B > need) B = need;
  if (B < 1) B = 1;
  kernel<<<dim3(static_cast<unsigned>(B), chunks), tmr::kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Mode kMode>
int launch_typed(const Args& a, int* vec_out, cudaStream_t st) {
  constexpr uintptr_t sz = sizeof(T);
  const uintptr_t mis =
      reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.o) |
      static_cast<uintptr_t>(a.ldx) * sz | static_cast<uintptr_t>(a.ldo) * sz |
      static_cast<uintptr_t>(a.seg) * sz | static_cast<uintptr_t>(a.seg2) * sz;
  const bool vec = (mis & 15) == 0;
  *vec_out = vec ? 1 : 0;
  // Units of the longest chunk (the first of either half), a vector's head
  // and tail included.
  const long long h1 = a.seg < a.h ? a.seg : a.h;
  const long long h2 = a.seg2 < a.L - a.h ? a.seg2 : a.L - a.h;
  const long long len = kMode == kBidir && h1 > h2 ? h1 : h2;
  return run(pick<T, kMode>(vec, a.n), a, kMode == kBidir ? 2 * a.n : a.n,
             vec ? len / (16 / sz) + (kMode == kBidir ? 2 : 1) : len, st);
}

template <typename T>
int launch_mode(Mode mode, const Args& a, int* vec_out, cudaStream_t st) {
  switch (mode) {
    case kAllreduce: return launch_typed<T, kAllreduce>(a, vec_out, st);
    case kScatter: return launch_typed<T, kScatter>(a, vec_out, st);
    case kGather: return launch_typed<T, kGather>(a, vec_out, st);
    case kBidir: return launch_typed<T, kBidir>(a, vec_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 float32, 1 bfloat16, 2 int32.
int launch(int dtype, Mode mode, const Args& a, int* vec_out, void* stream) {
  const long long chunks = mode == kBidir ? 2LL * a.n : a.n;
  // Each half (the whole row outside kBidir, where h = 0 and seg2 = seg)
  // must fit n of its chunks.
  const long long span = a.L - a.h;
  if (a.n < 2 || chunks > 65535 || a.L < 1 || a.seg < 1 || a.seg2 < 1 ||
      a.ldx < 0 || a.h < 0 || a.h > span ||
      a.h > static_cast<long long>(a.n) * a.seg ||
      span > static_cast<long long>(a.n) * a.seg2 || vec_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_mode<float>(mode, a, vec_out, st);
    case 1: return launch_mode<__nv_bfloat16>(mode, a, vec_out, st);
    case 2: return launch_mode<int>(mode, a, vec_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Rows 8 and 11: x [n, L] (row stride ldx) -> o [n, L] (row stride
// ldo >= L), every row the sum; ring chunks of CE elements (row 8: CE = C
// sub_elems of the plan; row 11: the padded P / n; L <= n CE).  *vec is
// set to 1 when the 16-byte path ran.
extern "C" int tm_ring_allreduce_direct(int dtype, const void* x,
                                        long long ldx, void* o,
                                        long long ldo, long long L,
                                        long long CE, int n, int* vec,
                                        void* stream) {
  if (ldo < L) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, kAllreduce, Args{x, o, ldx, ldo, L, CE, CE, 0, n},
                vec, stream);
}

// Rows 7 and 12: x [n, L] (row stride ldx) -> o [n, L] (row stride
// ldo >= L), every row the sum; the halves [0, L / 2) and [L / 2, L) in
// ring chunks of CE1 and CE2 elements (row 7: both C sub_elems of the half
// plan; row 12: each half's own padded length / n; L / 2 <= n CE1,
// L - L / 2 <= n CE2), half 1 in row 8's order, half 2 in the other
// rotation's.  *vec is set to 1 when the 16-byte path ran (half 2 peeled
// to its first boundary).
extern "C" int tm_ring_allreduce_bidir_direct(int dtype, const void* x,
                                              long long ldx, void* o,
                                              long long ldo, long long L,
                                              long long CE1, long long CE2,
                                              int n, int* vec, void* stream) {
  if (ldo < L) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, kBidir, Args{x, o, ldx, ldo, L, CE1, CE2, L / 2, n},
                vec, stream);
}

// Rows 9 and 13: x [n, n per] (row stride ldx) -> out [n, per] (row stride
// ldo >= per), row c the sum of every rank's chunk c.  The flagship's ZeRO
// flats ([n, 486,731,776] f32, per 121,682,944) are 16-byte aligned as
// allocated, so they take the 16-byte path.
extern "C" int tm_ring_reduce_scatter_direct(int dtype, const void* x,
                                             long long ldx, void* out,
                                             long long ldo, long long per,
                                             int n, int* vec, void* stream) {
  if (ldo < per || per < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, kScatter,
                Args{x, out, ldx, ldo, n * per, per, per, 0, n}, vec, stream);
}

// Rows 10 and 14: shards x [n, per] (row stride ldx) -> out [n, n, per],
// contiguous, every rank's slice the stack of the shards.  The flagship's ZeRO shards
// (121,682,944 f32) and their output are 16-byte aligned as allocated, so
// they take the 16-byte path.
extern "C" int tm_ring_all_gather_direct(int dtype, const void* x,
                                         long long ldx, void* out,
                                         long long per, int n, int* vec,
                                         void* stream) {
  if (per < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, kGather,
                Args{x, out, ldx, n * per, n * per, per, per, 0, n}, vec,
                stream);
}
