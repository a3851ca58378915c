// ring_rs_ag: the ring reduce-scatter and the ring all-gather over n ranks
// whose buffers are device pointers, (n - 1) steps each; float32, bfloat16
// and int32.
//
// Replaces the four TPU kernels of torchmpi_tpu/ops/ring.py that ZeRO's
// gradient and parameter legs run, one C launcher each:
//   tm_ring_reduce_scatter          _ring_reduce_scatter_kernel :310
//                                   (pallas_call :1045), a whole ring chunk
//                                   per step;
//   tm_ring_reduce_scatter_chunked  _ring_reduce_scatter_chunked_kernel :707
//                                   (:772) through _chunked_pipeline :439,
//                                   subchunks of ~chunk_bytes;
//   tm_ring_all_gather              _ring_all_gather_kernel :342 (:1097);
//   tm_ring_all_gather_chunked      _ring_all_gather_chunked_kernel :733
//                                   (:806).
//
// Layout.  Rank r's ring chunk j holds ``per`` elements, viewed as C
// subchunks of E elements (C E >= per > (C - 1) E; C = 1 and E >= per for
// the resident kernels, whose slot is a whole ring chunk).  The TPU kernels
// pad each chunk to C E with zeros; here the pad is never stored: a
// subchunk's last part past ``per`` is simply not moved.  Adding zeros
// changes no bit, so the result is the padded one's.
//
// Reduce-scatter: rank r's input is x_r = [n chunks of per], staged into its
// work buffer w_r (the TPU's staging copy :318 / :717).  At step s it sends
// w_r[(r - s - 1) % n] to its right neighbour and adds what its left
// neighbour sends into w_r[(r - s - 2) % n] (_rs_step_indices :430, the
// classic schedule shifted by one), so after n - 1 steps w_r[r] is the sum
// of every rank's chunk r, added in the order of the ring, and is copied
// out.  All-gather: rank r's shard goes to o_r[r], and at step t rank r
// sends o_r[(r - t) % n] and copies what arrives into o_r[(r - t - 1) % n]
// (the forward schedule of :349-366 and :749-756).  Each kernel is bitwise
// the TPU kernels' and the plain versions' (ops/ring.py).
//
// Protocol (ring_common.cuh; that of ring_allreduce.cu, which the port's
// ops/ring_sim.py models): iteration k = s C + c uses comm slot k % 2.
// Before issuing iteration k >= 2 a block waits until its neighbour has
// acknowledged iteration k - 2; it stores its part of the subchunk into the
// neighbour's slot and release-increments the neighbour's recv flag.  The
// receiver acquire-waits, adds or copies, and increments its sender's ack.
// The chunked kernels issue iteration k + 1 before waiting for k
// (_chunked_pipeline's order: C > 1 puts the chunk that k + 1 forwards at
// least one iteration back); the resident ones do not.
//
// Grid (B, n), cooperative: block b of rank r owns slice b of every subchunk
// and exchanges it only with block b of its neighbours, with flags per
// (rank, block); a grid that does not fit the card at once is refused.
//
// What bounds it: bytes.  Per rank with S bytes of input, the
// reduce-scatter's staging copy moves 2 S, each of its n - 1 steps 5 S / n
// (read the chunk, write the peer's slot, read the slot, read and write the
// chunk) and the copy-out 2 S / n: S (2 + (5 (n - 1) + 2) / n) through
// device memory.  The all-gather of a shard of S' bytes moves 2 S' to place
// its own shard and 4 S' per step: S' (2 + 4 (n - 1)).  Simple on purpose:
// 16-byte loads and stores, no TMA, no copy engines, the input staged.

#include "ring_common.cuh"

namespace {

struct Args {
  const void* x;    // RS: [n, n * per] per-rank inputs; AG: [n, per] shards
  void* w;          // [n, n * per]: RS work buffer; AG output
  void* out;        // RS: [n, per] owned chunks; AG: unused
  void* comm;       // [n, 2, E] comm slots
  unsigned* flags;  // [n][B][3]: recv slot 0, recv slot 1, ack
  long long per;    // elements of one ring chunk
  long long E;      // elements of one subchunk (= one slot)
  int n, C, B;
};

template <typename T, bool kReduce>
__global__ void __launch_bounds__(tmr::kThreads)
ring_rs_ag_kernel(Args a) {
  const int b = blockIdx.x, r = blockIdx.y;
  const int n = a.n, C = a.C;
  const int right = tmr::mod(r + 1, n);
  const int left = tmr::mod(r - 1, n);
  auto flags_of = [&](int rank) {
    return a.flags + (static_cast<long long>(rank) * a.B + b) * 3;
  };
  unsigned* mine = flags_of(r);
  unsigned* to_right = flags_of(right);
  unsigned* to_left = flags_of(left);

  const long long E = a.E, per = a.per;
  const long long lo = tmr::slice_start(E, a.B, b);
  const long long hi = tmr::slice_start(E, a.B, b + 1);
  // Elements of this block's slice inside subchunk c (the last subchunk
  // may end before the slice does).
  auto len_of = [&](int c) {
    const long long end = per - static_cast<long long>(c) * E;
    const long long top = end < hi ? end : hi;
    return top > lo ? top - lo : 0ll;
  };
  // This block's part of subchunk c of ring chunk j in a [n chunks of per]
  // buffer.
  auto part = [&](long long j, int c) {
    return j * per + static_cast<long long>(c) * E + lo;
  };
  T* w = static_cast<T*>(a.w) + static_cast<long long>(r) * n * per;
  const T* slot_in = static_cast<const T*>(a.comm) + 2 * E * r + lo;
  T* slot_out = static_cast<T*>(a.comm) + 2 * E * right + lo;

  if (kReduce) {
    const T* x = static_cast<const T*>(a.x) + static_cast<long long>(r) * n * per;
    for (int j = 0; j < n; ++j)
      for (int c = 0; c < C; ++c)
        tmr::copy<T, false>(w + part(j, c), x + part(j, c), len_of(c));
  } else {
    const T* x = static_cast<const T*>(a.x) + static_cast<long long>(r) * per;
    for (int c = 0; c < C; ++c)
      tmr::copy<T, false>(w + part(r, c), x + part(0, c), len_of(c));
  }
  __syncthreads();

  // (send chunk, recv chunk) of step s: the shifted schedule for the
  // reduce-scatter, the forward one for the all-gather.
  const int shift = kReduce ? 1 : 0;
  const int K = (n - 1) * C;
  auto issue = [&](int k) {
    const int s = k / C, c = k % C;
    if (k >= 2) tmr::wait_geq(mine + 2, static_cast<unsigned>(k - 1));
    tmr::copy<T, false>(slot_out + (k & 1) * E,
                        w + part(tmr::mod(r - s - shift, n), c), len_of(c));
    tmr::signal(to_right + (k & 1));
  };
  auto receive = [&](int k) {
    const int s = k / C, c = k % C;
    tmr::wait_geq(mine + (k & 1), static_cast<unsigned>(k / 2 + 1));
    T* dst = w + part(tmr::mod(r - s - 1 - shift, n), c);
    if (kReduce)
      tmr::add_from_peer<T>(dst, slot_in + (k & 1) * E, len_of(c));
    else
      tmr::copy<T, true>(dst, slot_in + (k & 1) * E, len_of(c));
    tmr::signal(to_left + 2);
  };

  if (C > 1) {
    issue(0);
    for (int k = 0; k < K; ++k) {
      if (k + 1 < K) issue(k + 1);
      receive(k);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      issue(k);
      receive(k);
    }
  }
  tmr::wait_geq(mine + 2, static_cast<unsigned>(K));

  if (kReduce) {
    // The owned chunk r, reduced by this block's own last receives (the
    // barrier in wait_geq orders them before these reads).
    T* out = static_cast<T*>(a.out) + static_cast<long long>(r) * per;
    for (int c = 0; c < C; ++c)
      tmr::copy<T, false>(out + part(0, c), w + part(r, c), len_of(c));
  }
}

template <typename T, bool kReduce>
int launch_typed(Args a, cudaStream_t st) {
  return tmr::coop_launch(ring_rs_ag_kernel<T, kReduce>, dim3(a.B, a.n), a,
                          a.flags, 3 * static_cast<size_t>(a.B) * a.n, st);
}

// dtype: 0 float32, 1 bfloat16, 2 int32.  ``chunked``: C > 1 is required
// (the streamed rows); otherwise C must be 1 (the resident rows).
int launch(int dtype, bool reduce, bool chunked, Args a, void* stream) {
  if (a.n < 2 || a.B < 1 || a.E < 1 || a.per < 1 ||
      (chunked ? a.C < 2 : a.C != 1) ||
      static_cast<long long>(a.C) * a.E < a.per ||
      static_cast<long long>(a.C - 1) * a.E >= a.per)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (reduce ? 1 : 0)) {
    case 0: return launch_typed<float, false>(a, st);
    case 1: return launch_typed<float, true>(a, st);
    case 2: return launch_typed<__nv_bfloat16, false>(a, st);
    case 3: return launch_typed<__nv_bfloat16, true>(a, st);
    case 4: return launch_typed<int, false>(a, st);
    case 5: return launch_typed<int, true>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Row 13: x [n, n * per] -> out [n, per], work w [n, n * per], slots of E
// >= per elements.
extern "C" int tm_ring_reduce_scatter(int dtype, const void* x, void* w,
                                      void* out, void* comm, unsigned* flags,
                                      long long per, long long E, int n,
                                      int B, void* stream) {
  return launch(dtype, true, false,
                Args{x, w, out, comm, flags, per, E, n, 1, B}, stream);
}

// Row 9: as row 13 with C subchunks of E elements per ring chunk.
extern "C" int tm_ring_reduce_scatter_chunked(
    int dtype, const void* x, void* w, void* out, void* comm,
    unsigned* flags, long long per, long long E, int C, int n, int B,
    void* stream) {
  return launch(dtype, true, true,
                Args{x, w, out, comm, flags, per, E, n, C, B}, stream);
}

// Row 14: shards x [n, per] -> out [n, n, per], slots of E >= per elements.
extern "C" int tm_ring_all_gather(int dtype, const void* x, void* out,
                                  void* comm, unsigned* flags, long long per,
                                  long long E, int n, int B, void* stream) {
  return launch(dtype, false, false,
                Args{x, out, nullptr, comm, flags, per, E, n, 1, B}, stream);
}

// Row 10: as row 14 with C subchunks of E elements per shard.
extern "C" int tm_ring_all_gather_chunked(int dtype, const void* x,
                                          void* out, void* comm,
                                          unsigned* flags, long long per,
                                          long long E, int C, int n, int B,
                                          void* stream) {
  return launch(dtype, false, true,
                Args{x, out, nullptr, comm, flags, per, E, n, C, B}, stream);
}
