// ring_allreduce: the bandwidth-optimal ring allreduce over n ranks whose
// buffers are device pointers, (n - 1) reduce-scatter steps then (n - 1)
// all-gather steps; float32, bfloat16 and int32.
//
// Replaces two TPU allreduce kernels of torchmpi_tpu/ops/ring.py, one C
// launcher each:
//   tm_ring_allreduce        _ring_allreduce_kernel :265 (pallas_call :831),
//                            one direction, a whole ring chunk per step;
//   tm_ring_allreduce_bidir  _ring_allreduce_bidir_kernel :203 (:859), two
//                            halves in opposite directions.
// The two chunked ones, _ring_allreduce_chunked_kernel :511 (row 8) and
// _ring_allreduce_bidir_chunked_kernel :534 (row 7), are direct reductions
// in the ring's add order (ring_direct.cu).
//
// Layout (the TPU kernels'): rank r's work buffer o_r is its padded input,
// viewed [n ring chunks, E elements]: a slot is a whole ring chunk.  Each
// rank has two comm slots of E elements per direction.  At step s rank r sends chunk send_idx to its
// neighbour in the direction and receives chunk recv_idx from the other
// neighbour (_step_indices :147): o_r[recv] = o_r[recv] + slot in the
// reduce-scatter phase, o_r[recv] = slot in the all-gather phase.  An
// element's ring chunk fixes the order of its adds, so the result is
// bitwise the TPU kernels' and the plain versions' (ops/ring.py).
//
// Protocol (ring_common.cuh; the TPU's slot and ack protocol, which the
// port's ops/ring_sim.py models at C = 1): step k uses slot k % 2.  Before
// issuing step k >= 2 the sender waits until the neighbour has
// acknowledged step k - 2 (ack >= k - 1); it stores its part of
// o[send_idx] into the neighbour's slot and release-increments the
// neighbour's recv[slot].  The receiver acquire-waits until
// recv[slot] >= k / 2 + 1, combines, and increments its left neighbour's
// ack.  Every block drains to ack == K before it exits.
//
// Grid (B, n, directions): each slot is split into B slices, and block b of
// rank r owns slice b of every chunk of r's buffer, stages it (o = x, the
// TPU's staging copy :271 / :522) and exchanges it only with block b of its
// neighbours, with flags per (rank, direction, block).  No block waits on
// another block of its own rank, so no grid-wide barrier is needed.  The
// launch is cooperative: every block of every rank is resident at once, so
// a spin can never starve the block it waits for; a grid that does not fit
// is refused (cudaErrorCooperativeLaunchTooLarge), never shrunk.
//
// What bounds it: bytes.  Per rank with S bytes, the staging copy moves 2S
// and each of the n - 1 reduce steps 5 S / n (read own chunk, write the
// peer's slot, read the slot, read and write own chunk), each gather step
// 4 S / n: n S (2 + 9 (n - 1) / n) through device memory for n ranks on one
// card.  The design is simple on purpose: 16-byte loads and stores, no TMA,
// no copy engines, no overlap of a slot's copy with the next reduce.

#include "ring_common.cuh"

namespace {

struct Dir {
  const void* x;   // [n, P] padded input, rank-major
  void* o;         // [n, P] work buffer = output
  void* comm;      // [n, 2, E] comm slots
  long long P;     // elements per rank in this direction's half
  long long E;     // elements per slot: P / n
  int sign;        // +1 sends right, -1 sends left
};

struct Args {
  Dir d[2];
  unsigned* flags;  // [n][D][B][3]: recv slot 0, recv slot 1, ack
  int n, D, B;
};

template <typename T>
__global__ void __launch_bounds__(tmr::kThreads)
ring_allreduce_kernel(Args a) {
  const int b = blockIdx.x, r = blockIdx.y, dd = blockIdx.z;
  const Dir d = a.d[dd];
  const int n = a.n;
  const int right = tmr::mod(r + d.sign, n), left = tmr::mod(r - d.sign, n);
  auto flags_of = [&](int rank) {
    return a.flags + ((static_cast<long long>(rank) * a.D + dd) * a.B + b) * 3;
  };
  unsigned* mine = flags_of(r);
  unsigned* to_right = flags_of(right);
  unsigned* to_left = flags_of(left);

  const long long E = d.E;
  const long long lo = tmr::slice_start(E, a.B, b);
  const long long len = tmr::slice_start(E, a.B, b + 1) - lo;
  T* o = static_cast<T*>(d.o) + r * d.P + lo;
  const T* x = static_cast<const T*>(d.x) + r * d.P + lo;
  const T* slot_in = static_cast<const T*>(d.comm) + 2 * E * r + lo;
  T* slot_out = static_cast<T*>(d.comm) + 2 * E * right + lo;

  for (int j = 0; j < n; ++j)
    tmr::copy<T, false>(o + j * E, x + j * E, len);
  __syncthreads();

  const int K = 2 * (n - 1);
  auto chunk_of = [&](int s, bool recv) {
    int send_idx, recv_idx;
    if (s < n - 1) {
      send_idx = tmr::mod(r - d.sign * s, n);
      recv_idx = tmr::mod(r - d.sign * (s + 1), n);
    } else {
      const int t = s - (n - 1);
      send_idx = tmr::mod(r + d.sign * (1 - t), n);
      recv_idx = tmr::mod(r - d.sign * t, n);
    }
    return recv ? recv_idx : send_idx;
  };
  for (int k = 0; k < K; ++k) {
    if (k >= 2) tmr::wait_geq(mine + 2, static_cast<unsigned>(k - 1));
    tmr::copy<T, false>(slot_out + (k & 1) * E,
                        o + static_cast<long long>(chunk_of(k, false)) * E, len);
    tmr::signal(to_right + (k & 1));
    tmr::wait_geq(mine + (k & 1), static_cast<unsigned>(k / 2 + 1));
    T* dst = o + static_cast<long long>(chunk_of(k, true)) * E;
    if (k < n - 1)
      tmr::add_from_peer<T>(dst, slot_in + (k & 1) * E, len);
    else
      tmr::copy<T, true>(dst, slot_in + (k & 1) * E, len);
    tmr::signal(to_left + 2);
  }
  tmr::wait_geq(mine + 2, static_cast<unsigned>(K));
}

template <typename T>
int launch_typed(Args a, cudaStream_t st) {
  return tmr::coop_launch(ring_allreduce_kernel<T>, dim3(a.B, a.n, a.D), a,
                          a.flags, 3 * static_cast<size_t>(a.B) * a.n * a.D,
                          st);
}

// dtype: 0 float32, 1 bfloat16, 2 int32.
int launch(int dtype, Args a, void* stream) {
  if (a.n < 2 || a.B < 1 || a.D < 1 || a.D > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < a.D; ++i) {
    const Dir& d = a.d[i];
    if (d.E < 1 || d.P != d.E * a.n)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_typed<float>(a, st);
    case 1: return launch_typed<__nv_bfloat16>(a, st);
    case 2: return launch_typed<int>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Dir dir(const void* x, void* o, void* comm, long long P, long long E,
        int sign) {
  return Dir{x, o, comm, P, E, sign};
}

}  // namespace

// Row 11: one direction, a slot is a whole ring chunk (E = P / n).
extern "C" int tm_ring_allreduce(int dtype, const void* x, void* o,
                                 void* comm, unsigned* flags, long long P,
                                 int n, int B, void* stream) {
  if (n < 1 || P % n) return static_cast<int>(cudaErrorInvalidValue);
  Args a{{dir(x, o, comm, P, P / n, +1), {}}, flags, n, 1, B};
  return launch(dtype, a, stream);
}

// Row 12: halves of P1 and P2 elements per rank, rotating right and left.
extern "C" int tm_ring_allreduce_bidir(int dtype, const void* x1,
                                       const void* x2, void* o1, void* o2,
                                       void* comm1, void* comm2,
                                       unsigned* flags, long long P1,
                                       long long P2, int n, int B,
                                       void* stream) {
  if (n < 1 || P1 % n || P2 % n)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{{dir(x1, o1, comm1, P1, P1 / n, +1),
          dir(x2, o2, comm2, P2, P2 / n, -1)},
         flags, n, 2, B};
  return launch(dtype, a, stream);
}
