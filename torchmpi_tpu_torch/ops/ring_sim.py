"""Depth-faithful schedule simulator for the chunked ring kernels.

The port's own numpy copy of the JAX package's ``ops/ring_sim.py`` (the
port imports nothing of that package).  It executes the slot / ack
protocol of the chunked ring kernels in ``ops/csrc/ring_allreduce.cu``
(rows 7 and 8 of the kernel table, the TPU's ``_chunked_pipeline``) in
pure numpy: one state machine per rank running the same iteration
sequence as a kernel block (issue -> pipelined next-issue -> wait ->
combine/copy -> writeback -> ack), with no iteration cap, driven by an
arbitrary scheduler (randomized or adversarial interleavings).

The simulator is stricter than the hardware in three ways:

- **slot-overwrite hazard**: a delivery into a comm slot whose previous
  payload the receiver has not consumed yet raises :class:`HazardError`.
  Delivery is modeled at issue, the earliest point a sender could write.
- **source-mutation hazard**: a writeback into the work-buffer region an
  in-flight outgoing send still reads raises :class:`HazardError`.
- **deadlock**: a state where no rank can advance raises
  :class:`DeadlockError` with each rank's progress and blocked event.

The per-subchunk payload width does not enter the protocol (indices, slots
and acks depend only on ``(n, C, steps)``), so tests may shrink the
payload while taking ``C`` from the real plan (``ring._chunk_plan``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class HazardError(AssertionError):
    """A data race the flow-control protocol is supposed to prevent."""


class DeadlockError(AssertionError):
    """No rank can advance; carries the stuck per-rank state."""


def step_indices_allreduce(my: int, n: int, s: int, sign: int = 1):
    """(send chunk, recv chunk) of rank ``my`` at ring step ``s`` in
    direction ``sign`` (+1 sends right, -1 left): the reduce-scatter phase
    for ``s < n - 1``, the all-gather phase after (``ring._step_indices``)."""
    if s < n - 1:
        return (my - sign * s) % n, (my - sign * (s + 1)) % n
    t = s - (n - 1)
    return (my + sign * (1 - t)) % n, (my - sign * t) % n


def step_indices_rs(my: int, n: int, s: int):
    """The shifted reduce-scatter schedule, under which each rank finishes
    owning its own chunk index."""
    return (my - s - 1) % n, (my - s - 2) % n


def _device_program(K: int, use_acks: bool):
    """The event sequence of one rank's block in the chunked kernel: issue
    iteration 0, then for each k issue k+1 BEFORE waiting for k (the
    software pipeline), wait k, combine + writeback, ack; finally drain
    the last acks."""

    def issue(k):
        if use_acks and k >= 2:
            yield ("ack_wait", 1)
        yield ("rdma_start", k)

    yield from issue(0)
    for k in range(K):
        if k + 1 < K:
            yield from issue(k + 1)
        yield ("rdma_wait", k)
        yield ("writeback", k)
        yield ("signal_ack",)
    if use_acks:
        yield ("ack_wait", min(2, K))


def simulate(work0: List[np.ndarray], C: int, steps: int,
             step_indices: Callable[[int, int], Tuple[int, int]],
             reduce_at: Callable[[int], bool], *, sign: int = 1,
             scheduler: str = "random",
             rng: Optional[np.random.RandomState] = None,
             use_acks: bool = True,
             starve: Optional[int] = None) -> List[np.ndarray]:
    """Run the chunked-ring schedule to completion and return the final
    per-rank work buffers.

    ``work0[d]`` is rank d's work buffer ``[n, C, sub]`` (copied, not
    mutated); ``step_indices(d, s)`` maps a rank and ring step to its
    (send_idx, recv_idx) chunk pair; ``sign`` selects the neighbour
    direction (+1 send-right, -1 the second half of the bidirectional
    kernel).  ``scheduler``: "random" picks uniformly among runnable ranks
    per event (pass ``rng``), "greedy" always advances the lowest-index
    runnable rank.  ``starve=d`` refuses to schedule rank d while any other
    is runnable.  ``use_acks=False`` runs the protocol with the ack waits
    removed, so tests can show that the hazard detectors fire."""
    n = len(work0)
    K = steps * C
    work = [w.copy() for w in work0]
    rng = rng or np.random.RandomState(0)

    right = [(d + sign) % n for d in range(n)]
    left = [(d - sign) % n for d in range(n)]

    ack = [0] * n
    # comm slot state per rank: pending iteration (None = free/consumed)
    # and the payload itself.
    comm_pending: List[List[Optional[int]]] = [[None, None]
                                               for _ in range(n)]
    comm_data = [[None, None] for _ in range(n)]
    delivered = [set() for _ in range(n)]   # iterations arrived at d
    inflight_out = [dict() for _ in range(n)]  # k -> (send_idx, c)

    progs = [_device_program(K, use_acks) for _ in range(n)]
    current = [next(p) for p in progs]
    done = [False] * n

    def runnable(d):
        ev = current[d]
        if ev[0] == "ack_wait":
            return ack[d] >= ev[1]
        if ev[0] == "rdma_wait":
            return ev[1] in delivered[d]
        return True  # rdma_start / writeback / signal_ack are immediate

    def execute(d):
        ev = current[d]
        kind = ev[0]
        if kind == "ack_wait":
            ack[d] -= ev[1]
        elif kind == "rdma_start":
            k = ev[1]
            s, c = divmod(k, C)
            send_idx, _ = step_indices(d, s)
            slot = k % 2
            tgt = right[d]
            if comm_pending[tgt][slot] is not None:
                raise HazardError(
                    f"slot overwrite: rank {d} iteration {k} delivers "
                    f"into rank {tgt} comm[{slot}] while its iteration "
                    f"{comm_pending[tgt][slot]} payload is unconsumed "
                    f"(n={n}, C={C}, steps={steps})")
            comm_data[tgt][slot] = work[d][send_idx, c].copy()
            comm_pending[tgt][slot] = k
            delivered[tgt].add(k)
            inflight_out[d][k] = (send_idx, c)
        elif kind == "rdma_wait":
            # The send side of the same iteration: its read of our source
            # region is complete once the wait returns.
            inflight_out[d].pop(ev[1], None)
        elif kind == "writeback":
            k = ev[1]
            s, c = divmod(k, C)
            _, recv_idx = step_indices(d, s)
            slot = k % 2
            for k2, (si, ci) in inflight_out[d].items():
                if (si, ci) == (recv_idx, c):
                    raise HazardError(
                        f"source mutation: rank {d} iteration {k} "
                        f"writes work[{recv_idx},{c}] while its "
                        f"iteration {k2} send still reads it")
            val = comm_data[d][slot]
            if reduce_at(s):
                work[d][recv_idx, c] = work[d][recv_idx, c] + val
            else:
                work[d][recv_idx, c] = val
            comm_pending[d][slot] = None  # slot free for the next round
        elif kind == "signal_ack":
            ack[left[d]] += 1
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown event {ev!r}")
        try:
            current[d] = next(progs[d])
        except StopIteration:
            done[d] = True

    while not all(done):
        ready = [d for d in range(n) if not done[d] and runnable(d)]
        if starve is not None:
            others = [d for d in ready if d != starve]
            if others:
                ready = others
        if not ready:
            state = {d: ("done" if done[d] else current[d])
                     for d in range(n)}
            raise DeadlockError(
                f"no runnable rank (n={n}, C={C}, steps={steps}, "
                f"acks={use_acks}): {state}; ack counts {ack}")
        if scheduler == "greedy":
            d = ready[0]
        else:
            d = ready[int(rng.randint(len(ready)))]
        execute(d)

    if use_acks and any(a != 0 for a in ack):
        raise HazardError(
            f"semaphores not drained at exit: ack counts {ack} "
            f"(kernel contract: every rank leaves its ack at zero)")
    return work


def simulate_allreduce(x: np.ndarray, C: int, **kw) -> List[np.ndarray]:
    """Chunked ring allreduce at depth C.  ``x``: [n, n, C, sub], rank d's
    initial buffer is ``x[d]``.  Returns the n final buffers (each should
    equal ``x.sum(0)``)."""
    n = x.shape[0]
    sign = kw.get("sign", 1)
    return simulate(
        [x[d] for d in range(n)], C, 2 * (n - 1),
        lambda d, s: step_indices_allreduce(d, n, s, sign),
        lambda s: s < n - 1, **kw)


def simulate_reduce_scatter(x: np.ndarray, C: int, **kw) -> np.ndarray:
    """Chunked reduce-scatter phase: returns [n, C, sub] where row d is
    rank d's owned reduced chunk (work[d][d] after the shifted schedule)."""
    n = x.shape[0]
    out = simulate(
        [x[d] for d in range(n)], C, n - 1,
        lambda d, s: step_indices_rs(d, n, s),
        lambda s: True, **kw)
    return np.stack([out[d][d] for d in range(n)])


def simulate_all_gather(chunks: np.ndarray, C: int, **kw) -> List[np.ndarray]:
    """Chunked all-gather phase: ``chunks`` [n, C, sub] (rank d's local
    chunk); rank d's work starts as zeros except work[d] = chunks[d].
    Every final buffer should equal ``chunks``."""
    n = chunks.shape[0]
    work0 = []
    for d in range(n):
        w = np.zeros((n,) + chunks.shape[1:], chunks.dtype)
        w[d] = chunks[d]
        work0.append(w)
    return simulate(
        work0, C, n - 1,
        lambda d, t: step_indices_allreduce(d, n, t, 1),
        lambda t: False, **kw)
