"""Structured metrics and timing.

The PyTorch counterpart of ``torchmpi_tpu/utils/metrics.py``: ``fence``
(:21), ``TimedResult`` (:35), ``timed`` (:62), ``Timer`` (:111),
``MetricsLogger`` (:134) and ``allreduce_bus_bandwidth`` (:160).  The JAX
package fences with a one-element readback; here CUDA work is enqueued on
streams, so :func:`fence` synchronizes the card that holds the result, and
a timed round ends once every kernel it launched has finished, not when
they were enqueued.  CPU tensors compute synchronously and need no fence.
The JAX package's telemetry counter in ``MetricsLogger.log`` waits for the
obs layer (ROADMAP queue A, item 10).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import torch

from .. import _tree


def fence(x) -> None:
    """Wait until the card that holds the first tensor leaf of ``x`` has
    finished every kernel enqueued so far; a no-op on the CPU."""
    for leaf in _tree.leaves(x):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


# Per-round seconds/iter of the most recent timed() call, chronological (the
# JAX package's backward-compatible global; new code reads
# TimedResult.round_times).
last_round_times: List[float] = []


class TimedResult(float):
    """Structured result of :func:`timed`.

    IS a float (min-of-rounds seconds/iter) and carries the spread:

    - ``round_times``  chronological seconds/iter of each round
    - ``median``       median of the rounds (the scoring rule)
    - ``jitter``       half the inter-quartile range: the scale a delta
                       must clear to be more than noise
    """

    __slots__ = ("round_times", "median", "jitter")

    def __new__(cls, round_times: List[float]) -> "TimedResult":
        ts = list(round_times)
        self = super().__new__(cls, min(ts))
        s = sorted(ts)
        n = len(s)
        self.round_times = ts
        self.median = (s[n // 2] if n % 2
                       else 0.5 * (s[n // 2 - 1] + s[n // 2]))
        self.jitter = (0.5 * (s[(3 * n) // 4] - s[n // 4]) if n >= 4
                       else 0.5 * (s[-1] - s[0]))
        return self


def timed(step, iters: int, fence=fence, rounds: int = 3) -> TimedResult:
    """Seconds per iteration of ``step``: one warm call (a kernel's first
    use builds it), then ``rounds`` fenced rounds of ``iters`` calls,
    returned as a :class:`TimedResult`.  The round's clock stops after
    ``fence`` on its last output, so it covers the kernels it launched."""
    out = step()
    fence(out)
    del last_round_times[:]
    for _ in range(max(1, rounds)):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        fence(out)
        last_round_times.append((time.perf_counter() - t0) / iters)
    return TimedResult(last_round_times)


class Timer:
    """Wall-clock step timer with fenced boundaries."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.steps = 0

    def start(self, fence_on=None):
        if fence_on is not None:
            fence(fence_on)
        self._t0 = time.time()
        self.steps = 0

    def tick(self):
        self.steps += 1

    def stop(self, fence_on=None) -> float:
        if fence_on is not None:
            fence(fence_on)
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        return time.time() - self._t0


class MetricsLogger:
    """Records as JSONL: kept in ``records`` and, with a ``path``,
    appended to that file, one JSON object a line."""

    def __init__(self, path: Optional[str] = None, name: str = "metrics"):
        self.path = path
        self.name = name
        self.records: List[Dict[str, Any]] = []

    def log(self, **kw) -> None:
        rec = {"t": time.time(), **kw}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


def allreduce_bus_bandwidth(nbytes: int, n_devices: int,
                            seconds: float) -> float:
    """Effective bus bandwidth GB/s, the reference's benchmark metric:
    algbw = size/time; busbw = algbw * 2(n-1)/n (ring lower bound)."""
    if seconds <= 0 or n_devices <= 1:
        return 0.0
    algbw = nbytes / seconds
    return algbw * 2 * (n_devices - 1) / n_devices / 1e9
