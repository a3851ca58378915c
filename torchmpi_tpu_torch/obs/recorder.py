"""Deadlock flight recorder: a fixed-size ring of recent collective events.

The PyTorch counterpart of ``torchmpi_tpu/obs/recorder.py`` (the same
ring and dump records).  When a gang hangs, each host's last N collective
launches — op, payload bytes, backend, a per-host sequence number, and a
monotonic timestamp — are the evidence.  Events are appended *before*
dispatch, so the collective a host is stuck inside is the last event in
its ring.  The dump is per-host JSONL; ``python -m
torchmpi_tpu_torch.obs.tool blame``
aligns the per-host seq streams and names the first diverging collective
(different op/bytes at the same seq, or one host issuing launches the
others never reached — the SPMD divergence that deadlocks a gang).

Dependency-free (no torch/numpy) and allocation-light: one preallocated
list reused circularly, one lock, tuples for events.  Only ever touched
when ``Config.obs`` is on.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

# Event tuple layout (kept positional to stay allocation-light on the
# dispatch path; to_records() names the fields for the dump).  The
# event-type field is "ev", NOT "kind" — "kind" is the JSONL framing
# discriminator (meta/counter/hist/event) in the dump files.
# (seq, ts_monotonic, ev, op, nbytes, backend, detail)
Event = Tuple[int, float, str, str, int, str, str]

FIELDS = ("seq", "ts", "ev", "op", "nbytes", "backend", "detail")


class FlightRecorder:
    """Fixed-size in-memory ring of the last N events."""

    def __init__(self, size: int = 1024) -> None:
        self.size = max(1, int(size))
        self._lock = threading.Lock()
        self._ring: List[Optional[Event]] = [None] * self.size
        self._seq = 0  # total events ever appended
        # Lowest retained seq.  Normally implied by seq - size, but a
        # grow via resized() carries fewer than ``size`` events, so the
        # floor is tracked explicitly until appends overwrite past it.
        self._lo = 0

    def append(self, ev: str, op: str = "", nbytes: int = 0,
               backend: str = "", detail: str = "") -> int:
        """Record one event; returns its sequence number."""
        ts = time.monotonic()
        with self._lock:
            seq = self._seq
            self._ring[seq % self.size] = (seq, ts, ev, op, int(nbytes),
                                           backend, detail)
            self._seq = seq + 1
        return seq

    def _start(self) -> int:
        """Seq of the oldest retained event."""
        return max(self._lo, self._seq - self.size)

    def __len__(self) -> int:
        return self._seq - self._start()

    @property
    def total(self) -> int:
        """Events ever appended (>= len once the ring has wrapped)."""
        return self._seq

    @property
    def dropped(self) -> int:
        """Events no longer retained (overwritten or lost to a
        shrink)."""
        return self._start()

    def events(self, best_effort: bool = False) -> List[Event]:
        """Retained events, oldest first, seq-contiguous.

        ``best_effort=True``: bounded lock acquire with a lock-free
        fallback — the SIGTERM dump path, where a blocking acquire
        against the interrupted frame's own lock would self-deadlock
        (see ``Registry.snapshot``)."""
        got = self._lock.acquire(timeout=0.2 if best_effort else -1)
        try:
            return [self._ring[i % self.size]
                    for i in range(self._start(), self._seq)]
        finally:
            if got:
                self._lock.release()

    def to_records(self, best_effort: bool = False) -> List[dict]:
        """JSON-ready event records for the per-host dump (framed with
        ``kind="event"`` for the JSONL record discriminator)."""
        return [dict(zip(FIELDS, e), kind="event")
                for e in self.events(best_effort)]

    def resized(self, size: int) -> "FlightRecorder":
        """A new ring of ``size`` carrying this one's event history and
        sequence counter forward (the newest ``size`` events survive) —
        re-activation with a different ``obs_ring_size`` must not
        destroy the deadlock evidence the ring exists to retain."""
        nr = FlightRecorder(size)
        evs = self.events()  # takes the lock itself (non-reentrant)
        nr._seq = evs[-1][0] + 1 if evs else 0
        kept = evs[-nr.size:]
        nr._lo = kept[0][0] if kept else nr._seq
        for e in kept:
            nr._ring[e[0] % nr.size] = e
        return nr

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.size
            self._seq = 0
            self._lo = 0
