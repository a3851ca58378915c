"""Metrics registry: counters + log2-bucketed histograms.

The in-memory store behind ``torchmpi_tpu_torch.obs``, the PyTorch
counterpart of ``torchmpi_tpu/obs/registry.py`` (the same data model and
exposition, so either package's ``obs_tool`` reads the other's dumps;
docs/OBSERVABILITY_TORCH.md).  Deliberately dependency-free (no torch, no
numpy): the registry must be importable by the dump path of a dying
process (SIGTERM handler, interpreter teardown) and by ``obs/tool.py``.

Metrics are keyed by ``(name, labels)`` where labels is a small dict of
string pairs — the Prometheus data model, which is also what the JSONL
exposition serializes.  Histograms bucket observed values at
``floor(log2(v))`` — the same granularity as the tuning-plan size
buckets (``tuning/fingerprint.size_bucket``): collective byte sizes and
latencies move in powers of two, and a handful of buckets covers a
training run.

Thread safety: one lock around every mutation.  The hot call sites
(eager collective dispatch) take it once per collective launch — noise
next to the dispatch itself, and only ever paid when ``Config.obs`` is
on.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def log2_bucket(value: float) -> int:
    """``floor(log2(value))``; values <= 1 share bucket 0 (mirrors
    ``tuning.fingerprint.size_bucket`` so byte histograms and plan keys
    bucket identically)."""
    return max(0, int(value).bit_length() - 1)


class _Hist:
    __slots__ = ("buckets", "count", "sum")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        b = log2_bucket(value)
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.sum += float(value)


class Registry:
    """Counter + histogram store with JSONL/Prometheus exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], float] = {}
        self._hists: Dict[Tuple[str, LabelKey], _Hist] = {}

    # -- mutation ----------------------------------------------------------

    def counter_inc(self, name: str, value: float = 1, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def hist_observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.observe(value)

    def counter_handle(self, name: str, **labels):
        """Pre-resolved increment handle for ONE counter series: the
        (name, labels) key is built once, so the per-event cost is a
        lock + dict update.  The planner's replay-path discipline —
        every label a CollectivePlan emits is static per plan, so the
        key resolution moves to plan-build time."""
        key = (name, _label_key(labels))
        lock, counters = self._lock, self._counters

        def inc(value: float = 1) -> None:
            with lock:
                counters[key] = counters.get(key, 0) + value

        return inc

    def hist_handle(self, name: str, **labels):
        """Pre-resolved observe handle for ONE histogram series (the
        histogram sibling of :meth:`counter_handle`)."""
        key = (name, _label_key(labels))
        lock, hists = self._lock, self._hists

        def observe(value: float) -> None:
            with lock:
                h = hists.get(key)
                if h is None:
                    h = hists[key] = _Hist()
                h.observe(value)

        return observe

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()

    # -- reads -------------------------------------------------------------

    def counter(self, name: str, **labels) -> float:
        """Current value of one counter series (0 if never incremented)."""
        return self._counters.get((name, _label_key(labels)), 0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across every label combination."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _ in self._counters}
                          | {n for n, _ in self._hists})

    def snapshot(self, best_effort: bool = False) -> List[dict]:
        """Every series as a JSON-ready record (the JSONL dump body and
        the obs_tool interchange format).

        ``best_effort=True`` is for the SIGTERM dump path: the signal
        handler runs on the main thread, and if the interrupted frame
        holds this (non-reentrant) lock a blocking acquire would
        self-deadlock the very dump the handler exists to produce.  The
        acquire is bounded; on timeout the copy proceeds lock-free —
        safe in the deadlock case (the holder is the suspended frame,
        so every other writer is blocked on the same lock)."""
        got = self._lock.acquire(timeout=0.2 if best_effort else -1)
        try:
            out: List[dict] = []
            for (name, lk), v in sorted(self._counters.items()):
                out.append({"kind": "counter", "name": name,
                            "labels": dict(lk), "value": v})
            for (name, lk), h in sorted(self._hists.items()):
                out.append({"kind": "hist", "name": name,
                            "labels": dict(lk),
                            "buckets": {str(b): c for b, c
                                        in sorted(h.buckets.items())},
                            "count": h.count, "sum": h.sum})
            return out
        finally:
            if got:
                self._lock.release()

    # -- Prometheus text exposition ---------------------------------------

    def to_prometheus(self, snapshot: Optional[List[dict]] = None) -> str:
        """Prometheus text format (0.0.4).  Histograms render as
        cumulative ``_bucket{le=2^(b+1)}`` series plus ``_count``/
        ``_sum`` — the upper edge of log2 bucket b is ``2**(b+1)``."""
        return "\n".join(prometheus_lines(
            self.snapshot() if snapshot is None else snapshot)) + "\n"


def prometheus_lines(records: List[dict]) -> Iterator[str]:
    """Render snapshot records (``Registry.snapshot`` shape) as
    Prometheus text lines — module-level so obs_tool can render files
    it parsed back from JSONL without a live Registry."""
    seen_type = set()
    for rec in records:
        name, labels = rec.get("name"), rec.get("labels", {})
        if rec.get("kind") == "counter":
            if name not in seen_type:
                seen_type.add(name)
                yield f"# TYPE {name} counter"
            yield f"{name}{_prom_labels(labels)} {_prom_num(rec['value'])}"
        elif rec.get("kind") == "hist":
            if name not in seen_type:
                seen_type.add(name)
                yield f"# TYPE {name} histogram"
            acc = 0
            for b, c in sorted(rec.get("buckets", {}).items(),
                               key=lambda kv: int(kv[0])):
                acc += c
                le = dict(labels, le=str(2 ** (int(b) + 1)))
                yield f"{name}_bucket{_prom_labels(le)} {acc}"
            inf = dict(labels, le="+Inf")
            yield f"{name}_bucket{_prom_labels(inf)} {rec['count']}"
            yield f"{name}_count{_prom_labels(labels)} {rec['count']}"
            yield f"{name}_sum{_prom_labels(labels)} {_prom_num(rec['sum'])}"


def _esc(v: object) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
