"""Step-time attribution: flight ring + histograms -> per-step budget.

The PyTorch counterpart of ``torchmpi_tpu/obs/attribution.py``: the same
phase model on the same dump records.  Turns one host's flight-recorder
dump (the ``eager``/``barrier`` dispatch edges, their completion edges
``eager_done`` /
``barrier_done`` / ``ps_wait_done``, the ``plan``/``guard`` anchors and
the ``step`` boundary events) plus the ``tm_*`` histogram snapshot into
a per-step time budget whose phase shares sum to the step wall time:

- ``collective_wait`` — paired dispatch->completion intervals of eager
  collectives (non-host backends), barrier spans, and PS waits;
- ``host_staging``  — the same pairing for host-staged backends (the
  D2H/allreduce/H2D round-trip runs on the host clock);
- ``compile``       — ``plan`` ring events (cache misses) costed at the
  measured mean of ``tm_plan_build_seconds``;
- ``guard_verify``  — ``guard`` verify events costed at the measured
  mean of ``tm_guard_verify_us``;
- ``dispatch_gap``  — the residual: host time between dispatches where
  the device had nothing blocking (python, input pipeline, optimizer
  glue).

Windows come from the ``step`` boundary events recorded by
``data_parallel_step(_rank_major)`` / the serving tick when
``Config.obs != "off"``; a ring with fewer than two markers degrades to
one whole-ring window (noted in the budget).  Overlapping intervals are
resolved by an endpoint sweep (no second is counted twice), and the two
histogram-costed phases are clamped into the uncovered remainder, so
the five phases sum to the window length *exactly* — the invariant
``tests/test_torch_attribution.py`` asserts on a real dump of the port.

Deliberately stdlib-only and import-free within the package, so ``python
-m torchmpi_tpu_torch.obs.tool attribute`` reads a post-mortem without
the runtime.

Caveats inherited from the ring (docs/OBSERVABILITY_TORCH.md): a direct
(device) backend's ``eager_done`` marks the return of its *enqueue*,
not device completion, so its "wait" is a lower bound; ``ps_wait_done``
has no dispatch edge and is costed from the previous event's timestamp;
a wrapped ring drops old dispatch edges, leaving completion edges
unpaired (costed like PS waits, counted in ``notes``).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# Report order; also the sweep priority (host_staging beats
# collective_wait where intervals overlap: the more specific diagnosis
# wins the segment).
PHASES = ("dispatch_gap", "collective_wait", "host_staging",
          "compile", "guard_verify")

_SWEEP_PRIORITY = ("host_staging", "collective_wait")

# Guard ring events whose detail marks a wire-digest verification (the
# ones tm_guard_verify_us measured); rewind/quarantine anchors are
# bookkeeping, not per-step verify cost.
_GUARD_VERIFY_DETAILS = ("verified", "verify_failed", "healed")


def hist_mean(metrics: Sequence[dict], name: str,
              scale: float = 1.0) -> Optional[float]:
    """Mean of a registry histogram across every label set in a
    metrics snapshot (sum/count), scaled (e.g. 1e-6 for *_us series);
    None when the series never recorded."""
    tot = cnt = 0.0
    for rec in metrics or ():
        if rec.get("kind") == "hist" and rec.get("name") == name:
            tot += float(rec.get("sum", 0.0))
            cnt += float(rec.get("count", 0))
    return (tot / cnt) * scale if cnt else None


def _is_host_backend(backend: str) -> bool:
    return "host" in (backend or "")


def _pair_intervals(events: Sequence[dict]) -> Tuple[
        List[Tuple[float, float, str]], Dict[str, int]]:
    """FIFO-pair dispatch edges with their completion edges.

    Returns ``(intervals, stats)`` where each interval is
    ``(t0, t1, phase)``.  Completion edges whose dispatch edge fell off
    a wrapped ring are costed from the previous event's timestamp (the
    ``ps_wait_done`` rule); dispatch edges with no completion (still in
    flight, or a pre-PR-14 ring) contribute nothing but are counted.
    """
    intervals: List[Tuple[float, float, str]] = []
    open_eager: Dict[Tuple[str, int, str], deque] = {}
    open_barrier: Dict[str, deque] = {}
    unpaired_done = 0
    prev_ts: Optional[float] = None
    for ev in events:
        kind = ev.get("ev")
        ts = float(ev.get("ts", 0.0))
        if kind == "eager":
            key = (ev.get("op", ""), int(ev.get("nbytes", 0) or 0),
                   ev.get("backend", ""))
            open_eager.setdefault(key, deque()).append(ts)
        elif kind == "eager_done":
            key = (ev.get("op", ""), int(ev.get("nbytes", 0) or 0),
                   ev.get("backend", ""))
            q = open_eager.get(key)
            phase = ("host_staging"
                     if _is_host_backend(ev.get("backend", ""))
                     else "collective_wait")
            if q:
                intervals.append((q.popleft(), ts, phase))
            elif prev_ts is not None:
                unpaired_done += 1
                intervals.append((prev_ts, ts, phase))
        elif kind == "barrier":
            open_barrier.setdefault(ev.get("op", ""),
                                    deque()).append(ts)
        elif kind == "barrier_done":
            q = open_barrier.get(ev.get("op", ""))
            if q:
                intervals.append((q.popleft(), ts, "collective_wait"))
            elif prev_ts is not None:
                unpaired_done += 1
                intervals.append((prev_ts, ts, "collective_wait"))
        elif kind == "ps_wait_done" and prev_ts is not None:
            intervals.append((prev_ts, ts, "collective_wait"))
        prev_ts = ts
    unpaired_dispatch = (sum(len(q) for q in open_eager.values())
                         + sum(len(q) for q in open_barrier.values()))
    return intervals, {"unpaired_done": unpaired_done,
                       "unpaired_dispatch": unpaired_dispatch}


def _sweep_coverage(intervals: Sequence[Tuple[float, float, str]],
                    w0: float, w1: float) -> Dict[str, float]:
    """Per-phase covered seconds inside ``[w0, w1]`` with no segment
    counted twice: an endpoint sweep assigns each elementary segment to
    the highest-priority phase covering it."""
    clipped = [(max(t0, w0), min(t1, w1), phase)
               for t0, t1, phase in intervals
               if min(t1, w1) > max(t0, w0)]
    covered = {p: 0.0 for p in _SWEEP_PRIORITY}
    if not clipped:
        return covered
    points = sorted({t for t0, t1, _ in clipped for t in (t0, t1)})
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2.0
        for phase in _SWEEP_PRIORITY:
            if any(t0 <= mid < t1 for t0, t1, p in clipped
                   if p == phase):
                covered[phase] += b - a
                break
    return covered


def attribute_host(flight: Sequence[dict],
                   metrics: Optional[Sequence[dict]] = None,
                   host: str = "") -> Optional[dict]:
    """One host's per-step time budget (see module docstring).

    ``flight`` / ``metrics`` are the JSONL record lists of the host's
    dump pair (``kind`` meta lines tolerated and skipped).  Returns
    None for a flight stream with no events.
    """
    events = sorted((r for r in flight if r.get("ev")),
                    key=lambda r: int(r.get("seq", 0)))
    if not events:
        return None
    notes: List[str] = []
    step_ts = [float(e.get("ts", 0.0)) for e in events
               if e.get("ev") == "step"]
    if len(step_ts) >= 2:
        windows = list(zip(step_ts, step_ts[1:]))
    else:
        windows = [(float(events[0].get("ts", 0.0)),
                    float(events[-1].get("ts", 0.0)))]
        notes.append("no step markers; whole-ring window")

    intervals, pair_stats = _pair_intervals(events)
    if pair_stats["unpaired_done"]:
        notes.append(f"{pair_stats['unpaired_done']} completion edge(s) "
                     "lost their dispatch edge (wrapped ring); costed "
                     "from the previous event")
    if pair_stats["unpaired_dispatch"]:
        notes.append(f"{pair_stats['unpaired_dispatch']} dispatch(es) "
                     "never completed in-ring (in flight or wedged)")

    plan_mean = hist_mean(metrics or (), "tm_plan_build_seconds")
    guard_mean = hist_mean(metrics or (), "tm_guard_verify_us", 1e-6)

    totals = {p: 0.0 for p in PHASES}
    wall = 0.0
    clamped = False
    for w0, w1 in windows:
        span = w1 - w0
        if span <= 0:
            continue
        wall += span
        covered = _sweep_coverage(intervals, w0, w1)
        n_plan = sum(1 for e in events if e.get("ev") == "plan"
                     and w0 <= float(e.get("ts", 0.0)) < w1)
        n_guard = sum(1 for e in events if e.get("ev") == "guard"
                      and e.get("detail") in _GUARD_VERIFY_DETAILS
                      and w0 <= float(e.get("ts", 0.0)) < w1)
        compile_s = n_plan * (plan_mean or 0.0)
        guard_s = n_guard * (guard_mean or 0.0)
        if n_plan and plan_mean is None:
            notes.append("plan events without tm_plan_build_seconds; "
                         "compile share under-counted")
        if n_guard and guard_mean is None:
            notes.append("guard events without tm_guard_verify_us; "
                         "guard share under-counted")
        avail = max(0.0, span - sum(covered.values()))
        synth = compile_s + guard_s
        if synth > avail and synth > 0:
            scale = avail / synth
            compile_s *= scale
            guard_s *= scale
            clamped = True
        totals["collective_wait"] += covered["collective_wait"]
        totals["host_staging"] += covered["host_staging"]
        totals["compile"] += compile_s
        totals["guard_verify"] += guard_s
        totals["dispatch_gap"] += max(
            0.0, span - sum(covered.values()) - compile_s - guard_s)
    if clamped:
        notes.append("histogram-costed phases clamped into the "
                     "uncovered remainder")
    if wall <= 0:
        notes.append("zero-length window; shares undefined")
    n_steps = max(1, len(step_ts) - 1) if len(step_ts) >= 2 else 1
    return {
        "host": host,
        "steps": n_steps,
        "events": len(events),
        "wall_s": wall,
        "step_ms": (wall / n_steps) * 1e3,
        "phases": {p: {"seconds": totals[p],
                       "share": (totals[p] / wall) if wall > 0 else 0.0}
                   for p in PHASES},
        "notes": notes,
    }


def aggregate_shares(budgets: Sequence[dict]) -> Dict[str, float]:
    """Wall-time-weighted phase shares across hosts (seconds-summing,
    so a long host counts for its length, not one vote)."""
    wall = sum(b["wall_s"] for b in budgets)
    out = {}
    for p in PHASES:
        secs = sum(b["phases"][p]["seconds"] for b in budgets)
        out[p] = (secs / wall) if wall > 0 else 0.0
    return out


def diff_budgets(before: Sequence[dict],
                 after: Sequence[dict]) -> dict:
    """Name the phase whose share regressed between two dumps.

    Shares (not raw seconds) are compared so a run with more steps is
    not 'regressed' merely for being longer; the verdict is the phase
    with the largest share increase.
    """
    b = aggregate_shares(before)
    a = aggregate_shares(after)
    deltas = {p: a[p] - b[p] for p in PHASES}
    regressed = max(PHASES, key=lambda p: deltas[p])
    step_b = (sum(x["wall_s"] for x in before)
              / max(1, sum(x["steps"] for x in before)))
    step_a = (sum(x["wall_s"] for x in after)
              / max(1, sum(x["steps"] for x in after)))
    return {
        "regressed": regressed if deltas[regressed] > 0 else None,
        "deltas": deltas,
        "before": {"shares": b, "step_s": step_b},
        "after": {"shares": a, "step_s": step_a},
        "step_ratio": (step_a / step_b) if step_b > 0 else None,
    }


def format_table(budgets: Sequence[dict]) -> str:
    """Fixed-width per-host table (the ``obs_tool attribute`` default
    rendering)."""
    head = (["host", "steps", "ms/step"]
            + [p for p in PHASES] + ["notes"])
    rows = [head]
    for b in budgets:
        rows.append(
            [str(b["host"]), str(b["steps"]), f"{b['step_ms']:.2f}"]
            + [f"{b['phases'][p]['share'] * 100:5.1f}%" for p in PHASES]
            + ["; ".join(b["notes"]) if b["notes"] else "-"])
    widths = [max(len(r[i]) for r in rows) for i in range(len(head))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
