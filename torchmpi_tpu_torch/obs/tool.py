"""Dump, diff, aggregate, and blame torchmpi_tpu_torch telemetry files
(docs/OBSERVABILITY_TORCH.md).

The PyTorch counterpart of the JAX package's ``scripts/obs_tool.py``,
with the same commands and the same output on the same files (the two
packages' dumps share one format).  The obs layer
(``torchmpi_tpu_torch.obs``) writes one JSONL file per host:
``metrics_host*.jsonl`` (counter/histogram snapshot) and
``flight_host*.jsonl`` (the deadlock flight recorder's event ring).
This tool is the operator surface over those files:

    python -m torchmpi_tpu_torch.obs.tool dump  FILE [FILE ...]
    python -m torchmpi_tpu_torch.obs.tool agg   FILE [FILE ...] [--json]
    python -m torchmpi_tpu_torch.obs.tool diff  BEFORE AFTER
    python -m torchmpi_tpu_torch.obs.tool prom  FILE [FILE ...]
    python -m torchmpi_tpu_torch.obs.tool blame FLIGHT [FLIGHT ...]
    python -m torchmpi_tpu_torch.obs.tool slo   FILE [FILE ...]
    python -m torchmpi_tpu_torch.obs.tool attribute DIR_OR_FLIGHT [...] [--json]
    python -m torchmpi_tpu_torch.obs.tool attribute --diff BEFORE_DIR AFTER_DIR

``slo`` reads a serving session's metric dumps and prints per-replica
p50/p95/p99 time-to-first-token and inter-token latency from the
``tm_serving_ttft_us`` / ``tm_serving_itl_us`` histograms —
percentiles are upper log2-bucket edges, i.e. conservative to within
2x, which is what a latency SLO check wants.  ``dump`` validates and
pretty-prints any obs file.  ``agg`` sums counters and merges
histograms across per-host metric files (the fleet view).  ``diff``
prints per-series counter deltas between two snapshots of the same
host (rate over an interval).  ``prom`` renders the aggregated snapshot
in Prometheus text format.  ``blame`` aligns per-host flight-recorder
seq streams and names the FIRST diverging collective: hosts of one SPMD
gang must issue identical collective sequences, so the first seq where
op/bytes differ (or where one host keeps launching past the others'
last event) is where the hang began.  ``attribute`` turns a host's
flight ring + histograms into a per-step time budget — dispatch_gap /
collective_wait / host_staging / compile / guard_verify shares summing
to the step wall time (the phase model lives in ``obs/attribution.py``)
— and ``attribute --diff`` names the phase whose share regressed
between two dumps.  Since the ring records BOTH edges of a collective
(dispatch + the ``*_done`` completion events), the laggard's last
event distinguishes "launched and stuck inside it" from "completed,
never launched the next".  ``blame --live <dir>`` skips the dumps: it
reads the watchdog's ``wd_lease_*.json`` liveness leases
(``Config.watchdog_dir``, ``torchmpi_tpu_torch/watchdog.py``) while the
job runs and names each rank live, stalled (and where), expired or
escalated.  Exits nonzero on divergence (blame), on a stalled or dead
rank (blame --live) or unparseable input.

It reads the files with the standard library alone, beside the
dependency-free ``obs/registry.py`` and ``obs/attribution.py``.
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple


def _load_registry_module():
    """The registry module (its Prometheus renderer; ``obs.registry`` is
    also the name of the package's accessor function)."""
    import importlib

    return importlib.import_module(__package__ + ".registry")


def load_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Parse one obs JSONL file -> (meta, records).  Raises ValueError
    with a line number on malformed input."""
    meta: dict = {}
    records: List[dict] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from None
            if not isinstance(rec, dict) or "kind" not in rec:
                raise ValueError(f"{path}:{i}: record without 'kind'")
            if rec["kind"] == "meta":
                meta = rec
            else:
                records.append(rec)
    return meta, records


def _series_key(rec: dict) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return (rec["name"], tuple(sorted(rec.get("labels", {}).items())))


def _fmt_series(name: str, labels) -> str:
    lab = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{lab}}}" if lab else name


def aggregate(files: List[str]) -> List[dict]:
    """Sum counters / merge histograms across metric files."""
    counters: Dict = {}
    hists: Dict = {}
    for path in files:
        _, records = load_jsonl(path)
        for rec in records:
            if rec["kind"] == "counter":
                k = _series_key(rec)
                counters[k] = counters.get(k, 0) + rec["value"]
            elif rec["kind"] == "hist":
                k = _series_key(rec)
                h = hists.setdefault(k, {"buckets": {}, "count": 0,
                                         "sum": 0.0})
                for b, c in rec.get("buckets", {}).items():
                    h["buckets"][b] = h["buckets"].get(b, 0) + c
                h["count"] += rec.get("count", 0)
                h["sum"] += rec.get("sum", 0.0)
    out = [{"kind": "counter", "name": n, "labels": dict(lk), "value": v}
           for (n, lk), v in sorted(counters.items())]
    out += [{"kind": "hist", "name": n, "labels": dict(lk),
             "buckets": dict(sorted(h["buckets"].items(),
                                    key=lambda kv: int(kv[0]))),
             "count": h["count"], "sum": h["sum"]}
            for (n, lk), h in sorted(hists.items())]
    return out


def cmd_dump(args) -> int:
    rc = 0
    for path in args.files:
        try:
            meta, records = load_jsonl(path)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            rc = 1
            continue
        stream = meta.get("stream", "?")
        print(f"{path}: stream={stream} host={meta.get('host')} "
              f"mode={meta.get('mode')} records={len(records)}")
        for rec in records:
            if rec["kind"] == "counter":
                print(f"  {_fmt_series(rec['name'], sorted(rec.get('labels', {}).items()))}"
                      f" = {rec['value']}")
            elif rec["kind"] == "hist":
                bk = " ".join(f"2^{b}:{c}" for b, c
                              in sorted(rec.get("buckets", {}).items(),
                                        key=lambda kv: int(kv[0])))
                print(f"  {_fmt_series(rec['name'], sorted(rec.get('labels', {}).items()))}"
                      f" count={rec['count']} sum={rec['sum']:.6g} [{bk}]")
            elif rec["kind"] == "event":
                print(f"  #{rec['seq']} {rec.get('ev')}:"
                      f"{rec.get('op') or rec.get('detail')}"
                      f" {rec.get('nbytes', 0)}B {rec.get('backend', '')}"
                      f" t={rec.get('ts', 0):.6f}")
    return rc


def cmd_agg(args) -> int:
    snap = aggregate(args.files)
    if args.json:
        print(json.dumps(snap, indent=1))
    else:
        print(f"aggregated {len(args.files)} file(s), {len(snap)} series")
        for rec in snap:
            labels = sorted(rec.get("labels", {}).items())
            if rec["kind"] == "counter":
                print(f"  {_fmt_series(rec['name'], labels)} = {rec['value']}")
            else:
                print(f"  {_fmt_series(rec['name'], labels)} "
                      f"count={rec['count']} sum={rec['sum']:.6g}")
    return 0


def cmd_diff(args) -> int:
    _, before = load_jsonl(args.before)
    _, after = load_jsonl(args.after)
    b = {_series_key(r): r["value"] for r in before
         if r["kind"] == "counter"}
    a = {_series_key(r): r["value"] for r in after
         if r["kind"] == "counter"}
    shown = 0
    for k in sorted(set(b) | set(a)):
        d = a.get(k, 0) - b.get(k, 0)
        if d:
            shown += 1
            sign = "+" if d > 0 else ""
            print(f"  {_fmt_series(k[0], k[1])} {b.get(k, 0)} -> "
                  f"{a.get(k, 0)}  ({sign}{d})")
    print(f"{shown} series changed")
    return 0


def cmd_prom(args) -> int:
    reg = _load_registry_module()
    snap = aggregate(args.files)
    sys.stdout.write("\n".join(reg.prometheus_lines(snap)) + "\n")
    return 0


def _hist_percentile(buckets: Dict[str, int], count: int,
                     q: float) -> float:
    """Approximate quantile from log2 buckets: the UPPER edge
    ``2**(b+1)`` of the first bucket whose cumulative count reaches
    ``q * count`` — conservative (never under-reports a latency)."""
    target = q * count
    acc = 0
    for b, c in sorted(buckets.items(), key=lambda kv: int(kv[0])):
        acc += c
        if acc >= target:
            return float(2 ** (int(b) + 1))
    return 0.0


def cmd_slo(args) -> int:
    snap = aggregate(args.files)
    series: Dict[Tuple[str, str], dict] = {}
    counters: Dict[Tuple[str, str], float] = {}
    for rec in snap:
        rep = rec.get("labels", {}).get("replica", "")
        if rec["kind"] == "hist" and rec["name"] in (
                "tm_serving_ttft_us", "tm_serving_itl_us"):
            kind = "ttft" if "ttft" in rec["name"] else "itl"
            series[(rep, kind)] = rec
        elif rec["kind"] == "counter" and \
                rec["name"].startswith("tm_serving_"):
            # aggregate() already merged each (name, labels) series to
            # one record — plain assignment states that invariant.
            counters[(rep, rec["name"])] = rec["value"]
    if not series:
        print("no tm_serving_* latency histograms in the given files "
              "(was the session a serving run with obs active?)",
              file=sys.stderr)
        return 2
    replicas = sorted({rep for rep, _ in series})
    print(f"serving SLO percentiles over {len(args.files)} file(s) "
          f"(upper log2-bucket edges):")
    for rep in replicas:
        parts = []
        for kind, label in (("ttft", "TTFT"), ("itl", "inter-token")):
            rec = series.get((rep, kind))
            if rec is None or not rec.get("count"):
                continue
            ps = {p: _hist_percentile(rec.get("buckets", {}),
                                      rec["count"], p / 100.0) / 1e3
                  for p in (50, 95, 99)}
            mean = rec["sum"] / rec["count"] / 1e3
            parts.append(
                f"{label} p50<={ps[50]:g}ms p95<={ps[95]:g}ms "
                f"p99<={ps[99]:g}ms mean={mean:.3g}ms n={rec['count']}")
        extras = []
        for cname in ("tm_serving_requests_total",
                      "tm_serving_completed_total",
                      "tm_serving_rerouted_total",
                      "tm_serving_rejected_total",
                      "tm_serving_prefill_compiles_total",
                      "tm_serving_spec_drafted_total",
                      "tm_serving_spec_accepted_total",
                      "tm_serving_prefix_hits_total",
                      "tm_serving_prefix_misses_total",
                      "tm_serving_prefix_tokens_saved_total",
                      "tm_serving_prefix_bytes_saved_total",
                      "tm_serving_prefix_inserted_total",
                      "tm_serving_prefix_evicted_total"):
            v = counters.get((rep, cname))
            if v:
                label = cname[len("tm_serving_"):-len("_total")]
                extras.append(f"{label}={int(v)}")
        rep_name = rep or "<all>"
        tail = f"  [{' '.join(extras)}]" if extras else ""
        print(f"  {rep_name}: " + " | ".join(parts) + tail)
    # Fleet/admission summary: the gate and the autoscaler are global
    # (replica-unlabeled), so they print once — shed/admitted counts,
    # scale events, and the queue-depth p95 the controller acts on.
    fleet = []
    for cname in ("tm_serving_admitted_total", "tm_serving_shed_total",
                  "tm_serving_scale_up_total",
                  "tm_serving_scale_down_total"):
        v = sum(val for (rep, name), val in counters.items()
                if name == cname)
        if v:
            fleet.append(f"{cname[len('tm_serving_'):-len('_total')]}="
                         f"{int(v)}")
    depth = next((rec for rec in snap
                  if rec["kind"] == "hist"
                  and rec["name"] == "tm_serving_queue_depth"), None)
    if depth is not None and depth.get("count"):
        p95 = _hist_percentile(depth.get("buckets", {}), depth["count"],
                               0.95)
        mean = depth["sum"] / depth["count"]
        fleet.append(f"queue_depth p95<={p95:g} mean={mean:.3g} "
                     f"ticks={depth['count']}")
    if fleet:
        print(f"  fleet: {' '.join(fleet)}")
    return 0


def _event_sig(e: dict) -> Tuple:
    """What must agree across an SPMD gang at one seq: the event type,
    op, and payload (backend compared too — hosts replaying divergent
    tuning plans compile different programs, the PL1 hazard)."""
    return (e.get("ev"), e.get("op"), e.get("nbytes"),
            e.get("backend"))


# Dispatch events that now have a matching completion edge in the ring
# (docs/FAULTS_TORCH.md): a laggard whose LAST event is one of these died
# INSIDE that collective; a laggard whose last event is a *_done edge
# completed its last collective and hung before launching the next.
_DISPATCH_EVENTS = ("eager", "barrier")
_DONE_EVENTS = ("eager_done", "barrier_done", "ps_wait_done")


def _laggard_verdict(last_event: dict) -> str:
    ev = last_event.get("ev", "")
    what = f"{ev}:{last_event.get('op') or last_event.get('detail')}"
    if ev in _DISPATCH_EVENTS:
        return (f"last event is a DISPATCH ({what}) with no completion "
                f"edge — launched and stuck INSIDE that collective")
    if ev == "eager_done" and last_event.get("backend") != "host":
        # The direct (XLA) path's done edge marks the ASYNC ENQUEUE
        # returning, not device execution finishing — a wedge in the
        # fabric still happens after this edge, at the blocking
        # readiness wait.
        return (f"last event is the dispatch-returned edge ({what}, "
                f"direct backend) — the collective was enqueued; the "
                f"wedge is in its device execution or in whatever "
                f"comes after (check async waits / block_until_ready)")
    if ev in _DONE_EVENTS:
        return (f"last event is a COMPLETION edge ({what}) — its last "
                f"collective finished; the NEXT one was never launched "
                f"(stuck between collectives: data loader, host code, "
                f"or a non-collective wait)")
    return f"last event: {what}"


def cmd_blame(args) -> int:
    if getattr(args, "live", False):
        return cmd_blame_live(args)
    streams: Dict[str, Dict[int, dict]] = {}
    for path in args.files:
        meta, records = load_jsonl(path)
        events = {r["seq"]: r for r in records if r["kind"] == "event"}
        host = str(meta.get("host", path))
        streams[f"{host} ({os.path.basename(path)})"] = events
    if len(streams) < 2:
        print("blame needs >= 2 per-host flight files", file=sys.stderr)
        return 2
    names = sorted(streams)
    if not all(streams.values()):
        print("a host recorded no flight events — nothing to align")
        return 2
    lo = max(min(s) for s in streams.values())
    hi = min(max(s) for s in streams.values())
    if hi < lo:
        print("no overlapping seq range across hosts (rings trimmed "
              "past each other) — raise obs_ring_size")
        return 2
    for seq in range(lo, hi + 1):
        sigs = {n: _event_sig(streams[n][seq]) for n in names
                if seq in streams[n]}
        if len(set(sigs.values())) > 1:
            print(f"DIVERGENCE at seq {seq} — first collective the "
                  f"hosts disagree on:")
            for n in names:
                e = streams[n].get(seq)
                desc = (f"{e.get('ev')}:{e.get('op') or e.get('detail')} "
                        f"{e.get('nbytes', 0)}B {e.get('backend', '')}"
                        if e else "<no event>")
                print(f"  {n}: {desc}")
            return 1
    # Aligned over the overlap: a host that kept launching past the
    # others' last event names the collective the laggards never
    # reached — the classic "rank 0 is stuck, rank 1 moved on" hang.
    ends = {n: max(s) for n, s in streams.items()}
    last = min(ends.values())
    ahead = {n: e for n, e in ends.items() if e > last}
    if ahead:
        print(f"aligned through seq {last}; "
              f"{len(ahead)}/{len(names)} host(s) continued past it:")
        for n, e in sorted(ahead.items()):
            nxt = streams[n].get(last + 1)
            desc = (f"{nxt.get('ev')}:{nxt.get('op') or nxt.get('detail')} "
                    f"{nxt.get('nbytes', 0)}B" if nxt else "?")
            print(f"  {n}: reached seq {e}; first extra event: {desc}")
        print("the lagging host(s) likely hang in (or before) that "
              "collective")
        for n in sorted(set(names) - set(ahead)):
            # Both edges are recorded now (dispatch + completion), so
            # the laggard's last event says WHERE it died: inside its
            # last collective, or between collectives.
            print(f"  {n}: {_laggard_verdict(streams[n][ends[n]])}")
        return 1
    print(f"aligned: {len(names)} hosts agree on seqs {lo}..{hi}")
    return 0


def _load_leases(directory: str) -> Dict[int, dict]:
    """Parse every ``wd_lease_*.json`` under ``directory`` (the
    collective watchdog's liveness leases, docs/FAULTS_TORCH.md) keyed by
    rank.  Parsing is inlined on purpose — this tool must not import
    the job's software stack; the lease schema is self-describing
    (each lease carries its own ``ttl_s``)."""
    out: Dict[int, dict] = {}
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("wd_lease_") and n.endswith(".json"))
    except OSError as e:
        raise ValueError(f"{directory}: {e}") from None
    for name in names:
        try:
            with open(os.path.join(directory, name)) as f:
                d = json.load(f)
            out[int(d["rank"])] = d
        except (OSError, ValueError, KeyError):
            continue  # torn mid-renewal — same as unrenewed
    return out


def cmd_blame_live(args) -> int:
    """``blame --live <dir>``: read the watchdog leases while the job
    RUNS — no dumps, no SIGTERM — and name the implicated rank(s).
    The triage matrix (docs/FAULTS_TORCH.md): a rank whose lease is FRESH
    but whose collective is STALLED is wedged on a *peer*; an EXPIRED
    or ``escalated`` lease is that rank's own death evidence; a fresh
    lease with ``state=parked`` is a quorum-lost minority waiting out
    a partition (``elastic._park``) — alive, deliberately idle, and NOT
    to be restarted; a fresh lease with ``state=migrating`` is a live
    hot-state drain in flight (``hotstate.migrate``,
    docs/HOTSTATE_TORCH.md — the detail carries ``source -> spare``): in transition BY DESIGN, neither parked nor
    dead, and killing either end mid-drain forfeits the zero-rollback
    hand-off.  Exits 1 when anything is stalled/expired/parked/
    migrating, 0 when all ranks look healthy, 2 on unusable input."""
    import time

    if len(args.files) != 1:
        print("blame --live takes exactly one lease DIRECTORY "
              "(Config.watchdog_dir / the membership board)",
              file=sys.stderr)
        return 2
    directory = args.files[0]
    leases = _load_leases(directory)
    if not leases:
        print(f"no wd_lease_*.json under {directory} — is the watchdog "
              f"armed (Config.watchdog != 'off') with watchdog_dir "
              f"pointing here?", file=sys.stderr)
        return 2
    now = time.time()
    implicated = []
    parked = []
    migrating = []
    stalled_peers = set()
    print(f"live watchdog leases in {directory} ({len(leases)} rank(s)):")
    for rank in sorted(leases):
        d = leases[rank]
        age = now - float(d.get("ts", 0))
        expired = age > float(d.get("ttl_s", 0))
        stalls = [e for e in d.get("inflight", []) if e.get("stalled")]
        if d.get("escalated"):
            state = (f"ESCALATED (watchdog exited the process on an "
                     f"unbreakable stall; lease renewed {age:.1f}s ago)")
            implicated.append(rank)
        elif expired:
            state = (f"EXPIRED (last renewed {age:.1f}s ago, ttl "
                     f"{d.get('ttl_s')}s) — dead, or wedged beyond its "
                     f"own watchdog")
            implicated.append(rank)
        elif d.get("state") == "parked":
            # A quorum-parked minority (``elastic._park``; "Partitions
            # and split-brain"): deliberately idle, lease FRESH — not
            # a corpse, not a stall.  It rejoins the majority's
            # committed epoch on its own once the partition heals.
            detail = d.get("state_detail") or "a newer committed epoch"
            state = (f"PARKED (quorum lost — {detail}; lease renewed "
                     f"{age:.1f}s ago; will rejoin at heal, no "
                     f"restart needed)")
            parked.append(rank)
        elif d.get("state") == "migrating":
            # A live hot-state drain (``hotstate.migrate``): the rank is
            # mid-hand-off onto a spare — in transition BY DESIGN,
            # lease fresh.  Distinct from parked (it is not waiting on
            # anything external) and from dead (killing it mid-drain
            # forfeits the zero-rollback migration).
            detail = d.get("state_detail") or "onto a spare"
            state = (f"MIGRATING ({detail}; lease renewed {age:.1f}s "
                     f"ago — live drain in flight, do not kill either "
                     f"end)")
            migrating.append(rank)
        elif stalls:
            parts = ", ".join(
                f"{e.get('site')}"
                + (f" op={e.get('op')}" if e.get("op") else "")
                + (f" peer={e.get('peer')}" if e.get("peer") else "")
                + f" for {e.get('elapsed_s', 0):.3g}s"
                + (" [break requested]" if e.get("break_requested")
                   else "")
                for e in stalls)
            state = f"LIVE but STALLED in {parts}"
            stalled_peers.update(e.get("peer") for e in stalls
                                 if e.get("peer"))
        elif d.get("inflight"):
            state = (f"LIVE (renewed {age:.1f}s ago), "
                     f"{len(d['inflight'])} collective(s) in flight")
        else:
            state = f"LIVE idle (renewed {age:.1f}s ago)"
        print(f"  rank {rank}: {state}")
    verdicts = []
    if implicated:
        verdicts.append(
            f"rank(s) {implicated} implicated (expired/escalated lease "
            f"— the elastic layer treats this as death evidence)")
    if parked:
        verdicts.append(
            f"rank(s) {parked} PARKED (quorum-lost minority waiting "
            f"out a partition — alive and heartbeating, NOT a corpse; "
            f"they readmit themselves once the board heals)")
    if migrating:
        verdicts.append(
            f"rank(s) {migrating} MIGRATING (hot-state drain onto a "
            f"spare in flight — transitional, not parked, not dead; "
            f"leave both ends alone until the lease returns to "
            f"running)")
    stalled_ranks = [r for r in sorted(leases)
                     if any(e.get("stalled")
                            for e in leases[r].get("inflight", []))]
    if stalled_ranks and not implicated:
        peers = sorted(p for p in stalled_peers if p and p != "gang")
        blame_s = f"; stalls implicate {peers}" if peers else ""
        verdicts.append(
            f"rank(s) {stalled_ranks} stalled with fresh leases — the "
            f"hang is on a peer (or the fabric), not their own "
            f"liveness{blame_s}")
    if verdicts:
        print("verdict: " + "; ".join(verdicts))
        return 1
    print("verdict: all ranks healthy (fresh leases, no stalls)")
    return 0


def _load_attribution_module():
    """The attribution module (the phase model, stdlib-only)."""
    from . import attribution

    return attribution


def _flight_files(paths: List[str]) -> List[str]:
    """Expand dump directories to their flight_host*.jsonl files."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            found = sorted(os.path.join(p, f) for f in os.listdir(p)
                           if f.startswith("flight_host")
                           and f.endswith(".jsonl"))
            if not found:
                raise ValueError(f"{p}: no flight_host*.jsonl files")
            out.extend(found)
        else:
            out.append(p)
    return out


def _attribute_paths(attr, paths: List[str]) -> List[dict]:
    """Per-host budgets for a dump: each flight file paired with its
    sibling metrics_host*.jsonl (same host suffix) when present."""
    budgets: List[dict] = []
    for fpath in _flight_files(paths):
        meta, flight = load_jsonl(fpath)
        mpath = os.path.join(
            os.path.dirname(fpath),
            os.path.basename(fpath).replace("flight_host",
                                            "metrics_host", 1))
        metrics: List[dict] = []
        if mpath != fpath and os.path.exists(mpath):
            _, metrics = load_jsonl(mpath)
        host = str(meta.get("host", "")) or os.path.basename(fpath)
        b = attr.attribute_host(flight, metrics, host=host)
        if b is not None:
            budgets.append(b)
    return budgets


def cmd_attribute(args) -> int:
    attr = _load_attribution_module()
    if args.diff:
        if args.files:
            raise ValueError("--diff takes its two dumps as the diff "
                             "arguments; drop the positional files")
        before = _attribute_paths(attr, [args.diff[0]])
        after = _attribute_paths(attr, [args.diff[1]])
        if not before or not after:
            raise ValueError("no events to attribute in one of the "
                             "dumps")
        d = attr.diff_budgets(before, after)
        if args.json:
            print(json.dumps(d, indent=2, sort_keys=True))
            return 0
        for p in attr.PHASES:
            print(f"{p:16s} {d['before']['shares'][p] * 100:6.1f}% -> "
                  f"{d['after']['shares'][p] * 100:6.1f}%  "
                  f"({d['deltas'][p] * +100:+.1f}pp)")
        ratio = d["step_ratio"]
        if ratio is not None:
            print(f"step wall: {d['before']['step_s'] * 1e3:.2f}ms -> "
                  f"{d['after']['step_s'] * 1e3:.2f}ms ({ratio:.2f}x)")
        if d["regressed"]:
            print(f"regressed phase: {d['regressed']} "
                  f"(+{d['deltas'][d['regressed']] * 100:.1f}pp of "
                  f"step time)")
        else:
            print("regressed phase: none (no share grew)")
        return 0
    if not args.files:
        raise ValueError("give a dump directory or flight_host*.jsonl "
                         "files (or --diff BEFORE AFTER)")
    budgets = _attribute_paths(attr, args.files)
    if not budgets:
        raise ValueError("no events to attribute (empty flight rings)")
    if args.json:
        print(json.dumps({"hosts": budgets,
                          "aggregate": attr.aggregate_shares(budgets)},
                         indent=2, sort_keys=True))
        return 0
    print(attr.format_table(budgets))
    agg = attr.aggregate_shares(budgets)
    print("aggregate: " + "  ".join(
        f"{p}={agg[p] * 100:.1f}%" for p in attr.PHASES))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("dump", help="validate + pretty-print obs files")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_dump)

    s = sub.add_parser("agg", help="aggregate per-host metric files")
    s.add_argument("files", nargs="+")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_agg)

    s = sub.add_parser("diff", help="counter deltas between two snapshots")
    s.add_argument("before")
    s.add_argument("after")
    s.set_defaults(fn=cmd_diff)

    s = sub.add_parser("prom", help="render aggregate as Prometheus text")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_prom)

    s = sub.add_parser("blame", help="align per-host flight recorders, "
                                     "name the first diverging collective; "
                                     "--live reads watchdog leases from a "
                                     "directory while the job runs")
    s.add_argument("files", nargs="+",
                   help="flight_host*.jsonl files, or with --live ONE "
                        "lease directory")
    s.add_argument("--live", action="store_true",
                   help="read wd_lease_*.json liveness leases instead of "
                        "post-mortem flight dumps (the port's watchdog "
                        "does not write them yet)")
    s.set_defaults(fn=cmd_blame)

    s = sub.add_parser("slo", help="per-replica p50/p95/p99 TTFT and "
                                   "inter-token latency from a serving "
                                   "session's metric dumps")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_slo)

    s = sub.add_parser("attribute",
                       help="per-step time budget from a host's flight "
                            "ring + histograms (dispatch_gap / "
                            "collective_wait / host_staging / compile "
                            "/ guard_verify); --diff names the phase "
                            "whose share regressed between two dumps")
    s.add_argument("files", nargs="*",
                   help="dump directory or flight_host*.jsonl files "
                        "(sibling metrics_host*.jsonl auto-paired)")
    s.add_argument("--json", action="store_true")
    s.add_argument("--diff", nargs=2, metavar=("BEFORE", "AFTER"),
                   help="two dump directories (or flight files) to "
                        "compare")
    s.set_defaults(fn=cmd_attribute)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        return 0  # `obs_tool ... | head` is fine
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
