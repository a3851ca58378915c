"""Runtime observability: collective telemetry registry + flight recorder.

The PyTorch counterpart of ``torchmpi_tpu/obs/__init__.py``: the same
metrics, flight events, dump files and hooks, so either package's
operator tool (``python -m torchmpi_tpu_torch.obs.tool``, the JAX
package's ``scripts/obs_tool.py``) reads the other's dumps.

Off by default and **never imported when off**: every call site in the
port guards its ``obs`` hook behind one ``Config.obs != "off"`` branch
(or goes through the ``sys.modules``-gated shim ``utils.telemetry``), so
a run that never opts in pays one string compare per collective dispatch
and no import.  Enable via ``Config.obs`` / ``TORCHMPI_TPU_OBS``:

- ``"metrics"`` — the :class:`~torchmpi_tpu_torch.obs.registry.Registry`
  accumulates counters and log2-bucketed histograms (per-op launch and
  byte counts keyed by op/dtype/size-bucket/backend/mesh, fusion
  coalescing stats, gradient-sync rounds, ZeRO legs, plan and tuning
  hits/misses, parameter-server counters, serving SLOs), and the
  :class:`~torchmpi_tpu_torch.obs.recorder.FlightRecorder` ring buffers
  the last N collective events appended *before* dispatch — the
  post-mortem for runtime deadlocks (``tool blame`` aligns per-host dumps
  and names the first diverging collective).  Both are dumped per host as
  JSONL (renderable as Prometheus text) at exit, on SIGTERM, or via
  :func:`dump`.
- ``"trace"`` — metrics plus per-event *user call-site attribution* (a
  stack walk per eager dispatch — the one costly hook, so it is gated
  behind the louder mode).

One convention differs from the JAX package (ROADMAP queue C note 31):
JAX's in-axis, fusion, gradsync and ZeRO hooks run when a program is
traced, so a cached jitted step counts once; the port runs eagerly and
counts every call.  Byte counts come from shapes and ``element_size``,
never from a device read, and no hook synchronizes with the device: the
"done" edge of a device backend is the return of its enqueue.

See docs/OBSERVABILITY_TORCH.md for the metric catalog and workflows.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import tempfile
import threading
import time
from typing import List, Optional

from .recorder import FlightRecorder
from .registry import Registry, log2_bucket, prometheus_lines

MODES = ("off", "metrics", "trace")

# The JAX package's default, under this process's temporary directory.
DEFAULT_OUT_DIR = os.path.join(tempfile.gettempdir(), "torchmpi_tpu_obs")
DEFAULT_RING = 1024

_lock = threading.Lock()
_mode = "off"
_out_dir = DEFAULT_OUT_DIR
_host = str(os.getpid())
_registry = Registry()
_recorder = FlightRecorder(DEFAULT_RING)
_atexit_armed = False
# Previous SIGTERM disposition while our handler is installed.  The
# sentinel is NOT None: signal.signal() legitimately returns None when
# the prior handler was installed from C, and that case must still
# terminate (treated like SIG_DFL) rather than read as "not installed".
_UNINSTALLED = object()
_prev_sigterm = _UNINSTALLED


def mode() -> str:
    return _mode


def active() -> bool:
    return _mode != "off"


def tracing() -> bool:
    return _mode == "trace"


def registry() -> Registry:
    return _registry


def recorder() -> FlightRecorder:
    return _recorder


def mesh_label(mesh, n: Optional[int] = None) -> str:
    """``axis:size`` signature of a communicator (the JAX package's
    ``Mesh`` label): ``runtime.Communicator.shape(n)``, over a rank-major
    stack of ``n`` or, for None, the process world; anything with a
    ``shape`` dict reads as JAX's mesh does."""
    try:
        shape = mesh.shape(n) if callable(mesh.shape) else mesh.shape
        return ",".join(f"{a}:{int(s)}" for a, s in shape.items())
    except Exception:  # noqa: BLE001 — a label must never fail a step
        return "unknown"


# ---------------------------------------------------------------------------
# Activation (runtime.init / set_config call this when Config.obs is on)
# ---------------------------------------------------------------------------


def activate(obs_mode: str, *, out_dir: Optional[str] = None,
             ring_size: Optional[int] = None,
             host: Optional[str] = None) -> None:
    """Turn telemetry on (idempotent; re-activation updates settings).

    Installs the atexit dump once per process and chains a SIGTERM
    handler (dump, then the previous disposition) so a preempted or
    timed-out job still leaves its per-host evidence behind.
    """
    global _mode, _out_dir, _host, _recorder
    if obs_mode not in ("metrics", "trace"):
        raise ValueError(f"obs mode must be metrics|trace, got {obs_mode!r}")
    with _lock:
        _mode = obs_mode
        if out_dir:
            _out_dir = out_dir
        if host is not None:
            _host = str(host)
        if ring_size is not None and int(ring_size) != _recorder.size:
            # Carry history + seq forward: a mid-run resize (e.g.
            # enlarging after blame reports trimmed rings) must not
            # destroy the evidence already collected.
            _recorder = _recorder.resized(int(ring_size))
    _arm_handlers()


def deactivate() -> None:
    """Stop recording; restores the pre-activation SIGTERM disposition.
    Accumulated data stays readable (and dumpable explicitly)."""
    global _mode, _prev_sigterm
    with _lock:
        _mode = "off"
        prev, _prev_sigterm = _prev_sigterm, _UNINSTALLED
    if prev is not _UNINSTALLED:
        try:
            # A C-installed prior handler (None) cannot be restored
            # from Python; SIG_DFL at least keeps TERM terminating.
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)
        except (ValueError, OSError):  # non-main thread / teardown
            pass


def reset() -> None:
    """Clear all accumulated telemetry (tests)."""
    _registry.clear()
    _recorder.clear()


def _arm_handlers() -> None:
    global _atexit_armed, _prev_sigterm
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(_atexit_dump)
    if _prev_sigterm is _UNINSTALLED:
        try:
            prev = signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            return  # signals only work in the main thread
        # Re-activation after our handler is already installed must not
        # chain to itself.
        _prev_sigterm = prev if prev is not _on_sigterm else signal.SIG_DFL


def _atexit_dump() -> None:
    if active():
        try:
            # best_effort: this also runs from the SIGTERM handler on
            # the main thread — a blocking acquire against a lock held
            # by the interrupted frame would self-deadlock the dump.
            dump(best_effort=True)
        except Exception:  # noqa: BLE001 — never mask the exit path
            pass


def _on_sigterm(signum, frame) -> None:
    _atexit_dump()
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL or prev is None or prev is _UNINSTALLED:
        # SIG_DFL, an unrestorable C-installed handler (None), or a
        # race with deactivate: preserve die-on-TERM semantics after
        # dumping — a polite kill must never be silently swallowed.
        try:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        except (ValueError, OSError):
            raise SystemExit(128 + signum)


# ---------------------------------------------------------------------------
# Dump (JSONL per host; Prometheus text on request)
# ---------------------------------------------------------------------------


def metrics_path(out_dir: Optional[str] = None) -> str:
    return os.path.join(out_dir or _out_dir, f"metrics_host{_host}.jsonl")


def flight_path(out_dir: Optional[str] = None) -> str:
    return os.path.join(out_dir or _out_dir, f"flight_host{_host}.jsonl")


def _meta(stream: str) -> dict:
    return {"kind": "meta", "stream": stream, "host": _host,
            "pid": os.getpid(), "mode": _mode, "time": time.time()}


def dump(out_dir: Optional[str] = None,
         prom_path: Optional[str] = None,
         best_effort: bool = False) -> List[str]:
    """Write this process's telemetry snapshot; returns paths written.

    Overwrites (snapshot semantics): each dump is the complete
    cumulative state, so the file left by SIGTERM/atexit is always
    whole.  ``prom_path`` additionally renders the metrics snapshot in
    Prometheus text format.  ``best_effort`` bounds the lock acquires
    (the signal-handler path — see ``Registry.snapshot``).
    """
    base = out_dir or _out_dir
    os.makedirs(base, exist_ok=True)
    written: List[str] = []
    snap = _registry.snapshot(best_effort)
    mpath = metrics_path(base)
    with open(mpath, "w") as f:
        for rec in [_meta("metrics")] + snap:
            f.write(json.dumps(rec) + "\n")
    written.append(mpath)
    fmeta = _meta("flight")
    fmeta.update({"ring": _recorder.size, "total": _recorder.total,
                  "dropped": _recorder.dropped})
    fpath = flight_path(base)
    with open(fpath, "w") as f:
        for rec in [fmeta] + _recorder.to_records(best_effort):
            f.write(json.dumps(rec) + "\n")
    written.append(fpath)
    if prom_path:
        with open(prom_path, "w") as f:
            f.write("\n".join(prometheus_lines(snap)) + "\n")
        written.append(prom_path)
    return written


# ---------------------------------------------------------------------------
# Call-site hooks.  Every caller gates on ``Config.obs != "off"`` before
# importing this module, so these can assume telemetry is wanted; they
# must still never raise into a training step.
# ---------------------------------------------------------------------------


def _call_site() -> str:
    """Best-effort user call site (``file.py:line``): the first stack
    frame outside this package AND outside installed libraries (torch's
    frames can sit between us and the user) — trace-mode only (a stack
    walk per dispatch is the one hook too costly for the metrics
    tier)."""
    import traceback

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for fr in reversed(traceback.extract_stack()[:-2]):
        fn = os.path.abspath(fr.filename)
        if fn.startswith(pkg) or "site-packages" in fn \
                or "dist-packages" in fn:
            continue
        return f"{fr.filename}:{fr.lineno}"
    return ""


def _dtype_name(dtype) -> str:
    """A dtype's label as the JAX package writes it ("float32", not
    "torch.float32"); "" for None."""
    return "" if dtype is None else str(dtype).rsplit(".", 1)[-1]


def record_eager(op: str, nbytes: int, backend: str, mesh,
                 dtype=None, n: Optional[int] = None) -> None:
    """One eager collective dispatch, rank-major or across processes
    (the runtime hot path: counter + byte histogram + flight event; trace
    mode adds the user call site to the event).  ``nbytes`` is one
    rank's payload, ``mesh`` the communicator and ``n`` the stack's
    ranks (None: the process world)."""
    mk = mesh_label(mesh, n)
    labels = dict(op=op, backend=backend, mesh=mk,
                  dtype=_dtype_name(dtype),
                  nbytes_bucket=f"b{log2_bucket(nbytes)}")
    _registry.counter_inc("tm_collectives_total", **labels)
    _registry.counter_inc("tm_collective_bytes_total", nbytes, **labels)
    _registry.hist_observe("tm_collective_nbytes", nbytes,
                           op=op, backend=backend, mesh=mk)
    detail = f"{mk} @{_call_site()}" if _mode == "trace" else mk
    _recorder.append("eager", op, nbytes, backend, detail)


def eager_recorder(op: str, nbytes: int, backend: str, mesh, dtype,
                   n: Optional[int] = None):
    """Pre-bound per-dispatch recorder for one eager CollectivePlan
    (``planner.py``): label-equivalent to :func:`record_eager` but with
    the label keys resolved ONCE at plan build, so the replay-path cost
    is three pre-keyed registry updates plus the flight-ring append.  The
    recorder reads the module-level mode/ring per call, so trace-mode
    attribution and ring resizes stay live."""
    mk = mesh_label(mesh, n)
    labels = dict(op=op, backend=backend, mesh=mk,
                  dtype=_dtype_name(dtype),
                  nbytes_bucket=f"b{log2_bucket(nbytes)}")
    inc_calls = _registry.counter_handle("tm_collectives_total", **labels)
    inc_bytes = _registry.counter_handle("tm_collective_bytes_total",
                                         **labels)
    obs_bytes = _registry.hist_handle("tm_collective_nbytes", op=op,
                                      backend=backend, mesh=mk)

    def record() -> None:
        inc_calls()
        inc_bytes(nbytes)
        obs_bytes(nbytes)
        detail = f"{mk} @{_call_site()}" if _mode == "trace" else mk
        _recorder.append("eager", op, nbytes, backend, detail)

    return record


def record_eager_done(op: str, nbytes: int, backend: str, mesh,
                      n: Optional[int] = None) -> None:
    """The COMPLETION edge of one eager dispatch (ring only — launch
    counters already counted it at the dispatch edge).  Pairing both
    edges is what lets ``obs_tool blame`` distinguish "launched and
    stuck inside it" (a dispatch with no matching ``eager_done``) from
    "launched and done, the next one never launched"
    (the live-blame workflow).  For a device backend it is the return of
    the enqueue, not the device's completion."""
    _recorder.append("eager_done", op, nbytes, backend,
                     mesh_label(mesh, n))


def eager_done_recorder(op: str, nbytes: int, backend: str, mesh,
                        n: Optional[int] = None):
    """Pre-bound completion recorder for one eager CollectivePlan (the
    :func:`eager_recorder` companion): labels resolved once at build,
    the replay pays one ring append."""
    mk = mesh_label(mesh, n)

    def record_done() -> None:
        _recorder.append("eager_done", op, nbytes, backend, mk)

    return record_done


def record_watchdog(action: str, site: str, *, op: str = "",
                    seq: int = -1, elapsed_s: float = 0.0,
                    peer: str = "") -> None:
    """One watchdog event (``torchmpi_tpu_torch/watchdog.py``, through
    ``utils/telemetry.py``):
    ``action`` is ``armed`` (an instrumented wait opened its in-flight
    window) | ``stalled`` (a window outlived ``watchdog_deadline_s``) |
    ``broken`` (break mode converted it into a typed
    ``CollectiveHangError``) | ``escalated`` (an unbreakable stall took
    the clean-exit ladder) | ``cleared`` (a flagged stall completed on
    its own — the genuinely-slow-collective signal deadline tuning
    reads) — counter ``tm_watchdog_<action>_total{site}``.  Everything
    past ``armed`` also rides the flight ring carrying op/seq/elapsed,
    so a post-mortem sees the stall verdict right next to the
    collective events it indicts."""
    labels = {"site": site}
    if peer:
        labels["peer"] = peer
    _registry.counter_inc(f"tm_watchdog_{action}_total", **labels)
    if action != "armed":
        detail = f"{action} elapsed={elapsed_s:.3g}s"
        if peer:
            detail += f" peer={peer}"
        _recorder.append("watchdog", op or site, max(0, int(seq)), site,
                         detail)


def record_plan(event: str, op: str, kind: str = "",
                build_s: Optional[float] = None) -> None:
    """One CollectivePlan table event (docs/PLANNER.md): ``event`` is
    ``hit`` | ``miss`` (counter ``tm_plan_<event>_total``, labeled by
    op and plan kind).  A miss — a plan build — also lands its build
    latency on the ``tm_plan_build_seconds`` histogram and a ``plan``
    flight-ring event, so post-mortems can see re-planning churn right
    next to the collectives it delayed.  (Steady-state hits are counted
    through per-plan pre-bound handles; this function is the build-side
    and tooling entry point.)"""
    _registry.counter_inc(f"tm_plan_{event}_total", op=op, kind=kind)
    if build_s is not None:
        _registry.hist_observe("tm_plan_build_seconds", build_s, op=op)
    if event == "miss":
        _recorder.append("plan", op, 0, kind, "build")


def record_in_axis(op: str, nbytes: int, axes) -> None:
    """One in-axis collective call (every call: the port runs eagerly,
    where JAX counts program traces; ROADMAP queue C note 31)."""
    _registry.counter_inc("tm_inaxis_calls_total", op=op,
                          axes=",".join(map(str, axes)),
                          nbytes_bucket=f"b{log2_bucket(nbytes)}")


def record_fusion(op: str, n_leaves: int, n_launches: int,
                  wire_bytes: int, saved_bytes: int) -> None:
    """One fused coalescing (``fusion.fuse_tree`` and the fused syncs;
    every call)."""
    _registry.counter_inc("tm_fusion_trees_total", op=op)
    _registry.counter_inc("tm_fusion_leaves_total", n_leaves, op=op)
    _registry.counter_inc("tm_fusion_buckets_total", n_launches, op=op)
    _registry.counter_inc("tm_fusion_wire_bytes_total", wire_bytes, op=op)
    _registry.counter_inc("tm_fusion_bytes_saved_total", saved_bytes, op=op)


def record_gradsync(n_buckets: int, op: str, compress) -> None:
    """One ``synchronize_gradients`` round (every call).  ``compress``
    is the wire codec NAME ("bf16", "dcn-int8", ... — "none" when
    uncompressed), so dumps distinguish the legacy bf16 cast from the
    quantized DCN codecs; boolean spellings from older callers keep
    their meaning (True == the legacy bf16 wire)."""
    if isinstance(compress, bool):
        name = "bf16" if compress else "none"
    else:
        name = str(compress) if compress else "none"
    _registry.counter_inc("tm_gradsync_rounds_total", op=op,
                          compressed=name)
    _registry.counter_inc("tm_gradsync_buckets_total", max(1, n_buckets))


def record_zero(kind: str, n_groups: int, n_shards: int) -> None:
    """One ZeRO reduce-scatter leg set (every call)."""
    _registry.counter_inc("tm_zero_sync_rounds_total", kind=kind,
                          n_shards=str(n_shards))
    _registry.counter_inc("tm_zero_groups_total", n_groups, kind=kind)


def record_dcn(op: str, codec: str, wire_bytes: int,
               payload_bytes: int) -> None:
    """One inter-node (DCN) leg of a two-level collective (every call):
    ``wire_bytes`` is what one
    device actually puts on the DCN links (quantized payload + scale),
    ``payload_bytes`` the uncompressed shard it represents — the ratio
    is the codec's measured win."""
    _registry.counter_inc("tm_dcn_legs_total", op=op, codec=codec)
    _registry.counter_inc("tm_dcn_wire_bytes_total", wire_bytes,
                          op=op, codec=codec)
    _registry.counter_inc("tm_dcn_payload_bytes_total", payload_bytes,
                          op=op, codec=codec)


def record_selector_fallback(op: str, backend: str) -> None:
    """One selector topology/availability degradation (a requested
    backend silently replaced by "xla" — e.g. "hierarchical" on an
    ``n_dcn <= 1`` mesh), so misconfigured topologies show up in dumps
    instead of only as a missing perf win."""
    _registry.counter_inc("tm_selector_fallback_total", op=op,
                          backend=backend)


def record_tuning_plan(event: str, op: str = "") -> None:
    """Plan consult outcome: ``hit`` | ``miss`` | ``measured``."""
    _registry.counter_inc("tm_tuning_plan_lookups_total", event=event,
                          op=op)


def record_tuning_measure(op: str, backend: str, median_s: float) -> None:
    """One measured candidate (``tuning.measure`` result), median in
    microseconds on a log2 histogram."""
    _registry.hist_observe("tm_tuning_measured_us",
                           max(1.0, median_s * 1e6), op=op, backend=backend)


def record_ps_wait(n_futures: int) -> None:
    """The completion edge of one parameter-server wait (every shard
    future resolved) — ring only, the shard-level counters ride
    :func:`record_ps_stats`.  A gang wedged inside a PS wait shows the
    preceding dispatch as its last event; one that cleared it shows
    this."""
    _recorder.append("ps_wait_done", "ps", int(n_futures))


def record_ps_stats(stats: dict, prev: Optional[dict]) -> None:
    """Fold a ``ShardedParameterServer.stats()`` snapshot into the
    registry as deltas against the previous snapshot (the native
    counters are cumulative; the registry re-exports them as
    monotonic ``tm_ps_*`` counters)."""
    prev = prev or {}
    for k, v in stats.items():
        d = v - prev.get(k, 0)
        if d > 0:
            _registry.counter_inc(f"tm_ps_{k}_total", d)


def record_step_build(label: str) -> None:
    """One step-builder entry (a step function built; JAX counts its
    compilation-cache entries)."""
    _registry.counter_inc("tm_step_builds_total", label=label)


def record_step(site: str, step: int = -1) -> None:
    """One step boundary (ring only — one append per step, no counter):
    ``data_parallel_step(_rank_major)`` marks each dispatch, the serving
    scheduler each tick.  Consecutive ``step`` events delimit the
    attribution windows ``tool attribute`` budgets; the step index rides
    the nbytes slot so blame's cross-host alignment keys on it."""
    _recorder.append("step", site, max(0, int(step)))


def record_log(logger_name: str) -> None:
    """One ``utils.metrics.MetricsLogger`` record (the logger is a thin
    wrapper over this registry when obs is active)."""
    _registry.counter_inc("tm_log_records_total", logger=logger_name)


def record_barrier(name: str) -> None:
    """A runtime barrier (barrier events anchor cross-host alignment in
    ``tool blame``)."""
    _registry.counter_inc("tm_barriers_total")
    _recorder.append("barrier", name)


def record_barrier_done(name: str) -> None:
    """The barrier's completion edge (ring only) — without it blame
    cannot tell a host stuck INSIDE the barrier from one that cleared
    it and hung before its next dispatch."""
    _recorder.append("barrier_done", name)


def record_fault(action: str, site: str, *, kind: str = "",
                 peer: str = "") -> None:
    """One fault-layer event (``torchmpi_tpu_torch/faults``, through
    ``utils/telemetry.py``): ``action`` is ``injected`` |
    ``retry`` | ``survived`` | ``exhausted`` | ``deadline`` | ``health``
    (counter ``tm_fault_<action>_total``).  Injected and
    deadline/health events also land in the flight ring, so
    ``obs_tool.py blame`` can name the injected site right next to the
    collective it wounded (docs/FAULTS.md)."""
    labels = {"site": site}
    if kind:
        labels["kind"] = kind
    if peer:
        labels["peer"] = peer
    _registry.counter_inc(f"tm_fault_{action}_total", **labels)
    if action in ("injected", "deadline", "health"):
        _recorder.append("fault", site, 0, kind, action)


def record_guard(action: str, site: str, *, peer: str = "",
                 digest: str = "", nbytes: int = 0) -> None:
    """One wire-guard event (the JAX package's docs/GUARD.md; a later
    A10 slice of the port): ``action`` is
    ``verified`` | ``verify_failed`` | ``healed`` | ``numeric_tripped``
    | ``skipped_step`` | ``rewind`` | ``quarantined`` (counter
    ``tm_guard_<action>_total{site,peer}``).  Wire verifies land in the
    flight ring with the payload digest in the backend slot, so
    ``obs_tool blame`` — which compares ``(ev, op, nbytes, backend)``
    per seq across hosts — names the first rank whose digest diverged
    from the gang's; failures/heals/rewinds always ride the ring as
    post-mortem anchors."""
    labels = {"site": site}
    if peer:
        labels["peer"] = peer
    _registry.counter_inc(f"tm_guard_{action}_total", **labels)
    if action in ("verified", "verify_failed", "healed",
                  "numeric_tripped", "rewind", "quarantined"):
        _recorder.append("guard", site, int(nbytes), digest[:12], action)


def record_guard_latency(site: str, seconds: float) -> None:
    """One wire-integrity digest verification: per-site latency in
    MICROSECONDS (``tm_guard_verify_us{site}``; the
    ``tm_tuning_measured_us`` convention so log2 buckets resolve
    sub-millisecond hashes) — the measured cost model docs/GUARD.md
    quotes per payload size."""
    _registry.hist_observe("tm_guard_verify_us",
                           max(1.0, float(seconds) * 1e6), site=site)


def record_async(event: str, op: str, *, wait_s: Optional[float] = None,
                 nbytes: int = 0) -> None:
    """One :class:`~torchmpi_tpu_torch.collectives.AsyncHandle` lifecycle
    event: ``event`` is ``create`` | ``wait``.  ``wait_s`` lands on the
    ``tm_async_wait_seconds`` histogram — ONE observation per blocking
    call (``wait_all`` records its batch elapsed once under
    ``op="wait_all"``, never once per handle), so sum/count give the
    exact mean time blocked per call.  All events land in the flight
    ring, so a gang wedged inside a handle wait shows the handle as
    its last event."""
    _registry.counter_inc("tm_async_handles_total", event=event, op=op)
    if wait_s is not None:
        _registry.hist_observe("tm_async_wait_seconds", wait_s, op=op)
    _recorder.append("async", op, int(nbytes), "", event)


def record_overlap(stage: str, bucket: int, total: int) -> None:
    """One overlapped-gradsync schedule event, fired from the gradient
    hooks inside the backward pass (``gradsync.make_overlapped_grad_fn``):
    ``stage`` is ``grads`` (bucket ``bucket``'s cotangents just
    materialized) or ``launch`` (its allreduce is being handed to the
    scheduler).  The flight-ring interleaving of these events is the
    CPU-sim-checkable overlap invariant — bucket *i*'s ``launch``
    recorded before bucket *i+1*'s ``grads`` — that
    the gradsync tests assert."""
    _registry.counter_inc("tm_overlap_events_total", stage=stage)
    _recorder.append("overlap", stage, int(bucket), "",
                     f"bucket {bucket}/{total}")


def record_serving(event: str, n: int = 1, *, replica: str = "") -> None:
    """One serving-layer counter event (docs/SERVING.md): ``event`` is
    ``requests`` (admitted) | ``completed`` | ``tokens`` (emitted) |
    ``rerouted`` (sessions moved off a dead replica) | ``rejected``
    (unservable request refused at admission) | ``readmitted`` (a
    healed replica returned to the dispatch rotation) |
    ``prefill_compiles`` (a prompt length the engine had not prefilled
    before — one new prefill shape; O(buckets) with bucketed prefill,
    O(distinct lengths) without) | ``spec_drafted`` /
    ``spec_accepted`` (speculative-decode draft tokens proposed /
    accepted — the live acceptance rate) | ``prefix_hits`` /
    ``prefix_misses`` / ``prefix_tokens_saved`` /
    ``prefix_bytes_saved`` / ``prefix_inserted`` / ``prefix_evicted``
    (radix prefix-cache admissions: blocks reused, prefill tokens and
    cache bytes not recomputed, tree churn) | ``admitted`` / ``shed``
    (the SLO admission gate's verdict per arrival) | ``scale_up`` /
    ``scale_down`` (FleetController replica-count changes) — counter
    ``tm_serving_<event>_total`` labeled by replica.  Re-routes also
    land in the flight ring, so a post-mortem sees the replica death
    next to the collectives (or faults) that preceded it."""
    _registry.counter_inc(f"tm_serving_{event}_total", n, replica=replica)
    if event == "rerouted":
        _recorder.append("serving", event, int(n), "", replica)


def record_serving_latency(kind: str, seconds: float, *,
                           replica: str = "") -> None:
    """One per-request SLO observation: ``kind`` is ``ttft``
    (time-to-first-token) or ``itl`` (inter-token latency) — histogram
    ``tm_serving_<kind>_us`` in MICROSECONDS, so the log2 buckets
    resolve sub-second latencies (the ``tm_tuning_measured_us``
    convention); ``obs_tool slo`` renders p50/p95/p99 per replica."""
    _registry.hist_observe(f"tm_serving_{kind}_us",
                           max(1.0, float(seconds) * 1e6),
                           replica=replica)


def record_serving_depth(depth: int) -> None:
    """Admission-queue depth, sampled once per scheduler tick (a gauge
    exposed as a histogram: count = ticks, sum/count = mean depth)."""
    _registry.hist_observe("tm_serving_queue_depth", max(0, int(depth)))


def record_serving_occupancy(pct: float, *, replica: str = "") -> None:
    """Slot-block occupancy percent per replica, sampled per tick."""
    _registry.hist_observe("tm_serving_slot_occupancy_pct",
                           max(0.0, float(pct)), replica=replica)


def record_restart(event: str, step: int) -> None:
    """One checkpoint-restart driver event (``utils/restart.py``):
    ``recovered`` (settled on a checkpoint step), ``fresh_start`` (no
    common restorable step), or ``peer_timeout`` (a detected-dead peer
    routed through the restore path)."""
    _registry.counter_inc("tm_restart_events_total", event=event)
    _recorder.append("restart", event, int(step))


def record_ckpt(event: str, *, step: int = 0, reason: str = "") -> None:
    """One durable-checkpoint event (``utils/checkpoint.py`` +
    ``utils/durable.py`` — docs/CHECKPOINT.md): ``event`` is ``saved``
    (a digest-stamped pair + its buddy mirrors committed) |
    ``verified`` (a restore's digest check passed) | ``verify_failed``
    (a copy failed it — ``reason`` names primary vs ``buddy_r<k>``) |
    ``repaired`` (the primary was rewritten bit-identically from the
    buddy named by ``reason``) | ``pruned`` (retention removed a
    step) | ``walkback`` (recovery rejected a step — ``reason`` is
    corrupt | missing | template_mismatch) — counter
    ``tm_ckpt_<event>_total``.  Every event rides the flight ring with
    the STEP in the nbytes slot, so ``obs_tool`` post-mortems can
    attribute which step recovery settled on and why the steps above
    it were rejected, aligned against the collectives around them."""
    labels = {"reason": reason} if reason else {}
    _registry.counter_inc(f"tm_ckpt_{event}_total", **labels)
    _recorder.append("ckpt", event, int(step), reason, event)


def record_elastic(event: str, *, epoch: int = 0, members: int = 0,
                   peer: str = "") -> None:
    """One elastic gang-resize event (``torchmpi_tpu/elastic.py`` —
    docs/ELASTIC.md): ``event`` is ``reconcile`` (a membership view
    committed) | ``shrink`` (the gang re-formed without a dead member)
    | ``rejoin`` (a healed member re-admitted at a step boundary) |
    ``quorum_lost`` (a reconcile/agreement refused on a minority side
    of a partition) | ``parked`` (the rank entered the quorum park
    loop) | ``fenced`` (a stale-epoch write was refused by the epoch
    fence) | ``healed`` (a parked rank rejoined a committed epoch) —
    counter ``tm_elastic_<event>_total``, labeled with the implicated
    member(s) when there are any.  Every event also lands in the
    flight ring, so a post-mortem sees the resize right next to the
    last collectives of the old gang."""
    labels = {}
    if peer:
        labels["peer"] = peer
    _registry.counter_inc(f"tm_elastic_{event}_total", **labels)
    _recorder.append("elastic", event, int(members), "",
                     f"epoch {int(epoch)}")


def record_hotstate(event: str, *, step: int = 0, peer: str = "",
                    reason: str = "") -> None:
    """One hot-state replication-tier event (``torchmpi_tpu/hotstate``
    — docs/HOTSTATE.md): ``event`` is ``streamed`` (a rank shipped its
    post-step delta/snapshot to its buddy's RAM — ``reason`` is
    ``snap`` | ``delta``) | ``received`` (the buddy landed it) |
    ``dropped`` (an injected ``hotstate.send``/``hotstate.recv`` fault
    ate the message — the chain self-heals at the next snapshot) |
    ``restored`` (the RAM rung reconstructed a digest-verified state) |
    ``verify_failed`` (a candidate replica failed its blake2b check —
    ``reason`` is ``digest`` or the parse error class) |
    ``fallback_disk`` (the ladder stepped down to the disk buddies) |
    ``evicted`` (the memory budget trimmed an old generation) |
    ``peer_lost`` (a streaming peer left the gang; its replicas stay) |
    ``migrated`` (a live drain landed a rank on a spare) — counter
    ``tm_hotstate_<event>_total``.  Every event rides the flight ring
    with the STEP in the nbytes slot, so a post-mortem sees which rung
    recovery actually took right next to the collectives around it."""
    labels = {}
    if peer:
        labels["peer"] = peer
    if reason:
        labels["reason"] = reason
    _registry.counter_inc(f"tm_hotstate_{event}_total", **labels)
    _recorder.append("hotstate", event, int(step), peer, reason or event)
