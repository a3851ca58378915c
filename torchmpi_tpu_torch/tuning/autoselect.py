"""Online ``backend="auto"`` selection against the persistent plan DB.

The PyTorch counterpart of ``torchmpi_tpu/tuning/autoselect.py`` (:38-343).
Lifecycle of one (op, size bucket, grid, platform) key:

1. ``init`` with ``backend="auto"`` loads the plan file (missing / corrupt
   / version-mismatched files silently yield an empty plan).
2. The FIRST eager call of an uncached key (a rank-major verb, a bucket of
   a fused sync, a process-world verb in a world of one) measures every
   registered, topology-eligible candidate backend with the noise-gated
   median discipline of :mod:`torchmpi_tpu_torch.tuning.measure`, caches
   the winner, and best-effort persists the plan to disk.
3. Every later call, in this process or any future one, hits the plan
   with zero re-measurement (:func:`measurement_count`); the planner
   (``planner.py``) binds the decision once and replays it.
4. Where no runner is at hand the selector consults the plan read-only
   through its plan provider (:func:`plan_lookup`) and degrades to the
   stock route on a miss.  With more than one process, online
   measurement is off and plans are read-only (JAX :235-245): per-process
   timings would pick different routes on different ranks.

Every decision is recorded: an in-memory log (:func:`decisions`) and an
optional JSONL ``MetricsLogger`` (:func:`set_decision_logger` /
``TORCHMPI_TPU_TUNING_LOG``).  A candidate that raises while measured is
skipped and named under the record's ``errors``.  With ``Config.obs``
on, every consult counts ``tm_tuning_plan_lookups_total{event}`` (a
read-only hit or miss, an eager hit, a measurement) and every measured
candidate lands its median on ``tm_tuning_measured_us`` (JAX :54-62,
:182, :247, :283).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from . import fingerprint, measure, plancache
from ..utils import metrics

# The gate's protected default: the stock route every platform has.
DEFAULT_BACKEND = "xla"


class _State:
    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.cache: Optional[plancache.PlanCache] = None
        self.measure_count = 0
        self.measuring = False
        self.rounds = measure.ROUNDS
        self.decisions: List[dict] = []
        self.logger: Optional[metrics.MetricsLogger] = None
        self.logged_keys: set = set()


_state = _State()


def _obs():
    """The telemetry module when ``Config.obs`` is on, else None: one
    branch per call site and never an import on the off path."""
    from .. import runtime

    if runtime.effective_config().obs == "off":
        return None
    from .. import obs

    return obs


def _log(record: dict) -> None:
    _state.decisions.append(record)
    del _state.decisions[:-1000]  # bounded in-memory history
    if _state.logger is not None:
        _state.logger.log(**record)


def decisions() -> List[dict]:
    """The decision log so far (most recent last, bounded)."""
    return list(_state.decisions)


def set_decision_logger(logger: Optional[metrics.MetricsLogger]) -> None:
    _state.logger = logger


def measurement_count() -> int:
    """How many plan keys this process measured online."""
    return _state.measure_count


def reset_measurement_count() -> None:
    _state.measure_count = 0


def is_active() -> bool:
    return _state.cache is not None


def plan() -> Optional[plancache.PlanCache]:
    return _state.cache


def configure(plan_path: Optional[str] = None,
              log_path: Optional[str] = None,
              auto_active: bool = True,
              rounds: int = measure.ROUNDS) -> plancache.PlanCache:
    """Activate online tuning: load the plan file (silently degrading to
    an empty plan) and register the selector's plan provider.  Called by
    ``runtime.init`` / ``set_config`` when the config opts in.
    ``rounds`` (``Config.tuning_rounds``) fenced rounds time each
    candidate of a later measurement (JAX :101, :128).
    ``auto_active=False`` records that a plan was loaded while no backend
    resolves to ``"auto"``, so the decision log says why a seeded plan
    never applies."""
    from .. import selector

    with _state.lock:
        _state.rounds = max(1, int(rounds))
        path = plancache.resolve_plan_path(plan_path)
        if (_state.cache is not None and _state.cache.path == path
                and _state.cache.degraded_reason is None):
            # Same DB, already live: keep the in-memory entries (they may
            # hold measurements that could not be persisted) and pick up
            # entries that appeared on disk meanwhile.
            disk = plancache.PlanCache.load(path)
            if disk.degraded_reason is None:
                _state.cache.merge_from(disk)
        else:
            _state.cache = plancache.PlanCache.load(path)
        _state.logged_keys = set()
        log_path = log_path or os.environ.get("TORCHMPI_TPU_TUNING_LOG")
        # Rebind (or drop) the JSONL logger every configure: a logger of an
        # earlier init must not receive this run's records.
        _state.logger = (metrics.MetricsLogger(log_path) if log_path
                         else None)
        if _state.cache.degraded_reason:
            _log({"event": "tuning_plan_degraded", "path": path,
                  "reason": _state.cache.degraded_reason})
        if not auto_active:
            _log({"event": "tuning_plan_inactive", "path": path,
                  "entries": len(_state.cache),
                  "reason": "plan loaded but no backend resolves to "
                            "'auto'; set backend='auto' for the plan to "
                            "drive selection"})
        selector.set_plan_provider(plan_lookup)
        return _state.cache


def reset() -> None:
    """Deactivate (``runtime.stop``): drop the in-memory plan and
    unregister the provider.  The counters survive."""
    from .. import selector

    with _state.lock:
        _state.cache = None
        selector.clear_plan_provider()


def _note_plan_hit(op: str, key: str, entry: plancache.PlanEntry) -> None:
    if key not in _state.logged_keys:
        _state.logged_keys.add(key)
        _log({"event": "tuning_decision", "op": op, "key": key,
              "backend": entry.backend, "source": "plan",
              "entry_source": entry.source})


def plan_lookup(op: str, nbytes: int, dtype, grid,
                axes=None) -> Optional[str]:
    """Read-only plan consult (the selector's plan provider): the planned
    backend for this key, or None on a miss or with tuning inactive.
    ``grid`` is the :class:`~fingerprint.Grid` the call spans, ``axes``
    the axis subset (None: the whole grid).  Never raises, never
    measures."""
    cache = _state.cache  # snapshot: a concurrent stop() may null it
    if (cache is None or cache.degraded_reason is not None
            or dtype is None or grid is None):
        return None
    try:
        key = fingerprint.fingerprint(op, int(nbytes or 0), dtype, grid,
                                      axes=axes)
    except (TypeError, ValueError):  # an unkeyable dtype: no plan
        return None
    entry = cache.get(key)
    o = _obs()
    if o is not None:
        o.record_tuning_plan("hit" if entry is not None else "miss", op)
    if entry is None:
        return None
    _note_plan_hit(op, key, entry)
    return entry.backend


def _multiprocess() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _eligible_candidates(op: str, n_dcn: int) -> List[str]:
    from .. import selector

    cands = []
    for b in sorted(selector.available(op)):
        if b == "hierarchical" and n_dcn <= 1:
            continue  # two-level staging needs a real outer axis
        cands.append(b)
    if DEFAULT_BACKEND not in cands:
        cands.insert(0, DEFAULT_BACKEND)
    return cands


def _spanned_dcn(grid, axes) -> int:
    """The dcn size a call spans: the grid's when it spans both axes."""
    if axes is not None and not {"dcn", "ici"} <= set(axes):
        return 1
    return grid.shape.get("dcn", 1)


def resolve_eager(op: str, nbytes: int, dtype, grid,
                  runner: Callable[[str], object], *,
                  impl_op: Optional[str] = None,
                  axes=None) -> Optional[str]:
    """Resolve ``"auto"`` for one eager collective call.

    ``runner(backend)`` runs the collective on the call's own input under
    that explicit backend, out of place; ``impl_op`` is the selector op
    whose registered backends are the candidates (default ``op``).
    Returns the backend to use, or None to degrade to static selection.
    The measured outputs are dropped: the caller runs the winner."""
    st = _state
    cache = st.cache  # snapshot: a concurrent stop() may null it
    if cache is None or cache.degraded_reason is not None:
        # Degraded plan: static selection, no measuring, the evidence on
        # disk left as it is.
        return None
    key = fingerprint.fingerprint(op, nbytes, dtype, grid, axes=axes)
    entry = cache.get(key)
    if entry is None and _multiprocess():
        if key not in st.logged_keys:
            st.logged_keys.add(key)
            _log({"event": "tuning_decision", "op": op, "key": key,
                  "backend": DEFAULT_BACKEND, "source": "fallback",
                  "reason": "multiprocess: online measurement disabled"})
        return None
    if entry is not None:
        o = _obs()
        if o is not None:
            o.record_tuning_plan("hit", op)
        _note_plan_hit(op, key, entry)
        return entry.backend
    with st.lock:
        if st.measuring:
            return None  # re-entrant call during a measurement: static
        entry = cache.get(key)  # measured while we waited on the lock
        if entry is not None:
            return entry.backend
        st.measuring = True
    try:
        cands: Dict[str, metrics.TimedResult] = {}
        errors: Dict[str, str] = {}
        for b in _eligible_candidates(impl_op or op,
                                      _spanned_dcn(grid, axes)):
            try:
                cands[b] = measure.measure(lambda b=b: runner(b),
                                           rounds=st.rounds)
            except Exception as e:  # noqa: BLE001 - a broken candidate
                errors[b] = f"{type(e).__name__}: {e}"[:160]
        if not cands:
            _log({"event": "tuning_decision", "op": op, "key": key,
                  "backend": DEFAULT_BACKEND, "source": "fallback",
                  "errors": errors})
            return None
        winner, evidence = measure.noise_gate(cands, DEFAULT_BACKEND)
        st.measure_count += 1
        o = _obs()
        if o is not None:
            o.record_tuning_plan("measured", op)
            for b, r in cands.items():
                o.record_tuning_measure(op, b, r.median)
        new = plancache.PlanEntry(
            backend=str(winner), source="measured",
            median_ms={b: round(r.median * 1e3, 4)
                       for b, r in cands.items()},
            jitter_ms={b: round(r.jitter * 1e3, 4)
                       for b, r in cands.items()},
            rounds=st.rounds)
        cache.put(key, new)
        cache.save()  # best-effort: an unwritable path stays in memory
        st.logged_keys.add(key)
        _log({"event": "tuning_decision", "op": op, "key": key,
              "backend": new.backend, "source": "measured",
              "evidence": evidence, **({"errors": errors} if errors
                                       else {})})
        return new.backend
    finally:
        st.measuring = False


def plan_bucket_bytes(op: str, grid, fallback_bytes: int) -> int:
    """Bucket byte bound for the gradsync overlap schedule, aligned to the
    plan database's log2 size buckets: with measured ``op`` entries for
    this platform and grid, the byte size of the LARGEST measured bucket
    not above ``fallback_bytes`` (so every fired bucket keys to a plan
    entry somebody measured); else ``fallback_bytes`` rounded down to a
    bucket edge."""
    fallback_bytes = max(1, int(fallback_bytes))
    edge = fingerprint.bucket_bytes(fingerprint.size_bucket(fallback_bytes))
    cache = _state.cache
    if cache is None:
        return edge
    prefix = (f"{fingerprint.platform_of(grid)}|"
              f"{fingerprint.mesh_key(grid)}|{op}|")
    best = None
    for key in cache.entries:
        if not key.startswith(prefix):
            continue
        _, _, tail = key.rpartition("|b")
        try:
            b = int(tail)
        except ValueError:
            continue
        nbytes = fingerprint.bucket_bytes(b)
        if nbytes <= edge and (best is None or nbytes > best):
            best = nbytes
    return best if best is not None else edge
