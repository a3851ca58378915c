"""Collective watchdog: live hang detection, lease-based liveness and
typed hang-breaking (the JAX package's ``watchdog.py``;
docs/FAULTS_TORCH.md).

Every recovery layer handles failures that *announce themselves*; the
failure none of them sees is a dispatch that never completes.  This
module is the NCCL-watchdog equivalent for the port, in three layers:

- **progress monitor**: a per-process daemon thread over an in-flight
  table.  The port's blocking surfaces (the host-staged exchange,
  ``runtime.barrier``, ``AsyncHandle.wait``, the PS wait leg) bracket
  their wait in :func:`begin` / :func:`end`; an entry older than
  ``Config.watchdog_deadline_s`` is flagged **stalled**
  (``tm_watchdog_{armed,stalled,broken,escalated,cleared}_total`` and a
  ``watchdog`` flight event through ``utils/telemetry.py``).
- **leases**: the monitor renews ``wd_lease_<rank>.json`` (the process
  rank) in ``Config.watchdog_dir`` with the live in-flight snapshot;
  ``python -m torchmpi_tpu_torch.obs.tool blame --live <dir>`` reads
  them while the job runs.  An EXPIRED lease is death evidence
  (:func:`dead_ranks`).
- **hang-breaking** (``mode="break"``): a stalled entry gets a break
  request at 1.5x the deadline; cooperative waiters (``AsyncHandle.wait``
  polling its event or future, the injected ``stall`` hold) observe it
  through :func:`check_break` and raise a typed
  :class:`CollectiveHangError` in place; a non-cooperative stall gets the
  error queued for the next eager boundary (:func:`raise_pending`).  At
  2.5x an untaken break escalates: the evidence is dumped, the lease
  tombstoned and the process exits (``os._exit``,
  :data:`ESCALATE_EXIT_CODE`; ``_exit_fn`` is the seam tests patch).

Off by default and never imported when off: ``Config.watchdog`` is read
as one string compare at plan build or site entry.  Dependency-free on
purpose (no torch): the monitor must run while the runtime is what
wedged.  The elastic seams: :func:`set_lease_dir` (the gang adopts its
membership board as the lease home), :func:`set_state` (a quorum-parked
rank publishes ``"parked"``; ``hotstate.migrate`` publishes
``"migrating"`` for the length of a drain) and :func:`dead_ranks`, read by
the gang's poll.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

from .utils import telemetry

MODES = ("off", "warn", "break")

# Exit status of the escalation path (a stall the break could not
# unwind): distinctive on purpose, so a scheduler/log reader can tell a
# watchdog escalation from an OOM kill or a crash.
ESCALATE_EXIT_CODE = 113

# Test seam: monkeypatch to observe escalation without dying.
_exit_fn = os._exit


class CollectiveHangError(RuntimeError):
    """A collective the watchdog had to break: it made no progress
    within ``watchdog_deadline_s``.  Timeout-flavored for the fault
    policy (``is_timeout``) but NOT transient — retrying the very wait
    that wedged would re-wedge; the correct response is the recovery
    path (the restart loop's ``on_peer_timeout``, ``utils/restart.py``;
    the elastic gang's shrink, ``elastic.py``).  Carries the site/op/seq/elapsed
    attribution and the obs flight-ring tail when telemetry is active.
    """

    transient = False
    is_timeout = True

    def __init__(self, site: str, *, op: str = "", peer: str = "",
                 seq: int = -1, elapsed_s: float = 0.0,
                 deadline_s: float = 0.0,
                 flight_tail: Optional[List[dict]] = None):
        self.site = site
        self.op = op
        self.peer = peer
        self.seq = int(seq)
        self.elapsed_s = float(elapsed_s)
        self.deadline_s = float(deadline_s)
        self.flight_tail = flight_tail or []
        tail = ""
        if self.flight_tail:
            last = self.flight_tail[-1]
            tail = (f"; last flight event #{last.get('seq')} "
                    f"{last.get('ev')}:{last.get('op')}")
        op_s = f" op={op}" if op else ""
        peer_s = f" peer={peer}" if peer else ""
        super().__init__(
            f"watchdog broke a stalled collective at {site}{op_s}"
            f"{peer_s} (wd-seq {self.seq}): no completion within "
            f"{deadline_s:.3g}s deadline (elapsed {elapsed_s:.3g}s)"
            f"{tail}")


class _InFlight:
    """One armed dispatch window (begin .. end)."""

    __slots__ = ("token", "site", "op", "peer", "nbytes", "seq", "t0",
                 "thread", "stalled", "break_requested",
                 "suppress_clear", "escalated")

    def __init__(self, token: int, site: str, op: str, peer: str,
                 nbytes: int, seq: int, t0: float):
        self.token = token
        self.site = site
        self.op = op
        self.peer = peer
        self.nbytes = int(nbytes)
        self.seq = int(seq)
        self.t0 = float(t0)
        self.thread = threading.get_ident()
        self.stalled = False
        self.break_requested = False
        # Set when a sibling window on the SAME thread delivered its
        # break: this window is about to unwind through that exception,
        # so its end() must not read as "the stall resolved on its own"
        # (the deadline-tuning `cleared` signal would lie).
        self.suppress_clear = False
        # One escalation per window: os._exit never returns in
        # production, but the test seam does — re-escalating the same
        # entry every tick would spam the exit hook.
        self.escalated = False


# ---------------------------------------------------------------------------
# Module state
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_mode = "off"
_deadline_s = 30.0
_poll_s = 0.05
_lease_dir: Optional[str] = None
_rank = 0
_inflight: Dict[int, _InFlight] = {}
_pending: Dict[int, CollectiveHangError] = {}
_next_token = 0
_seq = 0  # monotonic watchdog op sequence (the flight-event seq field)
_stats = {"begun": 0, "stalled": 0, "broken": 0, "escalated": 0}
_thread: Optional[threading.Thread] = None
_stop = threading.Event()
# Monitor generation: bumped by deactivate().  A monitor thread that
# outlived its join deadline (e.g. blocked in a lease fsync on a hung
# filesystem) exits on its next wakeup instead of racing a re-activated
# successor — two concurrent monitors would double-count, double-queue
# breaks, and could both reach the escalation exit.
_gen = 0
_last_lease = 0.0
# Coarse driver state published in the lease ("running" | "parked"): the
# elastic park loop sets "parked" (and the epoch it waits on), so
# ``obs.tool blame --live`` tells a quorum-parked minority (fresh lease,
# idle on purpose) from a stalled or dead rank.
_state = "running"
_state_detail = ""


def mode() -> str:
    return _mode


def active() -> bool:
    return _mode != "off"


def deadline_s() -> float:
    return _deadline_s


def lease_dir() -> Optional[str]:
    """Where this process's liveness leases land (None = disabled)."""
    return _lease_dir


def set_lease_dir(directory: str) -> None:
    """Point the armed watchdog's leases at ``directory`` (JAX :202): the
    elastic gang adopts its membership board as the lease home when
    ``watchdog_dir`` was left unset (the board is known only when the gang
    is built).  Renews at once, so readers see the lease as soon as the
    gang exists."""
    global _lease_dir
    with _lock:
        _lease_dir = directory
    os.makedirs(directory, exist_ok=True)
    _write_lease(force=True)


def set_state(state: str, detail: str = "") -> None:
    """Publish a coarse driver state in the lease (JAX :216):
    ``"running"`` by default, ``"parked"`` (with the epoch it waits on)
    while a quorum-lost minority waits out a partition, ``"migrating"``
    (``rank S -> rank P``) while ``hotstate.migrate`` drains a rank onto a
    spare.  Renews at once; a no-op when the watchdog is off."""
    global _state, _state_detail
    if _mode == "off":
        return
    with _lock:
        _state = str(state)
        _state_detail = str(detail)
    _write_lease(force=True)


def state() -> str:
    return _state


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def pending_count() -> int:
    return len(_pending)


def inflight_count() -> int:
    return len(_inflight)


# ---------------------------------------------------------------------------
# Activation (runtime.init / set_config call this when Config.watchdog
# is on; same idempotent re-activation contract as obs/faults)
# ---------------------------------------------------------------------------


def activate(wd_mode: str, *, deadline_s: float, poll_s: float = 0.05,
             lease_dir: Optional[str] = None,
             rank: int = 0) -> None:
    """Arm the watchdog (idempotent; re-activation updates settings).

    ``lease_dir`` is where the liveness leases land
    (``Config.watchdog_dir``); ``None`` disables leases, the in-process
    monitor still runs."""
    global _mode, _deadline_s, _poll_s, _lease_dir, _rank, _thread, \
        _state, _state_detail
    if wd_mode not in ("warn", "break"):
        raise ValueError(
            f"watchdog mode must be warn|break, got {wd_mode!r}")
    if float(deadline_s) <= 0 or float(poll_s) <= 0:
        raise ValueError(
            f"watchdog deadline_s/poll_s must be > 0, got "
            f"{deadline_s}/{poll_s}")
    with _lock:
        _mode = wd_mode
        _deadline_s = float(deadline_s)
        _poll_s = float(poll_s)
        _rank = int(rank)
        _state, _state_detail = "running", ""
        # Unconditional on purpose: re-activation with lease_dir=None
        # must DISABLE leases (not silently keep writing liveness into
        # a previous activation's — possibly another run's — board).
        _lease_dir = lease_dir or None
        if _lease_dir:
            os.makedirs(_lease_dir, exist_ok=True)
        if wd_mode != "break":
            # Softening to warn (which "never intervenes") must disarm
            # any break already requested under the previous break-mode
            # activation — a queued CollectiveHangError delivered into
            # a warn-mode step would be exactly the intervention warn
            # promises not to make.
            _pending.clear()
            for e in _inflight.values():
                e.break_requested = False
        start = _thread is None or not _thread.is_alive()
        if start:
            _stop.clear()
            _thread = threading.Thread(target=_loop, args=(_gen,),
                                       daemon=True, name="tm-watchdog")
    if start:
        _thread.start()
    _write_lease(force=True)


def deactivate() -> None:
    """Disarm: the monitor thread exits at its next tick; in-flight
    windows are released (their ``end()`` calls become no-ops) and
    pending breaks are dropped — a disarmed watchdog must never raise
    into a later step.  The rank's lease is RETRACTED (removed) from
    the board: a lease that merely stopped renewing would expire, and
    peers reading expiry as death evidence (``dead_ranks`` /
    ``ElasticGang.poll``) would shrink a live, healthy rank out of the
    gang just for turning its watchdog off."""
    global _mode, _thread, _lease_dir, _gen, _state, _state_detail
    with _lock:
        _mode = "off"
        _state, _state_detail = "running", ""
        _gen += 1  # any straggling monitor thread exits at its next tick
        th, _thread = _thread, None
        _inflight.clear()
        _pending.clear()
        ld, _lease_dir = _lease_dir, None
        rank = _rank
    _stop.set()
    if th is not None and th.is_alive():
        th.join(timeout=1.0)
    if ld is not None:
        try:
            os.remove(lease_path(ld, rank))
        except OSError:
            pass  # never leased / already gone — same outcome


def reset() -> None:
    """Disarm AND forget stats (tests)."""
    deactivate()
    with _lock:
        for k in _stats:
            _stats[k] = 0


# ---------------------------------------------------------------------------
# The in-flight window (the site instrumentation surface)
# ---------------------------------------------------------------------------


def begin(site: str, op: str = "", peer: str = "",
          nbytes: int = 0) -> int:
    """Open one armed dispatch window; returns a token for
    :func:`end`/:func:`check_break`.  Call sites gate on
    ``Config.watchdog != "off"`` before importing this module, so the
    off path never reaches here; a disarmed watchdog returns -1 (every
    later call on the token is a no-op)."""
    global _next_token, _seq
    if _mode == "off":
        return -1
    with _lock:
        token = _next_token
        _next_token += 1
        seq = _seq
        _seq += 1
        _inflight[token] = _InFlight(token, site, op, peer, nbytes, seq,
                                     time.monotonic())
        _stats["begun"] += 1
    telemetry.emit("record_watchdog", "armed", site, op=op)
    return token


def end(token: int) -> None:
    """Close a window.  A window that was flagged stalled emits a
    ``cleared`` event (the stall resolved on its own — a genuinely-slow
    collective, the deadline-tuning signal docs/FAULTS_TORCH.md describes);
    any queued deferred break for the token is dropped with it."""
    if token < 0:
        return
    with _lock:
        e = _inflight.pop(token, None)
        undelivered = _pending.pop(token, None)
    # "cleared" = the stall resolved on its own: flagged but never
    # broken (warn mode), or broken but the queued error was never
    # delivered (the wait completed before any break point saw it).  A
    # delivered break (pending consumed by check_break/raise_pending)
    # is NOT a clear — it ended by raising — and neither is a window a
    # same-thread sibling's break is unwinding through
    # (``suppress_clear``): the deadline-tuning signal must never fire
    # for a stall the watchdog itself resolved.
    if e is not None and e.stalled and not e.suppress_clear \
            and (undelivered is not None or not e.break_requested):
        telemetry.emit("record_watchdog", "cleared", e.site, op=e.op,
                       seq=e.seq,
                       elapsed_s=time.monotonic() - e.t0)


def should_break(token: int) -> bool:
    """Non-raising poll for cooperative waiters."""
    if token < 0:
        return False
    e = _inflight.get(token)
    return e is not None and e.break_requested


def is_inflight(token: int) -> bool:
    """Is this window still registered?  False for a stale token from
    before a deactivate/re-activate cycle — long-lived cooperative
    holds (the injected ``stall``) use this to re-register with the
    new watchdog instead of polling a window it no longer watches."""
    return token >= 0 and token in _inflight


def check_break(token: int) -> None:
    """Cooperative break point: raises the window's typed
    :class:`CollectiveHangError` iff the monitor requested a break
    (mode="break" only — a softened/disarmed watchdog never
    intervenes).  The in-place raise consumes the deferred copy, so a
    broken wait never double-raises at a later boundary; sibling
    windows on the SAME thread have their queued breaks consumed too —
    the exception is about to unwind through them, and a second copy
    delivered at a later boundary (or a spurious ``cleared`` at their
    ``end()``) would misreport one stall as several."""
    if token < 0 or _mode != "break":
        return
    with _lock:
        err = _pending.pop(token, None)
        e = _inflight.get(token)
        if err is None and e is not None and e.break_requested:
            err = _make_error(e)
        if err is not None and e is not None:
            for sib in _inflight.values():
                if sib.thread == e.thread and sib.token != token:
                    sib.suppress_clear = True
                    _pending.pop(sib.token, None)
    if err is not None:
        raise err


def raise_pending() -> None:
    """The deferred-raise boundary (the guard.raise_pending pattern):
    raise the oldest queued break whose window is STILL in flight — a
    stall a background thread is wedged in (the async staged worker, a
    PS helper) surfaces on the main thread at its next eager dispatch,
    where the step loop's recovery machinery can catch it.  No-op when
    nothing is pending (one len check on the armed path; call sites
    gate the off path)."""
    if not _pending or _mode != "break":
        return
    with _lock:
        err = None
        for tok in sorted(_pending):
            if tok in _inflight:
                err = _pending.pop(tok)
                break
    if err is not None:
        raise err


def _make_error(e: _InFlight) -> CollectiveHangError:
    return CollectiveHangError(
        e.site, op=e.op, peer=e.peer, seq=e.seq,
        elapsed_s=time.monotonic() - e.t0, deadline_s=_deadline_s,
        flight_tail=telemetry.flight_tail())


# ---------------------------------------------------------------------------
# The monitor thread
# ---------------------------------------------------------------------------


def _loop(gen: int) -> None:
    while not _stop.wait(_poll_s):
        if _mode == "off" or gen != _gen:
            return  # disarmed, or a successor monitor took over
        try:
            _scan()
        except Exception:  # noqa: BLE001 — the monitor must outlive
            pass           # anything; a crashed watchdog is no watchdog


def _scan() -> None:
    # The escalation ladder (docs/FAULTS_TORCH.md): STALLED at 1x the
    # deadline (flag + lease + warn — the live-blame window), BROKEN at
    # 1.5x (break mode: the typed error is armed for cooperative
    # waiters and queued for the next eager boundary), ESCALATED at
    # 2.5x (the break went untaken for a whole further deadline — the
    # wait is non-cooperative, a compiled region or a native call that
    # cannot be unwound in-process).
    now = time.monotonic()
    flagged: List[_InFlight] = []
    broke: List[_InFlight] = []
    escalate: Optional[_InFlight] = None
    with _lock:
        for e in list(_inflight.values()):
            elapsed = now - e.t0
            if not e.stalled and elapsed >= _deadline_s:
                e.stalled = True
                _stats["stalled"] += 1
                flagged.append(e)
            elif (e.stalled and _mode == "break"
                    and not e.break_requested
                    and elapsed >= 1.5 * _deadline_s):
                e.break_requested = True
                _pending[e.token] = _make_error(e)
                _stats["broken"] += 1
                broke.append(e)
            elif (e.stalled and e.break_requested and _mode == "break"
                    and not e.escalated
                    and elapsed >= 2.5 * _deadline_s
                    and escalate is None):
                e.escalated = True
                _stats["escalated"] += 1
                escalate = e
    changed = bool(flagged or broke or escalate)
    for e in flagged:
        telemetry.emit("record_watchdog", "stalled", e.site, op=e.op,
                       seq=e.seq, elapsed_s=now - e.t0, peer=e.peer)
        if _mode == "warn":
            warnings.warn(
                f"torchmpi_tpu_torch.watchdog: collective stalled at "
                f"{e.site} (op={e.op or '?'}, wd-seq {e.seq}) for "
                f"{now - e.t0:.3g}s (deadline {_deadline_s:.3g}s) — "
                f"mode='warn' will not break it",
                RuntimeWarning, stacklevel=2)
    for e in broke:
        telemetry.emit("record_watchdog", "broken", e.site, op=e.op,
                       seq=e.seq, elapsed_s=now - e.t0, peer=e.peer)
    if escalate is not None:
        _escalate(escalate, now)
        return  # unreachable in production (_exit); reachable in tests
    _write_lease(force=changed)


def _escalate(e: _InFlight, now: float) -> None:
    """The documented last resort: dump the evidence, tombstone the
    lease, and exit cleanly, so the death is evidence a peer (and the
    elastic gang's poll, through :func:`dead_ranks`) can act on."""
    telemetry.emit("record_watchdog", "escalated", e.site, op=e.op,
                   seq=e.seq, elapsed_s=now - e.t0, peer=e.peer)
    _write_lease(force=True, escalated=True)
    # os._exit skips atexit — flush the telemetry dump explicitly so
    # the post-mortem evidence this exit creates actually lands.
    import sys

    obs = sys.modules.get(__name__.rsplit(".", 1)[0] + ".obs")
    try:
        if obs is not None and obs.active():
            obs.dump(best_effort=True)
    except Exception:  # noqa: BLE001 — dying is the job; dump is bonus
        pass
    if _mode != "break":
        # Disarmed while this escalation was dumping evidence (a
        # deactivate racing the monitor): the operator withdrew the
        # consent the exit rides on — stand down.
        return
    _exit_fn(ESCALATE_EXIT_CODE)


# ---------------------------------------------------------------------------
# Leases (layer 2): heartbeat + live in-flight snapshot on the board
# filesystem.  Plain atomic JSON on purpose — readable by obs.tool
# (standalone, no torch) and by a peer whose runtime is what wedged.
# ---------------------------------------------------------------------------


def _renew_interval() -> float:
    # Liveness granularity tracks the detection deadline, not the poll
    # tick: a 30s deadline must not hammer a network filesystem with
    # 50ms fsync-ed writes.  State changes force an immediate renewal.
    return max(_poll_s, _deadline_s / 4.0, 0.05)


def lease_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"wd_lease_{int(rank)}.json")


def _write_lease(force: bool = False, escalated: bool = False) -> None:
    global _last_lease
    d = _lease_dir
    if d is None or _mode == "off":
        return
    now = time.monotonic()
    if not force and now - _last_lease < _renew_interval():
        return
    _last_lease = now
    with _lock:
        snap = [{"site": e.site, "op": e.op, "peer": e.peer,
                 "seq": e.seq, "elapsed_s": round(now - e.t0, 4),
                 "stalled": e.stalled,
                 "break_requested": e.break_requested}
                for e in _inflight.values()]
        stats = dict(_stats)
    ttl = max(4.0 * _renew_interval(), 1.0)
    payload = {"rank": _rank, "pid": os.getpid(), "mode": _mode,
               "deadline_s": _deadline_s, "ttl_s": ttl,
               "ts": time.time(), "inflight": snap,
               "state": _state, "state_detail": _state_detail,
               "stalled_total": stats["stalled"],
               "broken_total": stats["broken"],
               "escalated": bool(escalated or stats["escalated"])}
    path = lease_path(d, _rank)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        pass  # a lost lease renewal is a liveness gap, not a crash


def read_leases(directory: str) -> Dict[int, dict]:
    """Every parseable ``wd_lease_*.json`` under ``directory``, keyed
    by rank (torn/unreadable files ignored — an unreadable lease is the
    same as an unrenewed one)."""
    out: Dict[int, dict] = {}
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("wd_lease_")
                       and n.endswith(".json"))
    except OSError:
        return out
    for name in names:
        try:
            with open(os.path.join(directory, name)) as f:
                d = json.load(f)
            out[int(d["rank"])] = d
        except (OSError, ValueError, KeyError):
            continue
    return out


def lease_expired(lease: dict, now: Optional[float] = None) -> bool:
    """Has this lease's renewal promise lapsed?  ``now`` is wall time
    (``time.time()``); leases carry their own ``ttl_s`` so readers
    need no knowledge of the writer's cadence."""
    if now is None:
        now = time.time()
    return now > float(lease.get("ts", 0)) + float(lease.get("ttl_s", 0))


def dead_ranks(directory: str, now: Optional[float] = None,
               newer_than: Optional[float] = None) -> List[int]:
    """Ranks whose lease is EXPIRED or tombstoned ``escalated`` — the
    death evidence ``elastic.ElasticGang.poll`` folds into its
    membership verdict.  A rank that never leased is not evidence
    (absence proves nothing), and with ``newer_than`` (a wall-clock
    floor — a driver passes its own construction time)
    neither is a lease last renewed BEFORE it: a SIGKILLed previous
    run's leftover leases on a persistent board must not read as this
    run's deaths while a slow-starting peer is still starting — it
    becomes evidence only once it has leased fresh in this life."""
    out = []
    for rank, lease in read_leases(directory).items():
        if newer_than is not None and \
                float(lease.get("ts", 0)) < newer_than:
            continue  # a previous life's remains, not this run's state
        if lease.get("escalated") or lease_expired(lease, now):
            out.append(rank)
    return sorted(out)
