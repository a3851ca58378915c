"""Guard: end-to-end payload integrity and numeric anomaly detection with
an agreed rewind to a checkpoint (the JAX package's ``guard.py``;
docs/GUARD_TORCH.md).

Every other recovery layer handles failures that announce themselves (a
raised ``CorruptPayload``, a dead heartbeat, a ``PeerTimeoutError``).
The failure left is silent: a bit flipped in a host-staged buffer or a
PS payload, or a step whose numbers diverge, poisons every rank through
the gradient sync with no typed error to retry.  ``Config.guard`` arms
three layers against it:

- **wire**: blake2b digests over every host-staged payload and PS
  exchange, taken at the sender and verified at the receiver
  (``faults/integrity.py``); a mismatch is a transient
  ``IntegrityError`` the fault policy retries by staging again from the
  device buffers.
- **numeric**: a finite and norm-bound tripwire on the synced gradients
  (:func:`check_tree` on ``synchronize_gradients``' output,
  :func:`check_flat` on each overlap bucket and ZeRO shard leg): one
  float32 sum of squares per checked row (finite iff the sum is; the
  bound compares with the same scalar), policy ``skip_step`` (the rows
  zeroed by ``torch.where`` and counted) or ``raise``.
- **full**: both, plus :func:`run_guarded`: a rolling median / MAD
  loss-spike detector in the step loop; on a trip the ranks agree over
  the membership board and restore the last verified checkpoint in
  place (no view, communicator or plan change, no config-epoch bump).

**The deferred verdict.**  JAX compiles the sum of squares into the step
and counts a trip in a ``jax.debug.callback``.  The port runs eagerly,
and reading a verdict on the host is a host sync.  So the verdicts stay
on the device: under ``skip_step`` each check adds its trip (0 or 1) to
a per-site counter on the device and the step makes **no host sync**;
:func:`stats` reads (drains) the counters when it is called.  Under
``raise`` the check queues its verdict and :func:`raise_pending` reads
it at the step boundary: one sync there, then the typed
:class:`NumericAnomalyError`.  A rank-major stack [n, ...] is checked a
row at a time (the JAX package checks each device's own copy), and a
check with any row tripped counts once.

Off by default and never imported when off: each site reads
``Config.guard`` as one string compare.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import runtime
from .utils import checkpoint, restart, telemetry

PyTree = Any

MODES = ("off", "wire", "numeric", "full")

# Agreement sentinel for "this rank did not trip": above any real step,
# so the min over the gang is a trip step iff anyone tripped.
_NO_TRIP = 1 << 62
_FAULTS = __name__.rsplit(".", 1)[0] + ".faults"


class NumericAnomalyError(RuntimeError):
    """The numeric tripwire (policy ``raise``) or the rewind budget
    tripped: a synced-gradient check was non-finite or out of bound, or
    loss spikes kept recurring past ``max_rewinds``."""

    def __init__(self, site: str, *, bucket: int = 0,
                 stat: float = float("nan"), msg: str = ""):
        self.site = site
        self.bucket = int(bucket)
        self.stat = float(stat)
        super().__init__(
            msg or f"numeric anomaly at {site} (bucket {bucket}): "
                   f"sum-of-squares {stat!r} failed the finite/bound "
                   f"check")


# ---------------------------------------------------------------------------
# Module stats and the deferred verdicts
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_stats = {"numeric_trips": 0, "skipped_steps": 0, "rewinds": 0}
_pending: List[NumericAnomalyError] = []
# skip_step: site -> {device: int64 trip count on that device}.
_skip_acc: Dict[str, Dict[torch.device, torch.Tensor]] = {}
# raise: (site, bucket, tripped bool scalar, stat scalar), unread.
_raise_q: List[Tuple[str, int, torch.Tensor, torch.Tensor]] = []


def _read(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)  # counters a side stream wrote
    return t.item()


def _drain_raise() -> None:
    with _lock:
        q = list(_raise_q)
        _raise_q.clear()
    for site, bucket, tripped, stat in q:
        if not bool(_read(tripped)):
            continue
        _bump("numeric_trips")
        _record("numeric_tripped", site)
        with _lock:
            _pending.append(NumericAnomalyError(site, bucket=bucket,
                                                stat=float(_read(stat))))


def _drain_skip() -> None:
    with _lock:
        acc = {site: dict(d) for site, d in _skip_acc.items()}
    for site, per_dev in acc.items():
        for t in per_dev.values():
            k = int(_read(t))
            if not k:
                continue
            t.sub_(k)
            for _ in range(k):
                _bump("numeric_trips")
                _record("numeric_tripped", site)
                _bump("skipped_steps")
                _record("skipped_step", site)


def stats() -> Dict[str, int]:
    """``numeric_trips`` / ``skipped_steps`` / ``rewinds``.  Reads the
    deferred verdicts first (a host sync where they are on the card)."""
    _drain_raise()
    _drain_skip()
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        for k in _stats:
            _stats[k] = 0
        _pending.clear()
        _raise_q.clear()
        _skip_acc.clear()


def pending() -> int:
    """Deferred anomalies of the ``raise`` policy (see
    :func:`raise_pending`); reads the queued verdicts."""
    _drain_raise()
    with _lock:
        return len(_pending)


def raise_pending() -> None:
    """Raise (and clear) the oldest deferred :class:`NumericAnomalyError`.

    The ``raise`` policy does not raise inside the step: the tripped rows
    are zeroed there (the poisoned update never applies, as under
    ``skip_step``) and the verdict is read here, at the step boundary,
    which waits for it (one host sync).  ``data_parallel_step`` and
    :func:`run_guarded` call this after every step while the numeric
    guard is armed; hand-written step loops call it themselves.  Nothing
    queued: no sync, no-op.  ``skip_step`` verdicts are not read here."""
    if not _raise_q and not _pending:
        return
    _drain_raise()
    with _lock:
        if not _pending:
            return
        e = _pending[0]
        _pending.clear()
    raise e


def _bump(key: str) -> None:
    with _lock:
        _stats[key] += 1


def _record(action: str, site: str, *, peer: str = "") -> None:
    """``tm_guard_*`` through obs when it is active."""
    telemetry.emit("record_guard", action, site, peer=peer)


# ---------------------------------------------------------------------------
# The numeric tripwire
# ---------------------------------------------------------------------------


def _sum_squares(t: torch.Tensor, rows: bool) -> torch.Tensor:
    """float32 sum of squares of ``t``: a scalar, or one per row of a
    rank-major stack."""
    x = t.float()
    if rows:
        return torch.square(x).reshape(x.shape[0], -1).sum(1)
    return torch.square(x).sum()


def _verdict(ss: torch.Tensor, norm_bound: float) -> torch.Tensor:
    """Finite iff the sum is finite (any NaN / Inf element poisons it);
    with a bound, ``ss <= f32(bound ** 2)`` rides the same scalar."""
    ok = torch.isfinite(ss)
    if norm_bound > 0:
        # A Python scalar is cast to ss's float32, as JAX's
        # jnp.float32(bound ** 2), with no host-to-device copy.
        ok = ok & (ss <= float(norm_bound) ** 2)
    return ok


def _note(site: str, bucket: int, policy: str, ok: torch.Tensor,
          ss: torch.Tensor) -> None:
    """Queue one check's verdict without reading it."""
    bad = ~ok.reshape(-1)
    tripped = bad.any()
    if policy == "skip_step":
        with _lock:
            per_dev = _skip_acc.setdefault(site, {})
            acc = per_dev.get(ok.device)
            if acc is None:
                acc = per_dev[ok.device] = torch.zeros(
                    (), dtype=torch.int64, device=ok.device)
        acc.add_(tripped.to(torch.int64))
        return
    first = bad.to(torch.int8).argmax()
    with _lock:
        _raise_q.append((site, int(bucket), tripped,
                         ss.reshape(-1)[first]))


def _select(ok: torch.Tensor, v: torch.Tensor, fb, rows: bool):
    """``v`` where the verdict holds, else ``fb`` (a tensor or 0), by
    ``torch.where``: never a multiply, since NaN * 0 is NaN."""
    if rows:
        ok = ok.reshape(-1, *([1] * (v.dim() - 1)))
    if not isinstance(fb, torch.Tensor):
        fb = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.where(ok, v, fb)


def _knobs(policy, norm_bound):
    cfg = runtime.effective_config()
    return (cfg.guard_numeric_policy if policy is None else policy,
            cfg.guard_norm_bound if norm_bound is None else norm_bound)


def check_flat(flat: torch.Tensor, *, site: str, bucket: int = 0,
               policy: Optional[str] = None,
               norm_bound: Optional[float] = None,
               aux: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
               rows: bool = False):
    """Numeric tripwire over one flat synced bucket (JAX :178; the
    overlap buckets and the ZeRO shard legs).  Returns the bucket with
    the tripped part zeroed under both policies; ``rows=True`` checks a
    rank-major [n, ...] stack a row at a time (each rank's copy or
    shard, as each JAX device checks its own).  ``aux``: ``(value,
    fallback)`` pairs selected under the same verdict, value when clean,
    fallback when tripped (the error-feedback residuals revert to the
    pre-step state); with it, returns ``(flat, aux_values)``.  No host
    sync (the verdict is read later, see the module docstring)."""
    policy, norm_bound = _knobs(policy, norm_bound)
    ss = _sum_squares(flat, rows)
    ok = _verdict(ss, norm_bound)
    _note(site, bucket, policy, ok, ss)
    out = _select(ok, flat, 0, rows)
    if aux is None:
        return out
    return out, [_select(ok, v, fb, rows) for v, fb in aux]


def check_tree(leaves: Sequence[torch.Tensor], *, site: str,
               policy: Optional[str] = None,
               norm_bound: Optional[float] = None,
               aux: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
               rows: bool = False):
    """Numeric tripwire over a synced gradient list (JAX :213; the
    ``synchronize_gradients`` output), **in place**: the leaves' sums of
    squares fold into one verdict (per row with ``rows``), and a trip
    zeroes every leaf together (a half-zeroed update is a worse poison
    than the anomaly).  Returns ``leaves``; with ``aux`` (as in
    :func:`check_flat`) ``(leaves, aux_values)``."""
    leaves = list(leaves)
    if not leaves:
        return leaves if aux is None else (leaves, [v for v, _ in aux])
    policy, norm_bound = _knobs(policy, norm_bound)
    ss = None
    for leaf in leaves:
        s = _sum_squares(leaf, rows)
        ss = s if ss is None else ss + s
    ok = _verdict(ss, norm_bound)
    _note(site, 0, policy, ok, ss)
    with torch.no_grad():
        for leaf in leaves:
            leaf.copy_(_select(ok, leaf, 0, rows))
    if aux is None:
        return leaves
    return leaves, [_select(ok, v, fb, rows) for v, fb in aux]


# ---------------------------------------------------------------------------
# Loss-spike detection and the agreed rewind
# ---------------------------------------------------------------------------


class LossSpikeDetector:
    """Rolling median / MAD spike detector over the step loop's loss (JAX
    :249).

    ``update(loss)`` returns True when the loss is non-finite, or, once
    ``min_history`` values are in, when it exceeds the rolling median by
    ``threshold`` median absolute deviations.  The MAD has a floor of 1%
    of ``max(1, |median|)``, so a flat history does not make noise trip;
    a tripped value is not appended.  Defaults:
    ``Config.guard_spike_window`` / ``guard_spike_threshold``."""

    def __init__(self, window: Optional[int] = None,
                 threshold: Optional[float] = None,
                 min_history: int = 5):
        cfg = runtime.effective_config()
        self.window = int(window if window is not None
                          else cfg.guard_spike_window)
        self.threshold = float(threshold if threshold is not None
                               else cfg.guard_spike_threshold)
        self.min_history = int(min_history)
        if self.window < 2 or self.threshold <= 0 or self.min_history < 2:
            raise ValueError(
                f"need window >= 2, threshold > 0, min_history >= 2; got "
                f"{self.window}/{self.threshold}/{self.min_history}")
        self._hist: deque = deque(maxlen=self.window)
        self.last_stat = 0.0  # deviation (in MADs) of the last update

    @staticmethod
    def _median(vals: List[float]) -> float:
        s = sorted(vals)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def update(self, loss) -> bool:
        v = float(loss)
        if not math.isfinite(v):
            self.last_stat = float("inf")
            return True
        if len(self._hist) >= self.min_history:
            med = self._median(list(self._hist))
            mad = self._median([abs(x - med) for x in self._hist])
            scale = max(mad, 0.01 * max(1.0, abs(med)))
            self.last_stat = (v - med) / scale
            if self.last_stat > self.threshold:
                return True
        self._hist.append(v)
        return False

    def reset(self) -> None:
        self._hist.clear()
        self.last_stat = 0.0


def _require_on():
    """The consent gate of the driver entry points."""
    cfg = runtime.effective_config()
    if cfg.guard == "off":
        raise RuntimeError(
            "torchmpi_tpu_torch.guard requires Config.guard != 'off' (or "
            "TORCHMPI_TPU_GUARD=wire|numeric|full): the guard layer is "
            "opt-in; see docs/GUARD_TORCH.md")
    return cfg


def quarantine(peer: str, *, site: str = "rewind") -> bool:
    """Pin ``peer`` dead in the armed fault layer's ``HealthLedger`` (the
    optional attribution half of a rewind).  True iff a ledger was
    written; with faults unarmed a no-op that reports False and emits
    nothing."""
    mod = sys.modules.get(_FAULTS)
    if mod is None or not mod.active():
        return False
    led = mod.ledger()
    for _ in range(led.dead_after):
        led.record(peer, ok=False)
    _record("quarantined", site, peer=peer)
    return True


def agree_rewind(board, tag: str, local_ranks: Sequence[int],
                 members: Sequence[int], trip_step: Optional[int], *,
                 deadline_s: float, poll_s: float) -> Optional[int]:
    """Bounded two-phase rewind verdict over the membership board (JAX
    :336): every rank proposes the step it tripped at (or the no-trip
    sentinel) and the bounded min resolves to the earliest trip; then
    every rank commits the resolved verdict, so no rank rewinds while
    another proceeds.  Returns the agreed trip step, or None."""
    from .faults import membership

    value = _NO_TRIP if trip_step is None else int(trip_step)
    prop = membership.agree_min(board, tag + "p", local_ranks, members,
                                value, deadline_s=deadline_s,
                                poll_s=poll_s)
    membership.agree_min(board, tag + "c", local_ranks, members,
                         int(prop), deadline_s=deadline_s, poll_s=poll_s)
    return None if prop >= _NO_TRIP else int(prop)


def run_guarded(init_fn: Callable[[], PyTree],
                step_fn: Callable[[PyTree, int], Tuple[PyTree, Any]],
                *, steps: int, directory: str, save_every: int = 10,
                detector: Optional[LossSpikeDetector] = None,
                max_rewinds: int = 3,
                board_dir: Optional[str] = None,
                members: Optional[Sequence[int]] = None,
                participants: Optional[int] = None,
                agree: Optional[Callable[[int], int]] = None,
                implicate: Optional[str] = None,
                ) -> Tuple[PyTree, Dict[str, Any]]:
    """Run ``steps`` calls of ``step_fn(state, i) -> (state, loss)`` under
    the anomaly-rewind guard (JAX :361).

    Each step's loss feeds the :class:`LossSpikeDetector`; on a trip the
    gang reaches a bounded two-phase verdict over the membership board
    (:func:`agree_rewind`; a ``rewind_<round>.json`` record lands beside
    the reconcile history) and restores the last verified checkpoint
    through ``restart.recover`` **in place**: communicators and plans are
    untouched and the config epoch does not move.  ``implicate``
    quarantines a peer at each rewind.  Every process of a multi-process
    world calls this together; in a world of one the board agrees
    trivially.  A trip that recurs past ``max_rewinds`` raises
    :class:`NumericAnomalyError`.  Returns ``(state, info)``, ``info``
    with ``rewinds`` / ``trip_steps`` / ``steps_run`` /
    ``recovered_step``."""
    cfg = _require_on()
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    from .faults import membership

    det = detector if detector is not None else LossSpikeDetector()
    board = membership.Board(board_dir
                             or os.path.join(directory, "membership"))
    multi = runtime.is_initialized() and runtime.size() > 1
    local: Tuple[int, ...] = (runtime.process_index(),) if multi else (0,)
    if members is None:
        members = tuple(range(runtime.size())) if multi else (0,)
    members = tuple(sorted(int(m) for m in members))
    if participants is None:
        participants = len(members) if multi else 1
    deadline_s = float(cfg.elastic_deadline_s)
    poll_s = float(cfg.elastic_poll_s)

    # A previous life's protocol state must not poison this one: drop our
    # own agreement values and any stale rewind request, and number the
    # rounds past the recorded rewinds.
    for r in local:
        board.clear_values(r)
        board.clear_rewind_request(r)
    rounds = max([int(d.get("round", 0))
                  for d in board.rewind_records()] or [0])

    template = init_fn()
    state, i = restart.recover(init_fn, directory, template,
                               participants=participants, agree=agree)
    recovered_step = i
    rewinds = 0
    steps_run = 0
    trip_steps: List[int] = []

    def commit_rewind(agreed: int):
        nonlocal rewinds, recovered_step, state, i
        rewinds += 1
        trip_steps.append(agreed)
        _bump("rewinds")
        _record("rewind", "loss_spike")
        quarantined = bool(implicate) and quarantine(implicate)
        board.post_rewind_record(rounds, {
            "step": int(agreed), "stat": float(det.last_stat),
            "peer": implicate or "",
            "quarantined": quarantined,
            "members": list(members)})
        if rewinds > max_rewinds:
            raise NumericAnomalyError(
                "loss_spike", stat=det.last_stat,
                msg=f"loss spike at step {agreed} kept recurring "
                    f"past the rewind budget ({max_rewinds})")
        state = None  # the poisoned state goes before the restore
        state, i = restart.recover(
            init_fn, directory, template,
            participants=participants, agree=agree)
        recovered_step = i
        # Fresh eyes after the restore: the rolled-back steps' losses
        # would otherwise sit in the window while the replay appends them
        # again, collapsing the MAD.
        det.reset()

    while True:
        while i < steps:
            telemetry.emit("record_step", "run_guarded", i)
            state, loss = step_fn(state, i)
            steps_run += 1
            raise_pending()  # the tripwire's raise-policy boundary
            tripped = det.update(loss)
            if multi and tripped:
                board.request_rewind(local[0], step=i,
                                     stat=det.last_stat)
            pend = tripped or (multi and bool(board.rewind_requests()))
            if pend:
                rounds += 1
                agreed = agree_rewind(
                    board, f"rw{rounds}", local, members,
                    i if tripped else None,
                    deadline_s=deadline_s, poll_s=poll_s)
                for r in local:
                    board.clear_rewind_request(r)
                if agreed is not None:
                    commit_rewind(agreed)
                    continue
            i += 1
            if i % save_every == 0 or i == steps:
                checkpoint.save(directory, state, step=i)
        if not multi:
            break
        # Closing agreement: a peer that tripped at its final step waits
        # in a round this rank's per-step poll may have missed; every rank
        # joins one more round at exit.
        rounds += 1
        agreed = agree_rewind(board, f"rw{rounds}", local, members, None,
                              deadline_s=deadline_s, poll_s=poll_s)
        for r in local:
            board.clear_rewind_request(r)
        if agreed is None:
            break
        commit_rewind(agreed)
    return state, {"rewinds": rewinds, "trip_steps": trip_steps,
                   "steps_run": steps_run,
                   "recovered_step": recovered_step}
