"""Admission queue + iteration-level scheduler, the continuous-batching
serving loop (the JAX package's ``serving/scheduler.py``: ``Request`` :54,
``Server`` :121, ``run_trace`` :256).

One :class:`Server` drives N :class:`~.engine.ReplicaEngine` replicas
through a :class:`~.router.Router` over a shared FIFO admission queue.
Every tick, newly arrived requests are admitted into free slot blocks
(prefill and first token: the TTFT event) and one decode step advances
each replica's in-flight slots; finished sequences retire at once and
their blocks free for the next admission.  The clock is virtual: each
tick advances by its measured wall time, by a fixed ``tick_seconds``, or
by its work units times ``unit_seconds``, and a request is admitted once
the clock passes its ``arrival_s``.  A drained replica's sessions (the
autoscaler's scale-down) re-enter the queue front and re-prefill from
their emitted prefix elsewhere, token-exact.

Not ported: the chaos sites ``serving.replica`` and ``serving.admit``
(``_fire`` / ``_gate``'s fault half), the fault-error resilience path and
the ``tm_serving_*`` telemetry, all ROADMAP queue A, item 10.  Without
them a failing replica step raises.  ``last_stats`` carries the
inter-token gaps (``itl_s``) that JAX records into its histogram.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from .. import runtime
from .engine import ReplicaEngine, RequestRejected, Session
from .fleet import AdmissionController, AdmissionRejected, \
    FleetController
from .router import Router


@dataclasses.dataclass
class Request:
    """One serving request.  ``max_new`` bounds the generated tokens;
    ``eos_id`` retires the sequence early.  The server fills in the
    result fields (``tokens``, the emitted ids, eos included when hit,
    and the timestamps, seconds on the virtual clock)."""

    rid: str
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    arrival_s: float = 0.0
    # -- decode diversity (None -> the Config default) --
    # Token i draws from (seed, i) whatever the slot, neighbours, replica
    # or re-routes.  temperature <= 0 is greedy.
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    # -- results (server-owned) --
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    finish_s: Optional[float] = None
    replica: Optional[str] = None
    reroutes: int = 0
    # Set instead of tokens when the request is unservable: the server
    # rejects it and keeps serving everyone else.
    error: Optional[str] = None
    # True when the admission gate shed this request (SLO backpressure);
    # ``error`` carries the AdmissionRejected text.
    shed: bool = False
    # Clock of the most recent emitted token.
    last_token_s: Optional[float] = None

    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s


class Server:
    """Continuous-batching server over ``replicas`` engine replicas of
    one ``model`` (a local or flash ``TransformerLM`` holding its
    weights).

    Replica count / slots / slot block size default from the active
    Config (``serving_replicas`` / ``serving_slots`` /
    ``serving_slot_tokens``).  ``devices`` optionally pins replica i to
    ``devices[i]`` (a copy of the model on each other card)."""

    # Class-level defaults so a hand-assembled Server (``Server.__new__``
    # around a pre-wired Router) runs with the gate and the autoscaler
    # disarmed.
    _admission = None
    _fleet = None

    def __init__(self, model, *, replicas: Optional[int] = None,
                 slots: Optional[int] = None,
                 slot_tokens: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 ledger=None, sample: Optional[float] = None,
                 prefill_bucket: Optional[int] = None,
                 spec_k: Optional[int] = None, draft=None,
                 engines: Optional[Sequence] = None,
                 prefix_cache: Optional[int] = None,
                 prefix_block: int = 8,
                 slo_ttft_us: Optional[float] = None,
                 autoscale: Optional[int] = None,
                 engine_factory=None,
                 scale_high_water: int = 4, scale_low_water: int = 0,
                 scale_sustain: int = 3):
        cfg = runtime.effective_config()
        knobs = dict(slots=slots, slot_tokens=slot_tokens, sample=sample,
                     prefill_bucket=prefill_bucket, spec_k=spec_k,
                     draft=draft, prefix_cache=prefix_cache,
                     prefix_block=prefix_block)
        if engines is None:
            n = int(replicas if replicas is not None
                    else cfg.serving_replicas)
            if n < 1:
                raise ValueError(f"need >= 1 replica, got {n}")
            if devices is not None and len(devices) < n:
                raise ValueError(
                    f"{n} replicas but only {len(devices)} devices")
            engines = [
                ReplicaEngine(model, name=f"replica{i}",
                              device=devices[i] if devices is not None
                              else None, **knobs)
                for i in range(n)]
            if engine_factory is None:
                # Default scale-up factory: a fresh replica with the same
                # knobs on the model's device.
                def engine_factory(name, _m=model):
                    return ReplicaEngine(_m, name=name, **knobs)
        else:
            engines = list(engines)
        self.router = Router(engines, ledger=ledger)
        slo = float(slo_ttft_us if slo_ttft_us is not None
                    else cfg.serving_slo_ttft_us)
        self._admission = (AdmissionController(slo) if slo > 0
                           else None)
        amax = int(autoscale if autoscale is not None
                   else cfg.serving_autoscale)
        if amax > 0:
            if engine_factory is None:
                raise ValueError(
                    "autoscale needs an engine_factory when the server "
                    "is built from pre-made engines (it must be able "
                    "to construct a replica on scale-up)")
            self._fleet = FleetController(
                self.router, engine_factory=engine_factory,
                max_replicas=amax, min_replicas=len(engines),
                high_water=scale_high_water, low_water=scale_low_water,
                sustain=scale_sustain, drain=self._drain)
        #: Filled by :meth:`run_trace`: ``ticks``, ``busy_s`` (summed
        #: tick durations), ``clock_s`` (final virtual clock), ``tokens``
        #: (total emitted) and ``itl_s`` (every inter-token gap).
        self.last_stats: dict = {}

    @classmethod
    def sharded(cls, *args, **kwargs) -> "Server":
        """TP-sharded replicas (a mesh slice each) are ROADMAP queue A,
        item 9 (b)."""
        raise NotImplementedError(
            "Server.sharded: tensor-parallel serving replicas are ROADMAP "
            "queue A, item 9 (b)")

    def _total_units(self) -> float:
        """Summed work units across all replicas, dead included."""
        return sum(e.units for e in self.router.replicas)

    # -- the serving loop --------------------------------------------------

    def run_trace(self, requests: Sequence[Request], *,
                  tick_seconds: Optional[float] = None,
                  unit_seconds: Optional[float] = None,
                  max_ticks: int = 1_000_000) -> List[Request]:
        """Serve a whole arrival trace to completion; returns the requests
        in completion order.

        The virtual clock advances, per tick, by the tick's measured wall
        time (both None; the tick ends when its tokens are on the host, so
        this is the card's time too), by ``tick_seconds``, or by the
        tick's work units (the engines' own ledgers: prefills and pooled
        forwards 1 each, draft forwards at their weight) times
        ``unit_seconds``."""
        if tick_seconds is not None and unit_seconds is not None:
            raise ValueError(
                "tick_seconds and unit_seconds are exclusive clock "
                "modes")
        arrivals = deque(sorted(requests, key=lambda r: r.arrival_s))
        pending: deque = deque()
        completed: List[Request] = []
        clock = busy = 0.0
        n_ticks = n_tokens = 0
        self._itl: List[float] = []
        units_prev = self._total_units()
        for _tick in range(max_ticks):
            if not (arrivals or pending
                    or any(e.active for e in self.router.live())):
                self.last_stats = {"ticks": n_ticks, "busy_s": busy,
                                   "clock_s": clock, "tokens": n_tokens,
                                   "itl_s": self._itl}
                return completed
            t0 = time.monotonic()
            while arrivals and arrivals[0].arrival_s <= clock:
                req = arrivals.popleft()
                shed = self._gate(req, len(pending))
                if shed is not None:
                    req.error = shed
                    req.shed = True
                    req.finish_s = clock
                    completed.append(req)
                    continue
                pending.append(req)
            newly_admitted, stepped, finished, rejected = \
                self._tick(pending)
            for req in rejected:
                req.finish_s = clock
                completed.append(req)
            worked = bool(newly_admitted or stepped or finished
                          or rejected)
            if not worked and not pending and arrivals and \
                    not any(e.active for e in self.router.live()):
                # Idle gap: jump to the next arrival.
                clock = max(clock, arrivals[0].arrival_s)
                continue
            if not worked and pending and not self.router.live():
                raise RuntimeError(
                    "all replicas dead with requests still queued")
            if unit_seconds is not None:
                units_now = self._total_units()
                n_units = units_now - units_prev
                units_prev = units_now
                elapsed = max(1.0, n_units) * unit_seconds
            elif tick_seconds is not None:
                elapsed = tick_seconds
            else:
                elapsed = max(time.monotonic() - t0, 1e-9)
            clock += elapsed
            busy += elapsed
            n_ticks += 1
            n_tokens += len(newly_admitted) + \
                sum(s.last_emit for s in stepped)
            self._record_tick(newly_admitted, stepped, finished,
                              completed, clock, elapsed)
            if self._fleet is not None:
                self._fleet.tick(len(pending), pending)
        raise RuntimeError(f"trace did not drain in {max_ticks} ticks")

    # -- one tick ----------------------------------------------------------

    def _tick(self, pending: deque):
        admitted: List[Session] = []
        finished: List[Session] = []
        stepped: List[Session] = []
        rejected: List[Request] = []
        # Admission at the token boundary: fill free slot blocks from the
        # queue front, spread by router health and load.
        while pending:
            eng = self.router.pick()
            if eng is None:
                break
            req = pending.popleft()
            try:
                res = eng.admit(req)
            except RequestRejected as e:
                # Unservable: reject it and keep serving everyone else.
                req.error = str(e)
                rejected.append(req)
                continue
            if res is None:  # raced a full pool; retry next tick
                pending.appendleft(req)
                break
            sess, done = res
            req.replica = eng.name
            admitted.append(sess)
            if done:
                finished.append(sess)
        # One decode step per replica with in-flight slots.
        for eng in list(self.router.live()):
            if not eng.active:
                continue
            advanced, fin = eng.step()
            self.router.record(eng, True)
            stepped.extend(advanced)
            finished.extend(fin)
        return admitted, stepped, finished, rejected

    def _gate(self, req: Request, depth: int) -> Optional[str]:
        """The admission gate, once per arrival before it queues: the SLO
        admission controller.  Returns the shed reason, or None."""
        if self._admission is not None:
            try:
                self._admission.check(req.rid, depth)
            except AdmissionRejected as e:
                return str(e)
        return None

    def _drain(self, eng: ReplicaEngine, pending: deque) -> None:
        """Move a drained replica's in-flight sessions to the queue front
        (they already waited once) for re-prefill elsewhere."""
        sessions = eng.drain()
        eng.dead = True
        for sess in reversed(sessions):
            req = sess.request
            req.tokens.extend(sess.emitted)
            req.reroutes += 1
            pending.appendleft(req)

    # -- result bookkeeping ------------------------------------------------

    def _record_tick(self, admitted, stepped, finished, completed,
                     clock: float, elapsed: float) -> None:
        for sess in admitted:
            req = sess.request
            if req.ttft_s is None:
                req.ttft_s = clock - req.arrival_s
                if self._admission is not None:
                    self._admission.observe(req.ttft_s)
            else:
                # Re-admission after a re-route: the whole stall since the
                # last token is one inter-token gap.
                since = (req.last_token_s if req.last_token_s is not None
                         else clock - elapsed)
                self._itl.append(clock - since)
            req.last_token_s = clock
        for sess in stepped:
            req = sess.request
            since = (req.last_token_s if req.last_token_s is not None
                     else clock - elapsed)
            # A speculative step that landed m tokens counts m gaps of
            # gap / m.
            m = max(1, sess.last_emit)
            self._itl.extend([(clock - since) / m] * m)
            req.last_token_s = clock
        for sess in finished:
            req = sess.request
            req.tokens.extend(sess.emitted)
            sess.emitted = []
            req.finish_s = clock
            completed.append(req)
