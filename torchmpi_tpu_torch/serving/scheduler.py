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

With ``Config.obs`` on, each tick records the ``tm_serving_*`` telemetry
(JAX :352-489): requests, completions, tokens, rejections, the admission
gate's ``admitted`` / ``shed``, re-routes and the autoscaler's events;
TTFT and inter-token latency on their histograms (in microseconds), the
queue depth and each replica's slot occupancy, and a ``serving_tick``
step marker, the attribution window.  The scheduler reaches the obs layer
through ``sys.modules`` only: serving never imports the telemetry it
reports to.  ``last_stats`` carries the inter-token gaps (``itl_s``) the
histogram holds.

With ``Config.faults`` armed (JAX :412-470) each replica step is an
arrival at ``serving.replica`` (peer: the replica's name) and each
arrival at the admission gate one at ``serving.admit`` (peer: the
request id).  A fault at the door is a typed shed (``Request.shed``, a
``tm_serving_shed_total``); a transient fault of a step stalls that
replica for the tick through the router's ledger; a hard one marks the
replica dead and drains its sessions to the queue front, re-routed.  An
error that is not the fault layer's still raises.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from .. import runtime
from .engine import ReplicaEngine, RequestRejected, Session, _obs
from .fleet import AdmissionController, AdmissionRejected, \
    FleetController
from .router import Router

_INJECT = __name__.rsplit(".", 2)[0] + ".faults.inject"


def _is_fault(e: BaseException) -> bool:
    """Is ``e`` the fault layer's?  Through ``sys.modules``: while the
    layer was never loaded no exception can be one (JAX :113)."""
    mod = sys.modules.get(_INJECT)
    return mod is not None and isinstance(e, mod.FaultError)


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
    def sharded(cls, params, *, tp: int, num_heads: int, slot_tokens: int,
                axis: str = "model", replicas: Optional[int] = None,
                devices: Optional[Sequence[int]] = None,
                backend: Optional[str] = None, **kw) -> "Server":
        """A server whose every replica is a tensor-parallel slice (JAX
        :214): ``replicas`` disjoint slices of ``tp`` ranks carved in order
        from ``devices`` (default: the current communicator's ranks), a
        :class:`~.tp_engine.TPReplicaEngine` on each, over a communicator
        pushed under the replica's name (``tp0``, ``tp1``, ...) with the
        one axis ``axis``.  ``params`` is a full ``tp_generate.init_tp_lm``
        tree (sharded per replica); ``backend`` routes the replicas'
        allreduces; ``kw`` are the engines' knobs (``slots``,
        ``spec_k``, ...).  The default is as many replicas as the ranks
        hold.

        In a world of one process the ranks are rank-major (a replica's
        tp ranks a stack on the device; without ``devices`` or a
        communicator of fixed size, the ranks are ``replicas * tp``, one
        replica by default).  Across processes they are processes: every
        process calls this with the same arguments, and gets a server of
        the one replica that holds it, whose requests it serves with the
        other processes of that replica."""
        from .tp_engine import TPReplicaEngine

        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        comm = runtime.current_communicator()
        world = runtime.size()
        if devices is not None:
            pool = [int(d) for d in devices]
        elif world > 1:
            pool = list(comm.ranks)
        else:
            fixed = comm.fixed_size()
            pool = list(range(fixed if fixed is not None
                              else tp * int(replicas or 1)))
        n = int(replicas) if replicas is not None else len(pool) // tp
        if n < 1 or n * tp > len(pool):
            raise ValueError(
                f"{n} replicas x {tp} devices need {n * tp} devices, "
                f"have {len(pool)}")
        slices = [pool[i * tp:(i + 1) * tp] for i in range(n)]
        for i, ranks in enumerate(slices):
            runtime.push_communicator(f"tp{i}", devices=ranks,
                                      shape={axis: tp})
            runtime.pop_communicator()
        if world > 1:
            me = runtime.rank()
            mine = [i for i, r in enumerate(slices) if me in r]
            if not mine:
                raise ValueError(f"rank {me} is in none of the {n} "
                                 f"replicas' ranks {slices}")
            slices_i = mine
        else:
            slices_i = list(range(n))
        engines = [TPReplicaEngine(params, axis=axis, num_heads=num_heads,
                                   name=f"tp{i}", communicator=f"tp{i}",
                                   slot_tokens=slot_tokens, backend=backend,
                                   **kw)
                   for i in slices_i]
        return cls(None, engines=engines)

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
            self._record_tick(pending, newly_admitted, stepped, finished,
                              completed, clock, elapsed)
            if self._fleet is not None:
                event = self._fleet.tick(len(pending), pending)
                mod = _obs()
                if event is not None and mod is not None:
                    mod.record_serving(event)
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
                mod = _obs()
                if mod is not None:
                    mod.record_serving("rejected", replica=eng.name)
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
            try:
                self._fire(eng.name)
                advanced, fin = eng.step()
            except BaseException as e:  # noqa: BLE001 - resilience path
                if not self._handle_failure(eng, e, pending):
                    raise
                continue
            self.router.record(eng, True)
            stepped.extend(advanced)
            finished.extend(fin)
        return admitted, stepped, finished, rejected

    @staticmethod
    def _fire(name: str) -> None:
        """The ``serving.replica`` site: one arrival a replica step while
        the fault layer is armed (one string compare when off)."""
        if runtime.effective_config().faults == "off":
            return
        from .. import faults

        faults.fire("serving.replica", peer=name)

    def _handle_failure(self, eng: ReplicaEngine, e: BaseException,
                        pending: deque) -> bool:
        """Route a failed replica step; False re-raises it (not the fault
        layer's: a model bug stays loud).  A transient fault is one
        failure on the router's ledger (the replica sits out this tick);
        a hard one marks it dead; a dead verdict drains it."""
        if not _is_fault(e):
            return False
        if getattr(e, "transient", False):
            verdict = self.router.record(eng, False)
        else:
            self.router.mark_dead(eng)
            verdict = "raise"
        if verdict == "raise":
            self._drain(eng, pending)
        return True

    def _gate(self, req: Request, depth: int) -> Optional[str]:
        """The admission gate, once per arrival before it queues: the
        ``serving.admit`` site (any fault verdict at the door is a shed:
        a dropped admission RPC and an SLO rejection look alike to the
        client), then the SLO admission controller.  Returns the shed
        reason, or None."""
        if runtime.effective_config().faults != "off":
            from .. import faults

            try:
                faults.fire("serving.admit", peer=req.rid)
            except BaseException as e:  # noqa: BLE001 - shed, not crash
                if not _is_fault(e):
                    raise
                mod = _obs()
                if mod is not None:
                    mod.record_serving("shed")
                return (f"request {req.rid!r} shed (fault at "
                        f"serving.admit): {e}")
        if self._admission is not None:
            try:
                self._admission.check(req.rid, depth)
            except AdmissionRejected as e:
                mod = _obs()
                if mod is not None:
                    mod.record_serving("shed")
                return str(e)
            mod = _obs()
            if mod is not None:
                mod.record_serving("admitted")
        return None

    def _drain(self, eng: ReplicaEngine, pending: deque) -> None:
        """Move a drained replica's in-flight sessions (a dead one's, or
        the autoscaler's scale-down) to the queue front (they already
        waited once) for re-prefill elsewhere."""
        sessions = eng.drain()
        eng.dead = True
        mod = _obs()
        if mod is not None and sessions:
            mod.record_serving("rerouted", len(sessions), replica=eng.name)
        for sess in reversed(sessions):
            req = sess.request
            req.tokens.extend(sess.emitted)
            req.reroutes += 1
            pending.appendleft(req)

    # -- telemetry + result bookkeeping ------------------------------------

    def _record_tick(self, pending, admitted, stepped, finished, completed,
                     clock: float, elapsed: float) -> None:
        mod = _obs()
        for sess in admitted:
            req = sess.request
            if req.ttft_s is None:
                req.ttft_s = clock - req.arrival_s
                if self._admission is not None:
                    # The SLO gate's window is fed with obs off too.
                    self._admission.observe(req.ttft_s)
                if mod is not None:
                    mod.record_serving("requests", replica=req.replica)
                    mod.record_serving_latency("ttft", req.ttft_s,
                                               replica=req.replica)
            else:
                # Re-admission after a re-route: the whole stall since the
                # last token is one inter-token gap.
                since = (req.last_token_s if req.last_token_s is not None
                         else clock - elapsed)
                self._itl.append(clock - since)
                if mod is not None:
                    mod.record_serving_latency("itl", clock - since,
                                               replica=req.replica)
            req.last_token_s = clock
        for sess in finished:
            req = sess.request
            req.tokens.extend(sess.emitted)
            sess.emitted = []
            req.finish_s = clock
            completed.append(req)
            if mod is not None:
                mod.record_serving("completed", replica=req.replica)
        for sess in stepped:
            req = sess.request
            since = (req.last_token_s if req.last_token_s is not None
                     else clock - elapsed)
            # A speculative step that landed m tokens counts m gaps of
            # gap / m.
            m = max(1, sess.last_emit)
            self._itl.extend([(clock - since) / m] * m)
            if mod is not None:
                for _ in range(m):
                    mod.record_serving_latency("itl", (clock - since) / m,
                                               replica=req.replica)
            req.last_token_s = clock
        if mod is None:
            return
        by_rep: dict = {}
        for sess in admitted:
            by_rep[sess.request.replica] = \
                by_rep.get(sess.request.replica, 0) + 1
        for sess in stepped:
            by_rep[sess.request.replica] = \
                by_rep.get(sess.request.replica, 0) + sess.last_emit
        for rep, n in by_rep.items():
            if n:
                mod.record_serving("tokens", n, replica=rep)
        mod.record_serving_depth(len(pending))
        for eng in self.router.live():
            mod.record_serving_occupancy(eng.pool.occupancy_pct(),
                                         replica=eng.name)
        # Tick boundary: the serving side's attribution window edge.
        mod.record_step("serving_tick")
