"""SLO-driven admission control + replica autoscaling for the serving
fleet (the JAX package's ``serving/fleet.py``).

Closes the loop on the TTFT the scheduler measures: instead of letting
a 10x arrival surge queue unboundedly — every queued request's TTFT
grows without limit until the whole fleet misses SLO ("collapse") —
the :class:`AdmissionController` watches live p95 TTFT against
``Config.serving_slo_ttft_us`` and **sheds** arrivals with a typed
:class:`AdmissionRejected` the moment the fleet is out of budget.  Shedding is backpressure, not a timeout: the client learns in
O(1) that it must retry elsewhere/later, and the requests already
admitted keep their latency bounded.

The :class:`FleetController` turns sustained queue depth into replica
count: scale-up builds a fresh engine through a caller-supplied factory
and registers it with the router; scale-down picks the least-loaded
live replica and retires it through the scheduler's drain — the
same drain→reroute path a replica kill takes, minus the kill — so
in-flight sessions resume token-exactly elsewhere (re-prefill keys are
slot/replica-independent).  ``sustain`` consecutive over/under-water
ticks are required before acting: admission-rate steps are spiky, and a
controller that flaps on one tick's depth thrashes compile caches.

Both classes are dependency-free bookkeeping (no torch):
the scheduler owns the clock, the engines, and the telemetry; this
module owns only the decisions.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional


class AdmissionRejected(RuntimeError):
    """Typed backpressure: the fleet's live p95 TTFT is over the SLO
    target, so this arrival is shed at the door instead of queued into
    a latency it can't meet.  Carries the evidence a client (or the
    surge bench) needs to reason about the rejection."""

    def __init__(self, rid: str, *, p95_ttft_us: float, target_us: float,
                 queue_depth: int, reason: str = "slo"):
        self.rid = rid
        self.p95_ttft_us = float(p95_ttft_us)
        self.target_us = float(target_us)
        self.queue_depth = int(queue_depth)
        self.reason = reason
        super().__init__(
            f"request {rid} shed ({reason}): p95 TTFT "
            f"{self.p95_ttft_us:.0f}us > target {self.target_us:.0f}us "
            f"at queue depth {queue_depth}")


class AdmissionController:
    """Rolling-window p95 TTFT vs the SLO target.

    ``observe`` feeds every first-admission TTFT (in the scheduler's
    active clock — wall, virtual, or work-unit seconds, µs-scaled for
    comparison); ``check`` raises :class:`AdmissionRejected` while the
    window's p95 exceeds ``slo_ttft_us``.  Below ``min_samples`` the
    controller stays open — shedding on one unlucky sample would reject
    traffic the fleet could trivially serve.  ``slo_ttft_us <= 0``
    disarms it entirely.
    """

    def __init__(self, slo_ttft_us: float, *, window: int = 64,
                 min_samples: int = 8):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {min_samples}")
        self.slo_ttft_us = float(slo_ttft_us)
        self.min_samples = int(min_samples)
        self._ttfts: deque = deque(maxlen=int(window))
        self.shed = 0
        self.admitted = 0

    @property
    def armed(self) -> bool:
        return self.slo_ttft_us > 0

    def observe(self, ttft_s: float) -> None:
        self._ttfts.append(float(ttft_s) * 1e6)

    def p95_ttft_us(self) -> float:
        if not self._ttfts:
            return 0.0
        xs = sorted(self._ttfts)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def check(self, rid: str, queue_depth: int) -> None:
        """Admit (return) or shed (raise) one arrival."""
        if not self.armed or len(self._ttfts) < self.min_samples:
            self.admitted += 1
            return
        p95 = self.p95_ttft_us()
        if p95 > self.slo_ttft_us:
            self.shed += 1
            raise AdmissionRejected(
                rid, p95_ttft_us=p95, target_us=self.slo_ttft_us,
                queue_depth=queue_depth)
        self.admitted += 1


class FleetController:
    """Sustained queue depth -> replica count.

    ``tick(depth, pending)`` once per scheduler tick; returns
    ``"scale_up"`` / ``"scale_down"`` when it acted, else None.
    Scale-up calls ``engine_factory(name)`` (a fresh engine, unique
    name) and ``router.add``; scale-down routes the victim through
    ``drain(engine, pending)`` — the scheduler's kill-path drain, which
    re-queues in-flight sessions with their emitted tokens — then
    ``router.retire`` so the health ledger can never auto-readmit it.
    """

    def __init__(self, router, *, engine_factory: Callable,
                 max_replicas: int, min_replicas: int = 1,
                 high_water: int = 4, low_water: int = 0,
                 sustain: int = 3,
                 drain: Optional[Callable] = None):
        if max_replicas < 1:
            raise ValueError(
                f"max_replicas must be >= 1, got {max_replicas}")
        if min_replicas < 1 or min_replicas > max_replicas:
            raise ValueError(
                f"min_replicas must be in [1, {max_replicas}], got "
                f"{min_replicas}")
        if high_water <= low_water:
            raise ValueError(
                f"high_water ({high_water}) must exceed low_water "
                f"({low_water})")
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        self.router = router
        self.engine_factory = engine_factory
        self.max_replicas = int(max_replicas)
        self.min_replicas = int(min_replicas)
        self.high_water = int(high_water)
        self.low_water = int(low_water)
        self.sustain = int(sustain)
        self.drain = drain
        self._hi_streak = 0
        self._lo_streak = 0
        self._spawned = 0
        self.events: List[str] = []

    def tick(self, depth: int, pending) -> Optional[str]:
        live = self.router.live()
        if depth > self.high_water:
            self._hi_streak += 1
            self._lo_streak = 0
        elif depth <= self.low_water:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = self._lo_streak = 0

        if self._hi_streak >= self.sustain and len(live) < self.max_replicas:
            self._hi_streak = 0
            self._spawned += 1
            name = f"scale{self._spawned}"
            self.router.add(self.engine_factory(name))
            self.events.append("scale_up")
            return "scale_up"

        if self._lo_streak >= self.sustain and len(live) > self.min_replicas:
            self._lo_streak = 0
            # Least-loaded live replica loses: fewest in-flight
            # sessions to reroute (ties broken by name for replay
            # determinism, same ordering Router.pick uses).
            victim = min(live, key=lambda r: (r.active, r.name))
            if self.drain is not None:
                self.drain(victim, pending)
            self.router.retire(victim)
            self.events.append("scale_down")
            return "scale_down"
        return None
