"""Health-routed multi-replica dispatch (the JAX package's
``serving/router.py``).

The router spreads sessions across replicas and folds every step outcome
into a per-replica health ledger (``faults.health.HealthLedger``: ok |
degrade | raise).  The JAX router shares the armed fault layer's ledger;
the port's fault layer is ROADMAP queue A, item 10, so the router keeps
a private ledger with the same semantics unless the caller passes one.

Routing policy (:meth:`Router.pick`): least-loaded among the replicas
whose verdict is ``ok``; ``degrade`` replicas admit only when no healthy
replica has a free slot; ``raise`` (dead) replicas admit nothing, and the
scheduler drains their in-flight sessions for re-routing.  A drained
replica whose ledger returns to ``healthy`` (a success recorded through
:meth:`Router.record`) rejoins the rotation (:meth:`Router.readmit`),
empty.
"""

from __future__ import annotations

from typing import List, Optional

from ..faults.health import HealthLedger
from .engine import ReplicaEngine


class Router:
    """Health-aware replica selection over a replica set."""

    def __init__(self, replicas: List[ReplicaEngine], *,
                 ledger: Optional[HealthLedger] = None,
                 suspect_after: int = 2, dead_after: int = 3):
        if not replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self.replicas = list(replicas)
        self._ledger = ledger or HealthLedger(suspect_after=suspect_after,
                                              dead_after=dead_after)

    # -- health ------------------------------------------------------------

    def record(self, replica: ReplicaEngine, ok: bool) -> str:
        """Fold one step outcome; returns the decide() verdict.  A
        success that brings a drained replica's ledger back to
        ``healthy`` re-admits it."""
        self._ledger.record(replica.name, ok)
        if ok and replica.dead and \
                self._ledger.state(replica.name) == "healthy":
            self.readmit(replica)
        return self.decide(replica)

    def readmit(self, replica: ReplicaEngine) -> None:
        """Return a healed (previously drained) replica to the rotation.
        A retired replica (scaled down on purpose, :meth:`retire`) never
        comes back this way."""
        if replica.dead and not getattr(replica, "retired", False):
            replica.dead = False

    def decide(self, replica: ReplicaEngine) -> str:
        if replica.dead:
            return "raise"
        return self._ledger.decide(replica.name)

    def mark_dead(self, replica: ReplicaEngine) -> None:
        """Hard failure: push the ledger past its thresholds, so the
        verdict is ``raise`` at once."""
        for _ in range(max(1, self._ledger.dead_after)):
            self._ledger.record(replica.name, ok=False)

    # -- fleet membership --------------------------------------------------

    def add(self, replica: ReplicaEngine) -> None:
        """Register a freshly built replica (autoscale scale-up)."""
        if any(r.name == replica.name for r in self.replicas):
            raise ValueError(
                f"replica name {replica.name!r} already registered")
        self.replicas.append(replica)

    def retire(self, replica: ReplicaEngine) -> None:
        """Take a replica out of the fleet for good (autoscale
        scale-down; the caller drains it first)."""
        replica.dead = True
        replica.retired = True

    # -- selection ---------------------------------------------------------

    def live(self) -> List[ReplicaEngine]:
        return [r for r in self.replicas if not r.dead]

    def pick(self) -> Optional[ReplicaEngine]:
        """Replica for the next admission, or None when nothing can take
        it this tick."""
        for verdict in ("ok", "degrade"):
            ready = [r for r in self.live()
                     if self.decide(r) == verdict and r.has_capacity()]
            if ready:
                return min(ready, key=lambda r: (r.active, r.name))
        return None
