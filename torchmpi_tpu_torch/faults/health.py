"""Per-peer health ledger: consecutive-failure accounting that feeds a
degrade-or-raise decision (the JAX package's ``faults/health.py``:
``PeerHealth`` :25 and ``HealthLedger`` :35, stdlib only).

Peers are free-form strings the call sites choose: PS shard endpoints
(``host:port``), the gang pseudo-peer of the host-staged path, ``aio``,
the serving router's replica names.  The ledger is deliberately dumb: it
counts, it classifies, and it reports transitions; *what to do* about a
dead peer stays with the caller.  The fault layer (``faults/__init__``)
holds the one shared ledger while armed; the restart loop
(``utils/restart.py``) snapshots it next to the checkpoints and
rehydrates it on recovery.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

STATES = ("healthy", "suspect", "dead")


@dataclasses.dataclass
class PeerHealth:
    """One peer's ledger row."""

    peer: str
    consecutive_failures: int = 0
    total_failures: int = 0
    total_successes: int = 0
    state: str = "healthy"


class HealthLedger:
    """Counts consecutive failures per peer and classifies:

    - ``healthy``  — last observation succeeded (or no observations)
    - ``suspect``  — >= ``suspect_after`` consecutive failures
    - ``dead``     — >= ``dead_after`` consecutive failures

    One success fully resets a peer (a live peer is a live peer —
    half-credit schemes just delay both detection and recovery).
    ``on_transition(peer, old, new)`` fires on every state change, which
    is how the fault layer (``faults/__init__``) turns transitions into
    ``tm_fault_`` counters without this module knowing telemetry exists.
    """

    def __init__(self, *, suspect_after: int = 2, dead_after: int = 4,
                 on_transition: Optional[
                     Callable[[str, str, str], None]] = None):
        if not (1 <= suspect_after <= dead_after):
            raise ValueError(
                f"need 1 <= suspect_after ({suspect_after}) <= "
                f"dead_after ({dead_after})")
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._peers: Dict[str, PeerHealth] = {}

    def _classify(self, consecutive: int) -> str:
        if consecutive >= self.dead_after:
            return "dead"
        if consecutive >= self.suspect_after:
            return "suspect"
        return "healthy"

    def record(self, peer: str, ok: bool) -> str:
        """Fold one observation; returns the peer's (new) state."""
        transition: Optional[Tuple[str, str]] = None
        with self._lock:
            h = self._peers.get(peer)
            if h is None:
                h = self._peers[peer] = PeerHealth(peer)
            if ok:
                h.total_successes += 1
                h.consecutive_failures = 0
            else:
                h.total_failures += 1
                h.consecutive_failures += 1
            new = self._classify(h.consecutive_failures)
            if new != h.state:
                transition = (h.state, new)
                h.state = new
            state = h.state
        if transition is not None and self._on_transition is not None:
            try:
                self._on_transition(peer, transition[0], transition[1])
            except Exception:  # noqa: BLE001 — telemetry never fails a step
                pass
        return state

    def state(self, peer: str) -> str:
        with self._lock:
            h = self._peers.get(peer)
            return h.state if h is not None else "healthy"

    def get(self, peer: str) -> Optional[PeerHealth]:
        with self._lock:
            h = self._peers.get(peer)
            return dataclasses.replace(h) if h is not None else None

    def peers(self) -> List[PeerHealth]:
        with self._lock:
            return [dataclasses.replace(h) for h in self._peers.values()]

    def decide(self, peer: str) -> str:
        """Degrade-or-raise verdict for the next interaction with
        ``peer``: ``"ok"`` (proceed), ``"degrade"`` (suspect — proceed
        but prefer a fallback / shed optional traffic), ``"raise"``
        (dead — stop burning the retry budget; surface the loss so the
        restart/elastic layer can act)."""
        s = self.state(peer)
        return {"healthy": "ok", "suspect": "degrade",
                "dead": "raise"}[s]

    def clear(self) -> None:
        with self._lock:
            self._peers.clear()

    # -- snapshot / restore -----------------------------------------------
    #
    # Peer health is evidence, and evidence must survive recovery: the
    # restart loop (utils/restart.py) snapshots the armed ledger next to
    # every checkpoint and rehydrates it on recovery, so a process-level
    # restart does not reset every peer to ``healthy`` and re-burn the
    # full suspect->dead escalation on a peer that was already dead.

    def to_dict(self) -> dict:
        """JSON-ready snapshot of thresholds + every peer row."""
        with self._lock:
            return {
                "suspect_after": self.suspect_after,
                "dead_after": self.dead_after,
                "peers": [dataclasses.asdict(h)
                          for h in self._peers.values()],
            }

    def restore(self, d: dict) -> None:
        """Replace this ledger's peer rows with a :meth:`to_dict`
        snapshot.  Thresholds stay this ledger's own (they come from
        the live policy config, not the snapshot); states are
        re-classified against them from the snapshot's consecutive-
        failure counts.  No ``on_transition`` callbacks fire — a
        snapshot replay is old evidence, not a new observation."""
        peers = d.get("peers")
        if not isinstance(peers, list):
            raise ValueError("health snapshot has no peers list")
        rows = {}
        for p in peers:
            if not isinstance(p, dict) or "peer" not in p:
                raise ValueError(f"malformed health snapshot row: {p!r}")
            h = PeerHealth(
                peer=str(p["peer"]),
                consecutive_failures=int(p.get("consecutive_failures", 0)),
                total_failures=int(p.get("total_failures", 0)),
                total_successes=int(p.get("total_successes", 0)))
            h.state = self._classify(h.consecutive_failures)
            rows[h.peer] = h
        with self._lock:
            self._peers = rows

    @staticmethod
    def from_dict(d: dict, *, on_transition: Optional[
            Callable[[str, str, str], None]] = None) -> "HealthLedger":
        """Build a fresh ledger from a :meth:`to_dict` snapshot
        (thresholds included)."""
        led = HealthLedger(
            suspect_after=int(d.get("suspect_after", 2)),
            dead_after=int(d.get("dead_after", 4)),
            on_transition=on_transition)
        led.restore(d)
        return led
