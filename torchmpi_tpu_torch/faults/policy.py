"""Resilient dispatch: bounded retries, jittered backoff, site deadlines.

The survival half of ``torchmpi_tpu_torch.faults`` (the JAX package's
``faults/policy.py``; docs/FAULTS_TORCH.md).  One :class:`Policy` is
threaded through every instrumented site (the host-staged exchange legs,
the PS request and response, aio submissions, the barrier): :func:`run`
executes an attempt callable, retries it on *transient* errors (injected
``TransientFault``\\ s and the real socket family) with exponential,
deterministically jittered backoff, and converts what would be an
unbounded hang into a typed :class:`PeerTimeoutError` within the site's
deadline budget.

``PeerTimeoutError`` is ONE class across the port: the one
``collectives.AsyncHandle.wait(timeout_s)`` raises, defined in
``collectives.py`` (which the off path loads anyway) and re-exported
here, so one ``except`` catches both.  It carries the flight-recorder
tail (``utils.telemetry.flight_tail``, empty with obs off).
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import socket
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from ..collectives import PeerTimeoutError  # noqa: F401 — one class
from .inject import FaultError  # noqa: F401

# errnos of transient socket conditions worth a retransmit.
_TRANSIENT_ERRNOS = frozenset({
    errno.ECONNRESET, errno.ECONNREFUSED, errno.ECONNABORTED,
    errno.EPIPE, errno.ETIMEDOUT, errno.EAGAIN, errno.EINTR,
    errno.ENETUNREACH, errno.EHOSTUNREACH,
})


def is_transient(e: BaseException) -> bool:
    """Would a retry plausibly succeed?  Errors that classify
    themselves (a bool ``transient`` attribute — injected
    ``FaultError``\\ s, the watchdog's ``CollectiveHangError``, which is
    timeout-flavored but must NOT be retried: re-waiting the wait that
    wedged would re-wedge) are believed; real socket errors qualify by
    class/errno; everything else does not."""
    t = getattr(e, "transient", None)
    if isinstance(t, bool):
        return t
    if isinstance(e, (socket.timeout, TimeoutError, ConnectionError,
                      BrokenPipeError)):
        return True
    if isinstance(e, OSError):
        return e.errno in _TRANSIENT_ERRNOS
    return False


def is_timeoutish(e: BaseException) -> bool:
    """Does this error mean "the peer went silent" (so exhausting
    retries is a peer timeout, not a logic failure)?  Self-classifying
    errors (a bool ``is_timeout`` attribute) are believed — the same
    duck-typed contract as :func:`is_transient`."""
    t = getattr(e, "is_timeout", None)
    if isinstance(t, bool):
        return t
    return isinstance(e, (socket.timeout, TimeoutError)) or (
        isinstance(e, OSError) and e.errno == errno.ETIMEDOUT)


class RetriesExhaustedError(RuntimeError):
    """Transient failures outlived the retry budget (and were not
    timeout-flavored — those become :class:`PeerTimeoutError`)."""

    def __init__(self, site: str, attempts: int,
                 last_error: BaseException):
        self.site = site
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"{site}: still failing after {attempts} attempt(s): "
            f"{last_error!r}")


@dataclasses.dataclass
class Policy:
    """Retry/backoff/deadline knobs (``Config.fault_*``)."""

    retries: int = 2             # re-attempts AFTER the first try
    backoff_s: float = 0.05      # first backoff; doubles per retry
    backoff_max_s: float = 2.0
    jitter: float = 0.5          # +[0, jitter) fraction, deterministic
    deadline_s: float = 30.0     # per-site wall budget; 0 = unbounded
    seed: int = 0                # jitter determinism (plan seed)

    def backoff(self, site: str, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (1-based), jittered by
        a pure hash so two runs of the same plan sleep identically."""
        base = min(self.backoff_max_s,
                   self.backoff_s * (2 ** max(0, attempt - 1)))
        h = hashlib.blake2b(f"{self.seed}:{site}:{attempt}".encode(),
                            digest_size=8).digest()
        u = int.from_bytes(h, "big") / float(1 << 64)
        return base * (1.0 + self.jitter * u)


def flight_tail(n: int = 8) -> List[dict]:
    """The last ``n`` flight-recorder events, when obs is active (via
    sys.modules — a faults-only session must not import obs).  ONE
    implementation, shared with the watchdog: ``utils/telemetry.py``."""
    from ..utils import telemetry

    return telemetry.flight_tail(n)


def run(site: str, attempt: Callable[[int], Any], *, policy: Policy,
        peer: str = "",
        on_event: Optional[Callable[[str, str], None]] = None) -> Any:
    """Execute ``attempt(try_index)`` under ``policy``.

    - transient error + budget left  -> backoff, retry
      (``on_event("retry", site)``; ``"survived"`` on eventual success)
    - transient error, budget gone   -> :class:`RetriesExhaustedError`,
      or :class:`PeerTimeoutError` when the error is timeout-flavored
    - elapsed beyond ``deadline_s``  -> :class:`PeerTimeoutError`
    - non-transient error            -> propagates untouched
    """
    t0 = time.monotonic()
    failures = 0
    while True:
        try:
            result = attempt(failures)
        except BaseException as e:  # noqa: BLE001 — classified below
            if not is_transient(e):
                raise
            failures += 1
            if on_event is not None:
                on_event("retry" if failures <= policy.retries
                         else "exhausted", site)
            elapsed = time.monotonic() - t0
            over_deadline = (policy.deadline_s > 0
                             and elapsed >= policy.deadline_s)
            if failures > policy.retries or over_deadline:
                if over_deadline or is_timeoutish(e):
                    if on_event is not None:
                        on_event("deadline", site)
                    raise PeerTimeoutError(
                        site, peer=peer, elapsed_s=elapsed,
                        deadline_s=policy.deadline_s, last_error=e,
                        flight_tail=flight_tail()) from e
                raise RetriesExhaustedError(site, failures, e) from e
            pause = policy.backoff(site, failures)
            if policy.deadline_s > 0:
                pause = min(pause, max(
                    0.0, policy.deadline_s - (time.monotonic() - t0)))
            if pause > 0:
                time.sleep(pause)
            continue
        if failures and on_event is not None:
            on_event("survived", site)
        return result


def bounded_call(site: str, fn: Callable[[], Any], *, deadline_s: float,
                 peer: str = "") -> Any:
    """Run a genuinely-blocking call (a gang barrier, a native wait with
    no timeout variant) with a wall deadline: the call runs on a helper
    thread, and if it has not returned within ``deadline_s`` the caller
    gets :class:`PeerTimeoutError` — the thread is abandoned (it cannot
    be cancelled; the caller is about to checkpoint-restore or die,
    which is the point).  ``deadline_s <= 0`` calls inline.

    Cost: one thread create/join per call, paid on the happy path too.
    Acceptable because the only guarded blocking call is the runtime
    barrier (checkpoint/init cadence, not per-step); if a per-step
    blocking site ever lands here, switch to a cached waiter thread."""
    if deadline_s <= 0:
        return fn()
    out: List[Tuple[bool, Any]] = []

    def runner():
        try:
            out.append((True, fn()))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out.append((False, e))

    th = threading.Thread(target=runner, daemon=True,
                          name=f"tm-faults-{site}")
    th.start()
    th.join(deadline_s)
    if th.is_alive():
        raise PeerTimeoutError(site, peer=peer, elapsed_s=deadline_s,
                               deadline_s=deadline_s,
                               flight_tail=flight_tail())
    ok, val = out[0]
    if not ok:
        raise val
    return val
