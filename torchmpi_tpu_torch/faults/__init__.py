"""Deterministic fault injection and resilient dispatch for the port's
host-facing paths (the JAX package's ``faults/``; docs/FAULTS_TORCH.md).

The reference assumed a benign MPI fabric; a production deployment
cannot.  This package is the robustness layer over every surface of the
port that leaves the device: the host-staged collectives, the barrier,
the parameter-server sockets, the async host-IO writer and the serving
scheduler, in two halves:

- **Injection** (:mod:`.inject`): a seed+site-keyed :class:`FaultPlan`
  (versioned JSON; ``python -m torchmpi_tpu_torch.faults.tool`` writes
  and lints them) deterministically delays, drops, corrupts-then-heals,
  stalls or hard-fails named sites.
- **Resilience** (:mod:`.policy`, :mod:`.health`): bounded, jittered
  retries of transient errors, per-site deadlines that turn unbounded
  hangs into :class:`PeerTimeoutError` (carrying the obs flight tail),
  and the per-peer health ledger that feeds degrade-or-raise.

Off by default and **never imported when off**: every call site guards
its hook behind one ``Config.faults != "off"`` string compare
(``tests/test_torch_faults.py`` asserts it in a subprocess).  Enable via
``Config.faults`` / ``TORCHMPI_TPU_FAULTS``: ``"policy"`` arms the
resilience alone, a plan path arms injection too.  A corrupt or
mismatched plan raises at ``init``.

Every injected and survived event reaches ``tm_fault_*`` counters and the
flight ring through :mod:`torchmpi_tpu_torch.obs` when that is active
(``utils/telemetry.py``), so ``obs.tool blame`` can name the injected
site.  The checkpoint sites (:func:`ckpt_write` / :func:`ckpt_read`) fire
under ``utils/checkpoint.py`` while a plan is loaded.  The JAX package's
wire guard (``wire_guard=``) is ROADMAP A10 (c): the port has no
``Config.guard``, so its sites take the unguarded path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from .health import HealthLedger, PeerHealth  # noqa: F401
from .inject import (  # noqa: F401
    BOARD_SITES,
    FAULT_PLAN_VERSION,
    KINDS,
    PAYLOAD_SITES,
    SITES,
    CorruptPayload,
    DroppedPacket,
    FaultError,
    FaultPlan,
    FaultRule,
    InjectedFailure,
    TornWrite,
    TransientFault,
    corrupt_buffer,
    decision,
    lint_plan,
    parse_partition_ranks,
)
from . import policy as policy_mod  # bound BEFORE the policy() accessor
#                                     could shadow the submodule name
from .policy import (  # noqa: F401
    PeerTimeoutError,
    Policy,
    RetriesExhaustedError,
    bounded_call,
    flight_tail,
    is_timeoutish,
    is_transient,
)

_WATCHDOG = __name__.rsplit(".", 1)[0] + ".watchdog"

_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_policy = Policy()
_armed = False
_ledger = HealthLedger(
    on_transition=lambda peer, old, new: _emit(
        "health", "ledger", kind=new, peer=peer))


def active() -> bool:
    return _armed


def injecting() -> bool:
    return _armed and _plan is not None


def plan() -> Optional[FaultPlan]:
    return _plan


def current_policy() -> Policy:
    # NOT named ``policy``: that would shadow the submodule.
    return _policy


def ledger() -> HealthLedger:
    """The one per-peer health ledger of the fault layer (the serving
    router takes it while the layer is armed)."""
    return _ledger


_NO_MASK = object()  # "computed: the plan has no partition rule"


def board_partition():
    """The armed plan's board-partition visibility mask
    (:mod:`.partition`), or None.  Built lazily once a plan and cached
    on it: the partition module is imported only when a partition rule
    exists.  Its reader, the membership board, is ROADMAP A10 (c)."""
    p = _plan
    if not _armed or p is None:
        return None
    mask = getattr(p, "_partition_mask", None)
    if mask is None:
        if not any(r.kind == "partition" for r in p.rules):
            mask = _NO_MASK
        else:
            from . import partition

            mask = partition.build(p) or _NO_MASK
        p._partition_mask = mask  # type: ignore[attr-defined]
    return None if mask is _NO_MASK else mask


def activate(mode: str, *, retries: int = 2, backoff_s: float = 0.05,
             deadline_s: float = 30.0) -> None:
    """Arm the layer (``runtime.init`` / ``set_config`` call this while
    ``Config.faults != "off"``).  ``mode`` is ``"policy"`` or a plan
    path; the knobs are ``Config.fault_*``.  Idempotent: re-activation
    with the same plan path keeps its schedule counters (an in-run
    ``set_config`` must not restart the schedule), another path loads
    afresh."""
    global _plan, _policy, _armed
    with _lock:
        if mode == "policy":
            new_plan = None
        elif _plan is not None and getattr(_plan, "_path", None) == mode:
            new_plan = _plan
        else:
            new_plan = FaultPlan.load(mode)
            new_plan._path = mode  # type: ignore[attr-defined]
        _plan = new_plan
        _policy = Policy(retries=int(retries), backoff_s=float(backoff_s),
                         deadline_s=float(deadline_s),
                         seed=_plan.seed if _plan is not None else 0)
        _armed = True


def deactivate() -> None:
    """Disarm; the health ledger's history stays readable."""
    global _plan, _armed
    with _lock:
        _armed = False
        _plan = None


def reset() -> None:
    """Disarm AND forget the ledger's history (tests)."""
    deactivate()
    _ledger.clear()


def _emit(action: str, site: str, *, kind: str = "", peer: str = "") -> None:
    """``tm_fault_*`` through obs when obs is active, never importing it
    (``utils/telemetry.py``)."""
    from ..utils import telemetry

    telemetry.emit("record_fault", action, site, kind=kind, peer=peer)


# ---------------------------------------------------------------------------
# The two primitives the call sites compose: fire() (injection) and
# run_site() (resilience).
# ---------------------------------------------------------------------------


def fire(site: str, payload=None, peer: str = "") -> None:
    """One arrival at an instrumented site.  With a plan armed, applies
    what the deterministic schedule says for this arrival: sleep
    (delay), corrupt ``payload`` (a writable host buffer: a CPU tensor,
    pinned or not, or a numpy array) and raise (corrupt), raise
    transient (drop), hold (stall) or raise hard (fail).  Without a plan
    (policy mode) a no-op."""
    p = _plan
    if not _armed or p is None:
        return
    decided = p.decide(site)
    if decided is None:
        return
    rule, arrival = decided
    _emit("injected", site, kind=rule.kind, peer=peer)
    if rule.kind == "delay":
        _sleep(rule.delay_s)
        return
    if rule.kind == "drop":
        _sleep(rule.delay_s)
        raise DroppedPacket(
            f"injected drop at {site} (arrival {arrival}, peer silent "
            f"{rule.delay_s:.3g}s)")
    if rule.kind == "corrupt":
        corrupt_buffer(payload, p.seed, arrival)
        raise CorruptPayload(
            f"injected payload corruption at {site} (integrity check "
            f"failed)")
    if rule.kind == "corrupt_silent":
        # Bits flip and nothing raises: with no wire guard in the port
        # the corruption propagates (the silent production failure).
        corrupt_buffer(payload, p.seed, arrival)
        return
    if rule.kind == "torn":
        raise TornWrite(
            f"injected torn write at {site} (arrival {arrival})")
    if rule.kind == "stall":
        _stall_hold(site, peer, p)
        return
    raise InjectedFailure(f"injected hard failure at {site}")


def _stall_hold(site: str, peer: str, plan: "FaultPlan") -> None:
    """The ``stall`` kind's indefinite hold: progress stops and nothing
    raises.  The hold registers itself with an armed watchdog through
    ``sys.modules`` (this package never imports it), so: watchdog off,
    the site wedges; ``"warn"``, the stall is flagged live (counters,
    flight event, lease); ``"break"``, ``watchdog.check_break`` raises
    the typed ``CollectiveHangError`` out of the hold.  Disarming the
    fault layer (or replacing the plan) releases the hold."""
    import sys
    import time

    mod = None
    tok = -1
    try:
        while True:
            if not _armed or _plan is not plan:
                return  # chaos disarmed: the modeled wedge is gone
            m = sys.modules.get(_WATCHDOG)
            if m is not None and m.active():
                if m is not mod or not m.is_inflight(tok):
                    # First sight of an armed watchdog, or a stale token
                    # from before a re-activation: register the hold.
                    mod, tok = m, m.begin(site, op="stall", peer=peer)
                m.check_break(tok)  # raises CollectiveHangError on break
            time.sleep(0.01)
    finally:
        if mod is not None:
            mod.end(tok)


def _sleep(seconds: float) -> None:
    if seconds > 0:
        import time

        time.sleep(seconds)


def run_site(site: str, attempt: Callable[[int], Any], *,
             peer: str = "") -> Any:
    """Execute ``attempt(try_index)`` under the armed retry policy,
    recording per-peer health and emitting ``tm_fault_*`` events.  The
    attempt calls :func:`fire` at its injection points, so a retry is the
    next arrival at the site."""

    def on_event(action: str, s: str) -> None:
        _emit(action, s, peer=peer)

    def tracked(i: int):
        try:
            out = attempt(i)
        except BaseException as e:
            if peer and is_transient(e):
                _ledger.record(peer, ok=False)
            raise
        if peer:
            _ledger.record(peer, ok=True)
        return out

    return policy_mod.run(site, tracked, policy=_policy, peer=peer,
                          on_event=on_event)


# ---------------------------------------------------------------------------
# Site wrappers (one per instrumented surface, so the call sites stay a
# single guarded line).
# ---------------------------------------------------------------------------


def staged_exchange(op_name: str, x, n: int, params: dict,
                    compute: Callable) -> Any:
    """The host-staged collective under injection and policy (JAX
    :310-380): each attempt stages a FRESH writable host copy of ``x``
    (a tensor on the card or the CPU, or the async worker's
    ``collectives._RestageView`` of a master already on the host), the
    device -> host leg fires ``host_staged.gather`` on it,
    ``compute(op_name, host, n, **params)`` runs the closed form, and
    the host -> device leg fires ``host_staged.scatter`` on the result.
    A transient fault retries the WHOLE exchange from the untouched
    source, which is what makes corrupt-then-heal give back the clean
    bits.  Two arrivals an attempt, one a leg, as in the JAX package.
    Returns the host result; placing it is the caller's."""
    from .. import collectives

    def attempt(_i: int):
        xs = collectives._restage(x)
        fire("host_staged.gather", payload=xs, peer="gang")
        out = compute(op_name, xs, n, **params).contiguous()
        fire("host_staged.scatter", payload=out, peer="gang")
        return out

    return run_site("host_staged", attempt, peer="gang")


def guarded_barrier(name: str, sync: Callable[[], None]) -> None:
    """``runtime.barrier`` under injection and policy: the site fires
    once an attempt, and the (genuinely blocking) sync runs under the
    deadline budget, so a wedged peer surfaces as ``PeerTimeoutError``
    instead of an unbounded wait."""

    def attempt(_i: int):
        fire("runtime.barrier", peer="gang")
        return bounded_call("runtime.barrier", sync,
                            deadline_s=_policy.deadline_s, peer="gang")

    return run_site("runtime.barrier", attempt, peer="gang")


def aio_submit(submit: Callable[[], Any]) -> Any:
    """One async-IO submission under injection and policy (site
    ``aio.submit``): an enqueue, so a retry is cheap and safe."""

    def attempt(_i: int):
        fire("aio.submit", peer="aio")
        return submit()

    return run_site("aio.submit", attempt, peer="aio")


def ps_exchange_once(peers: List[str], stage: Optional[Callable[[], Any]],
                     enqueue: Callable[..., Any]) -> Any:
    """ONE staged PS enqueue: ``stage()`` makes the flat host payload
    (None for payload-free exchanges such as receive), ``ps.request``
    fires on it, then ``enqueue(payload)`` hands it to the native layer.
    Not retried here: :func:`ps_enqueue` (first enqueue) and
    :func:`ps_wait` (retransmits) compose it."""
    payload = stage() if stage is not None else None
    fire("ps.request", payload=payload, peer=",".join(peers))
    return enqueue(payload) if stage is not None else enqueue()


def ps_enqueue(peers: List[str], enqueue: Callable[..., Any], *,
               stage: Optional[Callable[[], Any]] = None) -> Any:
    """A PS client enqueue (send / receive) under injection and policy:
    ``ps.request`` fires once an attempt before the sockets are touched;
    with ``stage`` the payload is staged again an attempt."""
    return run_site("ps.request",
                    lambda _i: ps_exchange_once(peers, stage, enqueue),
                    peer=",".join(peers))


def ps_wait(peers: List[str], make_handle: Callable[[], Any],
            first_handle: Any) -> Any:
    """A PS exchange's wait leg under injection and policy.  The first
    attempt waits on the already-enqueued ``first_handle`` (the async
    overlap is kept); a failed wait re-runs the WHOLE exchange through
    ``make_handle``: a retransmit, not a re-wait, since the native future
    is spent by its failure.  ``ps.response`` fires BEFORE the wait, so
    a drop there abandons an exchange the server has already applied
    and the retransmit applies it again (an ``add`` push lands twice:
    the JAX package's semantics, ROADMAP queue C).  Peer health is
    recorded per shard from the handle's ``failed_index``; a peer the
    ledger calls dead ends the loop as a ``PeerTimeoutError``."""
    state = {"handle": first_handle}
    peer_all = ",".join(peers)

    def attempt(i: int):
        if i > 0:
            doomed = [p for p in peers if _ledger.decide(p) == "raise"]
            if doomed:
                raise PeerTimeoutError(
                    "ps.response", peer=doomed[0],
                    deadline_s=_policy.deadline_s,
                    flight_tail=flight_tail())
            state["handle"] = make_handle()
        fire("ps.response", peer=peer_all)
        h = state["handle"]
        try:
            out = h.wait(timeout_ms=_wait_budget_ms())
        except BaseException as e:
            bad = getattr(h, "failed_index", None)
            if bad is not None and 0 <= bad < len(peers):
                _ledger.record(peers[bad], ok=False)
            raise _as_transient(e)
        for p in peers:
            _ledger.record(p, ok=True)
        return out

    def on_event(action: str, s: str) -> None:
        _emit(action, s, peer=peer_all)

    return policy_mod.run("ps.response", attempt, policy=_policy,
                          peer=peer_all, on_event=on_event)


def ckpt_write(path: str, data, commit: Callable[[], Any]) -> Any:
    """One checkpoint-file commit under injection (site ``ckpt.write``,
    ``utils/checkpoint.py``; JAX :518-548).  ``data`` is the writable
    staged byte buffer (a uint8 numpy view) about to land on disk:
    ``corrupt_silent`` flips real bits that are then written and fsync'd
    (the digest recorded before no longer matches), ``torn`` writes half
    the payload to ``path + ".tmp"`` and raises an EIO ``OSError`` (the
    crash mid-save), ``fail`` raises an ENOSPC ``OSError``.  Not retried:
    a disk that ate one write eats the next; the recovery protocol (walk
    back, buddy repair) is the answer."""
    import errno

    try:
        fire("ckpt.write", payload=data, peer="storage")
    except TornWrite as e:
        try:
            n = max(1, len(data) // 2)
            with open(path + ".tmp", "wb") as f:
                f.write(memoryview(data).cast("B")[:n])
        except OSError:
            pass  # even the torn prefix failed: the artifact is optional
        raise OSError(
            errno.EIO, f"injected torn write (crash mid-save): {path}"
        ) from e
    except InjectedFailure as e:
        raise OSError(errno.ENOSPC, f"injected ENOSPC writing {path}") from e
    return commit()


def ckpt_read(path: str, data) -> None:
    """One checkpoint npz read under injection (site ``ckpt.read``; JAX
    :551-566).  ``data`` is the writable buffer just read back:
    ``corrupt_silent`` is the on-disk rot a verified restore must catch
    (and in buddy mode repair); ``fail`` raises an EIO ``OSError``.  Not
    retried: re-reading a rotten file gives the same rot."""
    import errno

    try:
        fire("ckpt.read", payload=data, peer="storage")
    except InjectedFailure as e:
        raise OSError(errno.EIO, f"injected read failure for {path}") from e


def _wait_budget_ms() -> int:
    """Per-attempt native-wait bound from the site deadline, so one
    wedged shard cannot eat the whole budget before a retransmit."""
    if _policy.deadline_s <= 0:
        return 0
    return max(1, int(_policy.deadline_s * 1000
                      / (1 + max(0, _policy.retries))))


def _as_transient(e: BaseException) -> BaseException:
    """A failed PS wait is a transport failure, retryable by
    retransmit: the generic RuntimeError of a failed native future is
    re-flagged transient here, the one place that knows a retransmit
    exists."""
    if is_transient(e):
        return e
    if isinstance(e, RuntimeError):
        t = TransientFault(str(e))
        t.__cause__ = e
        return t
    return e
