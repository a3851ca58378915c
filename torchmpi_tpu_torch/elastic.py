"""Elastic gang resize: continue training at N-1 when a member dies, and
admit healed members back at step boundaries (the JAX package's
``elastic.py``; docs/ELASTIC_TORCH.md).

When a member of the training gang dies, the survivors agree on a new
membership view (a bounded two-phase reconcile over the membership
board, ``faults/membership.py``), re-form the world without it
(``runtime.resize_world``: the config-epoch bump strands every cached
plan), restore the last verified checkpoint, re-partition the state onto
the survivors (ZeRO shard layouts and PS shard extents are pure
functions of the state and the member count, so re-sharding is a
rebuild, not a migration) and resume.  A healed member posts a join
(:func:`admit`) and is admitted at a step boundary by the same
reconcile, which brings the original layout back.

Two granularities, as in the JAX package: one member per **process**
across processes (the deployment shape; the survivors form a new process
group over a ``FileStore`` on the board, ``runtime.resize_world``), one
member per **rank-major row** in a world of one process (member ``m``
owns row ``m`` of the full gang, so a survivors-only gang computes each
member's rows exactly as the full gang would: the bit-reproducibility
anchor of the shrink tests).  Deaths are driven by deterministic chaos
plans on the ``elastic.member`` fault site (``faults/tool.py gen
--shrink``), by the health ledger, by a ``PeerTimeoutError`` or watchdog
hang naming a member, by board heartbeats that stop, and by expired
watchdog leases.

Off by default and never imported when off: ``Config.elastic`` is the
consent gate of this driver layer, and no dispatch path branches on it.
Telemetry (``tm_elastic_*``) rides obs through ``utils/telemetry.py``.
With the hot-state tier armed (``hotstate.enable``; reached through
``sys.modules``) the loop streams the state to the buddy's RAM after
every completed step and tells the tier which members died at a shrink,
so a recovery resumes from RAM at the step the death landed on.
Under ``Config.elastic_quorum="majority"`` a reconcile or recovery
agreement commits only with a majority of the last committed view; a
partitioned minority raises ``QuorumLost`` and :func:`run_elastic` parks
it (:func:`_park`) until it can adopt, be admitted into or retry against
the healed board, and the epoch fence (``faults/fencing.py``) keeps a
zombie minority's board writes and checkpoint saves off the majority's
lineage.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import runtime
from .faults import membership
from .faults.membership import MembershipView  # noqa: F401 (re-export)
from .utils import checkpoint, restart, telemetry

PyTree = Any
_PKG = __name__.rsplit(".", 1)[0]

# ``build(comm, view) -> (init_fn, step_fn)``: the per-view step factory
# run_elastic rebuilds the program through after every membership
# change.  ``comm`` is the world communicator ``runtime.resize_world``
# made for the view; ``init_fn() -> state`` returns the FULL (topology
# portable) train state, the checkpoint template; sharded layouts are
# derived from it under the view, which makes the re-partition
# deterministic.  ``step_fn(state, i) -> state``.
BuildFn = Callable[[Any, MembershipView],
                   Tuple[Callable[[], PyTree],
                         Callable[[PyTree, int], PyTree]]]


class MemberDeath(RuntimeError):
    """A gang member died.  Raised out of :func:`run_elastic` only when the
    dead member is THIS process (the survivors go on without it);
    carries ``member`` and ``step``."""

    def __init__(self, member: int, step: int, msg: str = ""):
        super().__init__(
            msg or f"gang member {member} died at step {step}")
        self.member = int(member)
        self.step = int(step)


def _require_on():
    """Every public entry point's consent gate."""
    cfg = runtime.effective_config()
    if cfg.elastic == "off":
        raise RuntimeError(
            "torchmpi_tpu_torch.elastic requires Config.elastic='on' (or "
            "TORCHMPI_TPU_ELASTIC=1): the elastic gang driver is opt-in; "
            "see docs/ELASTIC_TORCH.md")
    return cfg


def _obs_record(event: str, *, epoch: int = 0, members: int = 0,
                peer: str = "") -> None:
    """``tm_elastic_*`` through obs when it is active."""
    telemetry.emit("record_elastic", event, epoch=epoch, members=members,
                   peer=peer)


def _faults_mod():
    """The armed fault layer, or None (one string compare and a
    ``sys.modules`` lookup)."""
    if runtime.effective_config().faults == "off":
        return None
    mod = sys.modules.get(_PKG + ".faults")
    if mod is not None and mod.active():
        return mod
    return None


def _hotstate_mod():
    """The armed hot-state tier, or None (JAX :129; docs/HOTSTATE_TORCH.md):
    the same ``sys.modules`` seam, so a session that never enabled
    ``hotstate`` never imports it here."""
    mod = sys.modules.get(_PKG + ".hotstate")
    if mod is not None and mod.active():
        return mod
    return None


def _hotstate_publish(gang: "ElasticGang", state: PyTree,
                      step: int) -> None:
    """Stream this rank's post-step state to its buddy's RAM when the tier
    is armed (JAX :139).  A ``FencedWriterError`` propagates on purpose: a
    fenced stream is the zombie-minority signal and takes the park path
    of a fenced board write; the rest of the tier is best-effort."""
    mod = _hotstate_mod()
    if mod is not None:
        mod.replicator().publish(
            state, step, rank=gang._rank,
            epoch=getattr(gang.view, "epoch", 0))


def _hotstate_note_shrink(ranks: Sequence[int], step: int) -> None:
    """Membership evidence for the tier (JAX :153): the dead ranks stop
    streaming, but their replicas stay, they are what the RAM rung
    restores from on the shrink's recovery."""
    mod = _hotstate_mod()
    if mod is not None:
        try:
            mod.replicator().note_shrink(ranks, step)
        except Exception:  # noqa: BLE001 — bookkeeping, not correctness
            pass


def _member_peer(m: int) -> str:
    """Ledger peer name of gang member ``m``."""
    return f"member:{int(m)}"


def _is_hang(e: BaseException) -> bool:
    """Is ``e`` the watchdog's ``CollectiveHangError``?"""
    mod = sys.modules.get(_PKG + ".watchdog")
    return mod is not None and isinstance(e, mod.CollectiveHangError)


class ElasticGang:
    """Membership state and resize mechanics of one training gang (JAX
    :179).

    ``directory`` is the checkpoint directory; the board defaults to
    ``Config.elastic_dir`` or ``<directory>/membership``.  ``members``
    (default: one per process across processes, else rows ``0 ..
    world_size - 1``) are integer ranks.  In a world of one process
    ``world_size`` (default ``max(members) + 1``) is the full gang's row
    count and member ``m`` owns row ``m``; ``local`` names the members
    this process speaks for (a protocol harness: two gangs in one process
    sharing one board), default every member."""

    def __init__(self, directory: str, *,
                 members: Optional[Sequence[int]] = None,
                 world_size: Optional[int] = None,
                 board_dir: Optional[str] = None,
                 local: Optional[Sequence[int]] = None):
        cfg = _require_on()
        self.poll_s = float(cfg.elastic_poll_s)
        self.deadline_s = float(cfg.elastic_deadline_s)
        self.quorum = cfg.elastic_quorum == "majority"
        self._multiproc = runtime.is_initialized() and runtime.size() > 1
        if members is None:
            n = (runtime.size() if self._multiproc
                 else int(world_size) if world_size else 1)
            members = range(n)
        members = tuple(sorted(int(m) for m in members))
        self._local_subset = local is not None
        if local is not None:
            if self._multiproc:
                raise ValueError(
                    "local= is a single-process (protocol-harness) knob; "
                    "a multi-process gang speaks for its own rank")
            local = tuple(sorted(int(r) for r in local))
            if not local or not set(local) <= set(members):
                raise ValueError(
                    f"local {list(local)} must be a non-empty subset of "
                    f"members {list(members)}")
        self._rank = (runtime.process_index() if self._multiproc
                      else int((local or members)[0]))
        self.board = membership.Board(
            board_dir or cfg.elastic_dir
            or os.path.join(directory, "membership"),
            reader_rank=self._rank)
        # Only leases renewed after this driver started are evidence: a
        # killed previous run's leftovers must not shrink a slow starter.
        self._lease_floor = time.time()
        if cfg.watchdog != "off":
            from . import watchdog

            if watchdog.active() and watchdog.lease_dir() is None:
                watchdog.set_lease_dir(self.board.directory)
        # Every possible member slot, not only the starting set: a driver
        # restarted with the survivors must still admit a rank it never
        # met.
        if self._multiproc:
            ws = int(world_size) if world_size else runtime.size()
            self.local_ranks: Tuple[int, ...] = (self._rank,)
        else:
            ws = int(world_size) if world_size else members[-1] + 1
            if ws < members[-1] + 1:
                raise ValueError(f"world_size {ws} must cover member "
                                 f"{members[-1]}")
            self.local_ranks = local if local is not None else members
        self._slots = frozenset(range(ws))
        committed = self.board.committed_view()
        if committed is not None and committed.members == members:
            self.view = committed
        else:
            epoch0 = committed.epoch if committed is not None else 0
            self.view = MembershipView(epoch=epoch0, members=members,
                                       step=0)
        self.stats = {"shrinks": 0, "rejoins": 0, "reconciles": 0}
        # The incarnation each member is admitted at: a join with a higher
        # one from a sitting member is a new life of a rank whose death
        # was never committed (the join is the death notice).
        joins = self.board.join_details()
        self._inc: Dict[int, int] = {}
        for m in self.view.members:
            inc = self.board.incarnation(m)
            j = int(joins.get(m, {}).get("incarnation", 0) or 0)
            self._inc[m] = min(inc, j - 1) if j >= max(1, inc) else inc
        self._agree_round = 0
        self._last_hb = 0.0
        for r in self.local_ranks:
            self.board.clear_values(r)
            self.board.clear_votes_above(r, self.view.epoch)
        self._hb_seen: Dict[int, float] = {}
        if self.quorum:
            from .faults import fencing

            self._fence = fencing.arm(
                self.board, self._rank, epoch=self.view.epoch,
                incarnation=self._inc.get(self._rank, 0))
        else:
            self._fence = None

    # -- the world ---------------------------------------------------------

    def member_mesh(self):
        """(Re-)form the world over the current view (JAX :350, through
        ``runtime.resize_world``: the config epoch bumps and every plan is
        dropped).  In a world of one process: a fixed-size ``("ici",)``
        world of the members' rows.  Across processes: a new process
        group of the view's members over a FileStore on the board, keyed
        by the view's epoch; the process world ``init`` made is kept while
        the first view is its whole membership."""
        members = list(self.view.members)
        if not self._multiproc:
            return runtime.resize_world(members)
        tag = runtime.world_tag()
        if tag[1] == tuple(members) and tag[0] in (None, self.view.epoch):
            return runtime.world_communicator()
        return runtime.resize_world(
            members, store_dir=self.board.directory, epoch=self.view.epoch,
            timeout_s=max(self.deadline_s, 1.0))

    def participants(self) -> int:
        """Surviving PROCESS count (the recovery agreement's)."""
        return len(self.view.members) if self._multiproc else 1

    def agreement(self):
        """Survivors-only min-agreement for ``restart.recover`` (the
        full-gang ``checkpoint.agree_min_step`` would hang on the dead
        peer).  With quorum on, a board whose committed epoch moved past
        this rank's view refuses the agreement with ``QuorumLost``."""

        def agree(value: int) -> int:
            if self.quorum:
                committed = self.board.committed_view()
                if committed is not None and \
                        committed.epoch > self.view.epoch:
                    raise membership.QuorumLost(
                        epoch=self.view.epoch,
                        voters=self.local_ranks,
                        quorum_of=committed.members,
                        msg=f"recovery agreement refused: the board "
                            f"committed epoch {committed.epoch} past this "
                            f"rank's view epoch {self.view.epoch}; park "
                            f"and rejoin instead of agreeing a stale "
                            f"restore step")
            self._agree_round += 1
            tag = (f"e{self.view.epoch}s{self.view.step}"
                   f"r{self._agree_round}")
            return membership.agree_min(
                self.board, tag, self.local_ranks, self.view.members, value,
                deadline_s=self.deadline_s, poll_s=self.poll_s)

        return agree

    # -- the step-boundary poll ---------------------------------------------

    def poll(self, step: int) -> Optional[Tuple[str, List[int]]]:
        """One step-boundary membership check (JAX :409): ``("shrink",
        dead)``, ``("rejoin", joiners)`` or None.  With the fault layer
        injecting, the ``elastic.member`` site fires once a member in rank
        order (arrival ``step * len(members) + index``, what ``faults/tool
        gen --shrink`` computes): a ``fail`` kills that member, a ``drop``
        records a ledger failure, a ``stall`` the watchdog breaks is
        death evidence."""
        self.board.note_step(step)
        now = time.monotonic()
        if now - self._last_hb >= max(self.poll_s, self.deadline_s / 4):
            for r in self.local_ranks:
                if r in self.view.members:
                    self.board.heartbeat(r, epoch=self.view.epoch,
                                         step=step)
            self._last_hb = now
        dead: set = set()
        # Board-heartbeat staleness, relative to the gang's freshest
        # member (a whole-gang stall ages every heartbeat together).
        for m, d in self.board.heartbeats().items():
            if m in self._slots:
                self._hb_seen[m] = max(self._hb_seen.get(m, 0.0),
                                       float(d.get("ts", 0.0)))
        seen = {m: self._hb_seen[m] for m in self.view.members
                if m in self._hb_seen}
        if seen:
            newest = max(seen.values())
            dead |= {m for m, ts in seen.items()
                     if newest - ts > self.deadline_s}
        faults = _faults_mod()
        if faults is not None:
            led = faults.ledger()
            if faults.injecting():
                for m in self.view.members:
                    try:
                        faults.fire("elastic.member", peer=_member_peer(m))
                    except faults.InjectedFailure:
                        dead.add(m)
                    except faults.TransientFault:
                        led.record(_member_peer(m), ok=False)
                    except RuntimeError as e:
                        if not _is_hang(e):
                            raise
                        dead.add(m)
                    else:
                        led.record(_member_peer(m), ok=True)
            dead |= {m for m in self.view.members
                     if led.decide(_member_peer(m)) == "raise"}
        if self._multiproc and runtime.effective_config().watchdog != "off":
            from . import watchdog

            ld = watchdog.lease_dir()
            if ld is not None:
                dead |= {r for r in watchdog.dead_ranks(
                             ld, newer_than=self._lease_floor)
                         if r in self.view.members
                         and r not in self.local_ranks}
        details = self.board.join_details()
        for r, d in details.items():
            if r in self.view.members and \
                    int(d.get("incarnation", 0)) > self._inc.get(r, 0):
                dead.add(r)
        if dead:
            return ("shrink", sorted(dead))
        joins = [r for r in sorted(details)
                 if r not in self.view.members and r in self._slots
                 and self._joiner_alive(r)]
        if joins:
            return ("rejoin", joins)
        return None

    def _joiner_alive(self, rank: int) -> bool:
        """A join whose poster heartbeats is a waiting peer; one whose
        heartbeat went stale crashed after asking; one with no heartbeat
        is an operator's request and is trusted."""
        hb = self.board.heartbeats().get(int(rank))
        if hb is None:
            return True
        return time.time() - float(hb.get("ts", 0)) <= self.deadline_s

    def includes_self(self, ranks: Sequence[int]) -> bool:
        """Is THIS process among ``ranks``?  In a world of one process every
        member is local and a death is a peer's; a ``local=`` harness dies
        when any rank it speaks for does."""
        if self._multiproc:
            return self._rank in set(ranks)
        if self._local_subset:
            return bool(set(ranks) & set(self.local_ranks))
        return False

    # -- resize --------------------------------------------------------------

    def _reconcile(self, members: Sequence[int], *, step: int,
                   voters: Optional[Sequence[int]] = None
                   ) -> MembershipView:
        view = membership.reconcile(
            self.board, self.local_ranks, members,
            epoch=self.view.epoch + 1, step=step, voters=voters,
            quorum_of=self.view.members if self.quorum else None,
            deadline_s=self.deadline_s, poll_s=self.poll_s)
        self.stats["reconciles"] += 1
        _obs_record("reconcile", epoch=view.epoch,
                    members=len(view.members))
        self.view = view
        self._agree_round = 0
        if self._fence is not None:
            self._fence.update(view.epoch)
        return view

    def adopt(self, view: MembershipView) -> None:
        """Adopt a view committed without this rank's vote (the park
        loop's exit, or :func:`admit`'s grown view)."""
        self.view = view
        self._agree_round = 0
        self._hb_seen.clear()
        for r in self.local_ranks:
            self.board.clear_values(r)
            self.board.clear_votes_above(r, view.epoch)
        for m in view.members:
            self._inc[m] = self.board.incarnation(m)
        if self._fence is not None:
            self._fence.update(view.epoch,
                               incarnation=self._inc.get(self._rank, 0))

    def shrink(self, dead: Sequence[int], *, step: int):
        """Agree on the survivors-only view and re-form the world at N-k.
        Returns the new world communicator; the caller then recovers the
        state from the last checkpoint and rebuilds its step."""
        dead = sorted(set(int(m) for m in dead))
        survivors = [m for m in self.view.members if m not in dead]
        if not survivors:
            raise membership.MembershipError(
                f"every member died at step {step}: nothing to shrink to")
        faults = _faults_mod()
        if faults is not None:
            led = faults.ledger()
            for m in dead:
                for _ in range(led.dead_after):
                    led.record(_member_peer(m), ok=False)
        view = self._reconcile(survivors, step=step)
        self.stats["shrinks"] += 1
        _obs_record("shrink", epoch=view.epoch, members=len(view.members),
                    peer=",".join(_member_peer(m) for m in dead))
        return self.member_mesh()

    def grow(self, joiners: Sequence[int], *, step: int):
        """Admit healed members at a step boundary: the current members
        vote the grown view in (the joiner polls it through
        :func:`admit`), and the world re-forms at the larger size.  The
        caller checkpointed ``step`` first: the joiner restores it."""
        joiners = sorted(set(int(r) for r in joiners)
                         - set(self.view.members))
        voters = list(self.view.members)
        view = self._reconcile(sorted(set(voters) | set(joiners)),
                               step=step, voters=voters)
        faults = _faults_mod()
        for r in joiners:
            self.board.clear_join(r)
            self._inc[r] = self.board.incarnation(r)
            if faults is not None:
                faults.ledger().record(_member_peer(r), ok=True)
        self.stats["rejoins"] += 1
        _obs_record("rejoin", epoch=view.epoch, members=len(view.members),
                    peer=",".join(_member_peer(r) for r in joiners))
        return self.member_mesh()


def _seed_joiner_checkpoints(directory: str, step: int,
                             joiners: Sequence[int],
                             gang: ElasticGang) -> None:
    """Give each joiner its own checkpoint file of the rejoin boundary
    (JAX :641): recovery reads only a process's own files, and without
    this the joiner's newest predates its death.  The state is replicated
    (the ``build`` contract), so the lowest surviving member's file IS
    the joiner's, seeded through ``checkpoint.replicate_for``.  No-op in a
    world of one process (one process, one file)."""
    if not gang._multiproc or gang._rank != min(gang.view.members):
        return
    checkpoint.replicate_for(directory, step, [int(r) for r in joiners])


def _is_fenced(e: BaseException) -> bool:
    mod = sys.modules.get(_PKG + ".faults.fencing")
    return mod is not None and isinstance(e, mod.FencedWriterError)


def _park(gang: ElasticGang, directory: str, *, step: int,
          suspects: Sequence[int], cause: BaseException,
          budget_s: float) -> str:
    """The minority side of a quorum loss (JAX :673): a bounded,
    heartbeat-visible wait (board heartbeats at epoch -1, watchdog lease
    state ``parked``) that re-polls the board for an exit: ``"adopted"``
    (the majority committed a view that still holds this rank),
    ``"admitted"`` (it committed one without us: the healed-peer path in
    place) or ``"retry"`` (nobody committed and every suspect heartbeats
    again).  Exhausting ``budget_s`` re-raises ``cause``."""
    _obs_record("quorum_lost", epoch=gang.view.epoch,
                members=len(gang.view.members),
                peer=",".join(_member_peer(m) for m in suspects))
    _obs_record("parked", epoch=gang.view.epoch,
                members=len(gang.view.members))
    wd = sys.modules.get(_PKG + ".watchdog")
    if wd is not None and wd.active():
        wd.set_state("parked",
                     detail=f"waiting for a committed epoch > "
                            f"{gang.view.epoch}")
    t0 = time.monotonic()
    t_park = time.time()
    try:
        while True:
            for r in gang.local_ranks:
                gang.board.heartbeat(r, epoch=-1, step=step)
            committed = gang.board.committed_view()
            if committed is not None and \
                    committed.epoch > gang.view.epoch:
                if all(r in committed.members for r in gang.local_ranks):
                    gang.adopt(committed)
                    _obs_record("healed", epoch=committed.epoch,
                                members=len(committed.members))
                    return "adopted"
                if gang._multiproc or len(gang.local_ranks) == 1:
                    remaining = max(gang.poll_s,
                                    budget_s - (time.monotonic() - t0))
                    view = admit(directory, gang._rank,
                                 board_dir=gang.board.directory,
                                 deadline_s=remaining, poll_s=gang.poll_s)
                    gang.adopt(view)
                    _obs_record("healed", epoch=view.epoch,
                                members=len(view.members))
                    return "admitted"
                raise cause
            if suspects:
                hbs = gang.board.heartbeats()
                if all(float(hbs.get(m, {}).get("ts", 0)) > t_park
                       for m in suspects):
                    _obs_record("healed", epoch=gang.view.epoch,
                                members=len(gang.view.members))
                    gang._hb_seen.clear()
                    return "retry"
            if time.monotonic() - t0 > budget_s:
                raise cause
            time.sleep(gang.poll_s)
    finally:
        if wd is not None and wd.active():
            wd.set_state("running")


def _member_of_failure(e: BaseException) -> Optional[int]:
    """The gang member a ``PeerTimeoutError`` or watchdog hang names
    (``member:<rank>`` peer), if any."""
    mod = sys.modules.get(_PKG + ".faults.policy")
    timeoutish = (mod is not None
                  and isinstance(e, mod.PeerTimeoutError)) or _is_hang(e)
    if not timeoutish:
        return None
    peer = str(getattr(e, "peer", ""))
    if peer.startswith("member:") and peer[len("member:"):].isdigit():
        return int(peer[len("member:"):])
    return None


def run_elastic(build: BuildFn, *, steps: int, directory: str,
                save_every: int = 10, max_restarts: int = 3,
                members: Optional[Sequence[int]] = None,
                world_size: Optional[int] = None,
                gang: Optional[ElasticGang] = None,
                park_budget_s: Optional[float] = None
                ) -> Tuple[PyTree, Dict[str, Any]]:
    """Run ``steps`` steps elastically (JAX :779): the detect -> shrink ->
    rebalance -> rejoin loop over ``restart``'s checkpoint machinery.

    ``build(comm, view)`` returns ``(init_fn, step_fn)`` for one view
    (:data:`BuildFn`); it runs again after every membership change, which
    is where the re-partition happens.  Each segment recovers the newest
    verified checkpoint (a survivors-only agreement across processes),
    then steps, saving every ``save_every`` steps.  At each boundary the
    gang polls (:meth:`ElasticGang.poll`): a dead peer shrinks the gang
    and the segment restarts at N-1 from the last checkpoint; if THIS
    process is the dead member :class:`MemberDeath` raises out; a join
    request saves the boundary and grows the gang.  Other failures take
    the plain restore path within ``max_restarts``; a quorum loss parks
    (``park_budget_s``, default 10x the deadline).  Returns ``(state,
    info)``: ``shrinks`` / ``rejoins`` / ``reconciles`` / ``parks`` /
    ``restarts`` / ``restarts_used`` / ``recoveries`` (every step a
    recovery settled on, in order) / ``steps_run`` / ``recovered_step``
    and the final ``view``.  In a world of one process a run that ends
    with every row of its gang hands back the world ``init`` built
    (``runtime.restore_world``)."""
    cfg = _require_on()
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if gang is None:
        gang = ElasticGang(directory, members=members,
                           world_size=world_size)
    park_budget = (10.0 * cfg.elastic_deadline_s
                   if park_budget_s is None else float(park_budget_s))
    restarts = 0
    parks = 0
    steps_run = 0
    recovered_step = 0
    recoveries: List[int] = []
    comm = None  # carried from shrink() / grow(): one resize a change

    def quorum_park(e: BaseException, step: int,
                    suspects: Sequence[int]) -> str:
        nonlocal parks
        parks += 1
        if parks > max_restarts:
            raise e
        return _park(gang, directory, step=step, suspects=suspects,
                     cause=e, budget_s=park_budget)

    state = None
    while True:
        if comm is None:
            comm = gang.member_mesh()
        init_fn, step_fn = build(comm, gang.view)
        template = init_fn()
        state = None  # the old segment's state goes before the restore
        try:
            state, i = restart.recover(
                init_fn, directory, template,
                participants=gang.participants(),
                agree=gang.agreement())
        except membership.QuorumLost as e:
            if quorum_park(e, recovered_step, []) != "retry":
                comm = None
            continue
        recovered_step = i
        recoveries.append(i)
        resized = False
        while i < steps:
            try:
                ev = gang.poll(i)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not (isinstance(e, membership.QuorumLost)
                        or _is_fenced(e)):
                    raise
                if quorum_park(e, i, []) != "retry":
                    comm = None
                resized = True
                break
            if ev is not None:
                kind, ranks = ev
                if kind == "shrink":
                    if gang.includes_self(ranks):
                        raise MemberDeath(gang._rank, i)
                    try:
                        comm = gang.shrink(ranks, step=i)
                        _hotstate_note_shrink(ranks, i)
                    except membership.QuorumLost as e:
                        if quorum_park(e, i, ranks) != "retry":
                            comm = None
                else:
                    try:
                        checkpoint.save(directory, state, step=i)
                        _seed_joiner_checkpoints(directory, i, ranks, gang)
                        comm = gang.grow(ranks, step=i)
                    except BaseException as e:  # noqa: BLE001
                        if not (isinstance(e, membership.QuorumLost)
                                or _is_fenced(e)):
                            raise
                        if quorum_park(e, i, []) != "retry":
                            comm = None
                resized = True
                break
            try:
                state = step_fn(state, i)
                steps_run += 1
                i += 1
                # The hot tier streams every completed step (the disk tier
                # saves every ``save_every``): that gap is the replay the
                # RAM rung erases on recovery.
                _hotstate_publish(gang, state, i)
                if i % save_every == 0 or i == steps:
                    checkpoint.save(directory, state, step=i)
            except KeyboardInterrupt:
                raise
            except BaseException as e:  # noqa: BLE001 — the elastic loop
                # is the handler: shrink, restore, or re-raise.
                if isinstance(e, membership.QuorumLost) or _is_fenced(e):
                    if quorum_park(e, i, []) != "retry":
                        comm = None
                    resized = True
                    break
                member = _member_of_failure(e)
                if member is not None and member in gang.view.members:
                    if gang.includes_self([member]):
                        raise MemberDeath(member, i) from e
                    try:
                        comm = gang.shrink([member], step=i)
                        _hotstate_note_shrink([member], i)
                    except membership.QuorumLost as qe:
                        if quorum_park(qe, i, [member]) != "retry":
                            comm = None
                    resized = True
                    break
                restarts += 1
                if restarts > max_restarts:
                    raise
                # A plain restore: the view, the world, the step program
                # and every plan stay; recover in place.
                try:
                    state = None
                    state, i = restart.recover(
                        init_fn, directory, template,
                        participants=gang.participants(),
                        agree=gang.agreement())
                except membership.QuorumLost as qe:
                    if quorum_park(qe, i, []) != "retry":
                        comm = None
                    resized = True
                    break
                recovered_step = i
                recoveries.append(i)
        if not resized:
            if runtime.world_rows() is not None \
                    and set(gang.view.members) == gang._slots:
                # One process, the whole gang again: init's world back.
                runtime.restore_world()
            return state, {"shrinks": gang.stats["shrinks"],
                           "rejoins": gang.stats["rejoins"],
                           "reconciles": gang.stats["reconciles"],
                           "restarts": restarts,
                           "restarts_used": restarts,
                           "parks": parks,
                           "recoveries": list(recoveries),
                           "steps_run": steps_run,
                           "recovered_step": recovered_step,
                           "view": gang.view}


def admit(directory: str, rank: int, *,
          board_dir: Optional[str] = None,
          deadline_s: Optional[float] = None,
          poll_s: Optional[float] = None) -> MembershipView:
    """The healed peer's half of a rejoin (JAX :989): bump this rank's
    per-life incarnation on the board, post a join carrying it, and poll
    (heartbeating) until a view committed after this life's join and
    containing ``rank`` appears; ``view.step`` is the checkpoint step to
    restore, and the caller re-enters :func:`run_elastic` with the full
    member set.  Blocks up to ``deadline_s`` (default
    ``Config.elastic_deadline_s``).  This process's process world is
    stale from here on (the survivors left it): the next
    ``ElasticGang.member_mesh`` forms the admitting view's."""
    cfg = _require_on()
    board = membership.Board(
        board_dir or cfg.elastic_dir
        or os.path.join(directory, "membership"),
        reader_rank=int(rank))
    deadline_s = (cfg.elastic_deadline_s if deadline_s is None
                  else float(deadline_s))
    poll_s = cfg.elastic_poll_s if poll_s is None else float(poll_s)
    runtime.mark_world_stale()
    inc = board.bump_incarnation(rank)
    view = board.committed_view()
    min_epoch = (view.epoch + 1) if view is not None else 0
    board.request_join(rank, incarnation=inc)
    t0 = time.monotonic()
    while True:
        board.heartbeat(rank, epoch=-1, step=-1, incarnation=inc)
        view = board.committed_view()
        if view is not None and view.epoch >= min_epoch \
                and int(rank) in view.members:
            return view
        if time.monotonic() - t0 > deadline_s:
            raise membership.ReconcileTimeout(
                f"no committed view containing rank {rank} appeared "
                f"within {deadline_s:.3g}s")
        time.sleep(poll_s)


# ---------------------------------------------------------------------------
# Deterministic re-partition helpers (the "rebalance" of the loop)
# ---------------------------------------------------------------------------


def rebucket_ef_residuals(residuals, params_template, old_shape:
                          Tuple[int, int], *, axis_names=None,
                          n: Optional[int] = None,
                          n_buckets: Optional[int] = None,
                          device=None) -> list:
    """Re-bucket error-feedback residual state (JAX :1046;
    ``gradsync.init_dcn_residuals`` layout, [n_outer * n_inner, shard]
    float32 a bucket) for a resized grid.  The total outstanding error a
    flat position holds (the sum over the old outer axis, what the next
    EF step would add back) is summed out of the old layout, split again
    by the new grid's shard extents and spread evenly over the new outer
    axis, so the new outer sum reproduces it: no error mass is dropped.
    ``old_shape`` is the old ``(n_outer, n_inner)``; the new grid is the
    current world's (its rank-major stack of ``n``)."""
    import torch

    from . import fusion
    from .parallel import gradsync

    old_outer, old_inner = int(old_shape[0]), int(old_shape[1])
    outer_new, inner_new = runtime.grid(n)
    template = list(params_template)
    fresh = gradsync.init_dcn_residuals(
        template, axis_names, n=n, n_buckets=n_buckets, device=device)
    if n_buckets is None:
        n_buckets = runtime.effective_config().gradsync_buckets
    spec = fusion.FusedSpec(template, n_buckets=max(1, int(n_buckets)))
    extents = [hi - lo for g in spec.groups for (lo, hi) in g.bounds]
    if len(residuals) != len(fresh):
        raise ValueError(
            f"residual state has {len(residuals)} buckets, the template "
            f"derives {len(fresh)}: re-bucketing needs the same tree and "
            f"n_buckets the state was initialized with")
    out = []
    for old, new, ext in zip(residuals, fresh, extents):
        old = np.asarray(old.detach().cpu() if isinstance(old, torch.Tensor)
                         else old)
        if old.shape[0] != old_outer * old_inner:
            raise ValueError(
                f"residual rows {old.shape[0]} != old topology "
                f"{old_outer}x{old_inner}")
        total = old.reshape(old_outer, old_inner, -1).sum(axis=0)
        flat = total.reshape(-1)[:ext]
        shard_new = int(new.shape[-1])
        padded = np.zeros((inner_new * shard_new,), np.float32)
        padded[:ext] = flat
        per_slice = (padded.reshape(inner_new, shard_new)
                     / np.float32(outer_new))
        tiled = np.broadcast_to(per_slice,
                                (outer_new, inner_new, shard_new))
        out.append(torch.from_numpy(np.ascontiguousarray(
            tiled.reshape(tuple(new.shape))).astype(np.float32)).to(
                new.device))
    return out


def reshard_ps(params: PyTree, *, num_shards: int, old_ps=None):
    """Re-partition a sharded parameter server onto the surviving hosts
    (JAX :1116): shut the old one down (best-effort: a shard server may be
    what died) and start a fresh one over ``num_shards`` shards from the
    recovered ``params``; shard extents are a pure function of the tree
    and the shard count."""
    _require_on()
    from . import parameterserver

    if old_ps is not None:
        try:
            old_ps.shutdown()
        except Exception:  # noqa: BLE001 — the dead shard IS the reason
            pass
    return parameterserver.init(params, num_shards=int(num_shards))
