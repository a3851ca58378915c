"""Gang-membership epochs: a host-staged board and a bounded two-phase
reconcile (the JAX package's ``faults/membership.py``;
docs/ELASTIC_TORCH.md).

After a peer dies the survivors must all switch to the SAME new member
set at the SAME step, and a healed peer must be able to find the current
set without asking the gang that is re-forming.  Both go through a
**membership board**: a directory of small JSON files on the shared
checkpoint filesystem, the one transport still standing when the
device fabric's gang is what broke.  Every value is written to a
temporary file, fsync'd and renamed, so a reconcile survives the crash
of any participant at any point.  The files are the JAX package's
(names, keys and JSON), so either package reads a board the other wrote.

Protocol (``reconcile``): a **bounded two-phase commit** per epoch.

- *Propose.*  Every survivor writes ``propose_<epoch>_<rank>.json``
  naming the member set it believes in and the step boundary the view
  takes effect at, then polls until every voter's proposal is present
  and equal.
- *Commit.*  Once the proposals agree, each writes
  ``commit_<epoch>_<rank>.json``; the view is **committed** when every
  voter has committed it.  A healed peer reads the current view as the
  highest fully-committed epoch (commit files are never removed).
- *Bounded.*  A voter that posts nothing within the deadline is dropped
  and the round retries at ``epoch + 1``; disagreeing proposals resolve
  to the intersection and the smallest step, which every party computes
  from the same files.  At most ``len(members)`` rounds run.

Partitions: ``reconcile(quorum_of=...)`` commits only with a strict
majority of the last committed view (an even split goes to the side
holding its lowest rank; the minority raises :class:`QuorumLost`); an
armed fence (``faults/fencing.py``) refuses votes and heartbeats from a
writer whose epoch is behind the committed one; and a round in which
this rank's own payload is invisible is board trouble, retried at the
same epoch, not voter silence.  The ``board.read`` / ``board.write``
fault sites fire on every IO and a ``partition`` rule masks which
writers' files a reader sees, on the gang-step clock.

Dependency-free on purpose (no torch, no numpy): the board must be
readable by a peer whose runtime is what died, and by standalone
tooling.  Imported only by ``elastic.py`` and ``guard.py`` (each behind
its ``Config`` knob); the fault hooks go through ``sys.modules``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_FAULTS = __name__.rsplit(".", 1)[0]  # the port's faults package


class MembershipError(RuntimeError):
    """Base of the membership-protocol failures."""


class ReconcileDropped(MembershipError):
    """This rank was voted out of the membership during a reconcile (it
    stalled past the deadline and the survivors moved on without it).
    The correct response is the healed-peer path: finish dying, then
    :func:`torchmpi_tpu_torch.elastic.admit` back in at a step boundary."""


class ReconcileTimeout(MembershipError):
    """A bounded wait on the board expired without the protocol making
    progress (e.g. every other participant vanished mid-round)."""


class QuorumLost(MembershipError):
    """This side of a (possible) partition cannot commit: its voter set
    is not a majority of the last committed view's members — committing
    would risk a forked view.  Carries ``epoch`` (the epoch the commit
    was refused at), ``voters`` and ``quorum_of``.  The correct
    response is the elastic driver's PARK loop: keep heartbeating,
    re-poll the board, and rejoin the majority's committed epoch once
    the partition heals (docs/ELASTIC_TORCH.md)."""

    def __init__(self, *, epoch: int, voters: Sequence[int],
                 quorum_of: Sequence[int], msg: str = ""):
        self.epoch = int(epoch)
        self.voters = tuple(sorted(int(v) for v in voters))
        self.quorum_of = tuple(sorted(int(m) for m in quorum_of))
        need = len(self.quorum_of) // 2 + 1
        super().__init__(
            msg or f"quorum lost at epoch {epoch}: voters "
                   f"{list(self.voters)} are not a majority of the "
                   f"committed view's members {list(self.quorum_of)} "
                   f"(need {need}, or half containing rank "
                   f"{min(self.quorum_of) if self.quorum_of else '?'}) "
                   f"— parking instead of committing a forked view")


def has_quorum(voters: Iterable[int], quorum_of: Iterable[int]) -> bool:
    """The quorum rule (``Config.elastic_quorum="majority"``): may a
    side whose voter set is ``voters`` commit a view over the last
    committed membership ``quorum_of``?  Strict majority of
    ``quorum_of`` wins; an exact half wins only when it contains the
    LOWEST-ranked member of ``quorum_of`` — a deterministic tie-break
    every side computes identically from its own files (the prior
    members partition between the sides, so exactly one side can hold
    that rank)."""
    prior = sorted(set(int(m) for m in quorum_of))
    if not prior:
        return True  # nothing committed yet: nothing to fork from
    inter = set(prior) & {int(v) for v in voters}
    if 2 * len(inter) > len(prior):
        return True
    if 2 * len(inter) == len(prior):
        return min(prior) in inter
    return False


@dataclasses.dataclass(frozen=True)
class MembershipView:
    """One committed gang membership: ``epoch`` (monotonic view
    counter), ``members`` (sorted rank tuple), ``step`` (the step
    boundary the view took effect at — a healed peer restores the
    checkpoint of exactly this step)."""

    epoch: int
    members: Tuple[int, ...]
    step: int

    def to_json(self) -> dict:
        return {"epoch": int(self.epoch),
                "members": [int(m) for m in self.members],
                "step": int(self.step)}

    @staticmethod
    def from_json(d: dict) -> "MembershipView":
        return MembershipView(epoch=int(d["epoch"]),
                              members=tuple(sorted(int(m)
                                                   for m in d["members"])),
                              step=int(d["step"]))


def _owner_of(name: str) -> Optional[int]:
    """The rank that wrote a board file, parsed from its name (every
    per-rank file ends ``_<rank>.json``); None for shared records
    (``rewind_<round>.json`` — round numbers are not ranks, but those
    records are gang-wide anyway and a partition of them is
    meaningless, so an owner beyond the masked set is fine)."""
    stem = name[:-len(".json")] if name.endswith(".json") else name
    _, _, tail = stem.rpartition("_")
    if not tail.isdigit():
        return None
    if stem.startswith("rewind_"):
        return None  # the tail is a round number, not a rank
    return int(tail)


class Board:
    """The host-staged membership board: one directory of atomic JSON
    files.  All methods are crash-safe (write-tmp-then-rename) and
    idempotent; readers tolerate torn/missing files by ignoring them
    (an unreadable proposal is the same as an unposted one — the
    deadline handles both).

    ``reader_rank`` is the rank this process READS the board as — only
    consulted by the injected ``partition`` visibility mask (a masked
    writer's files are invisible to this reader, exactly as if the
    board filesystem were split); None disables masking for this
    handle (standalone tooling).  ``fence`` is the epoch fence the
    elastic driver attaches under ``elastic_quorum="majority"``
    (``faults/fencing.py``); vote and heartbeat writes check it.  The
    ``board.read``/``board.write`` fault sites fire on every IO when a
    plan is armed — an injected transient ``drop`` LOSES that IO (an
    unreadable listing, a write that never lands), which is what board
    trouble looks like to the protocol above."""

    def __init__(self, directory: str,
                 reader_rank: Optional[int] = None):
        self.directory = directory
        self.reader_rank = (None if reader_rank is None
                            else int(reader_rank))
        self.fence = None
        self._step = -1  # gang-step clock (note_step / heartbeat scan)
        self._clock_memo = (-1.0, -1)  # (monotonic ts, scanned clock)
        os.makedirs(directory, exist_ok=True)

    def note_step(self, step: int) -> None:
        """Advance the board's gang-step clock (the elastic driver
        calls this every step boundary) — the deterministic clock the
        partition mask's [after, heal_after) window is evaluated
        against."""
        self._step = max(self._step, int(step))

    # -- fault hooks (sys.modules — this module never imports faults) ----

    def _fire(self, site: str) -> bool:
        """One arrival at a board fault site; returns False when the
        IO is LOST (an injected transient — the board is briefly
        unreadable / the write never lands)."""
        mod = sys.modules.get(_FAULTS)
        if mod is None or not mod.injecting():
            return True
        try:
            mod.fire(site, peer="board")
        except Exception as e:  # noqa: BLE001 — classified, not blanket
            if getattr(e, "transient", False):
                return False
            raise
        return True

    def _mask(self):
        """The armed partition visibility mask, or None (one
        sys.modules lookup; the partition module itself only loads
        when a plan actually contains a partition rule)."""
        if self.reader_rank is None:
            return None
        mod = sys.modules.get(_FAULTS)
        if mod is None or not mod.injecting():
            return None
        return mod.board_partition()

    def _clock(self, fresh: bool = False) -> int:
        """The mask's step clock: this board's noted step, advanced by
        any step a member has heartbeated to the board — read RAW
        (never masked; the clock must be globally consistent so a
        parked minority still observes the heal when the majority's
        progress reaches it).  Every LISTING rescans (``_ls`` passes
        ``fresh=True``) and refreshes a memo the per-file ``_read``
        mask checks reuse — re-running the listdir-plus-parse scan for
        every file of an already-filtered listing made masked board
        scans O(N^2) (review).  The clock only ever advances, so a
        memoized value can delay observing a heal by one listing —
        never reorder it."""
        now = time.monotonic()
        memo_ts, memo_val = self._clock_memo
        if not fresh and now - memo_ts < 1.0:
            return max(memo_val, self._step)
        step = self._step
        try:
            names = os.listdir(self.directory)
        except OSError:
            return step
        for n in names:
            if not (n.startswith("hb_") and n.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, n)) as f:
                    step = max(step, int(json.load(f).get("step", -1)))
            except (OSError, ValueError):
                continue
        self._step = step
        self._clock_memo = (now, step)
        return step

    # -- low-level staged IO ---------------------------------------------

    def _write(self, name: str, payload: dict) -> None:
        if not self._fire("board.write"):
            return  # injected: the write is lost before it lands
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _read(self, name: str) -> Optional[dict]:
        if not self._fire("board.read"):
            return None  # injected: the board is briefly unreadable
        mask = self._mask()
        if mask is not None:
            owner = _owner_of(name)
            if owner is not None and mask.masked(
                    self.reader_rank, owner, self._clock()):
                return None  # partitioned away from this reader
        try:
            with open(os.path.join(self.directory, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _ls(self, prefix: str) -> List[str]:
        if not self._fire("board.read"):
            return []  # injected: the listing is briefly unreadable
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith(prefix)
                           and n.endswith(".json"))
        except OSError:
            return []
        mask = self._mask()
        if mask is not None:
            clock = self._clock(fresh=True)  # once per listing;
            #                                  _read reuses the memo
            kept = []
            for n in names:
                owner = _owner_of(n)
                if owner is None or not mask.masked(
                        self.reader_rank, owner, clock):
                    kept.append(n)
            names = kept
        return names

    # -- heartbeats (the real-detection seam) ------------------------------

    def heartbeat(self, rank: int, *, epoch: int, step: int,
                  incarnation: Optional[int] = None) -> None:
        """Record liveness: ``(epoch, step, wall ts)``.  A monitor (or a
        fellow member) that sees a heartbeat stop advancing has the
        same staleness signal ``examples/downpour_elastic.py``'s
        monitor thread reads from its progress counters.  A waiting
        joiner's heartbeat also carries its per-life ``incarnation``
        (``elastic.admit``), so the gang can tell which life is
        knocking."""
        if self.fence is not None:
            # Epoch fencing (faults/fencing.py): a heartbeat CLAIMING a
            # view epoch the board committed past is a zombie's — it
            # must not land.  epoch < 0 (a waiting joiner's / parked
            # rank's beacon) claims nothing and is exempt.
            self.fence.check(epoch, what=f"heartbeat rank {int(rank)}")
        payload = {"rank": int(rank), "epoch": int(epoch),
                   "step": int(step), "ts": time.time()}
        if incarnation is not None:
            payload["incarnation"] = int(incarnation)
        self._write(f"hb_{int(rank)}.json", payload)

    def heartbeats(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for name in self._ls("hb_"):
            d = self._read(name)
            if d is not None:
                out[int(d.get("rank", -1))] = d
        return out

    # -- per-life incarnation ids (docs/ELASTIC_TORCH.md) -------------------------
    #
    # Each call of ``elastic.admit`` bumps the rank's incarnation before
    # posting its join, so a join request distinguishes "the life the
    # gang already admitted" from "a NEW life of a rank whose previous
    # death has not been committed yet" — the stale-view-admission
    # ambiguity the pre-incarnation board could not resolve.

    def incarnation(self, rank: int) -> int:
        d = self._read(f"inc_{int(rank)}.json")
        return int(d.get("incarnation", 0)) if d is not None else 0

    def bump_incarnation(self, rank: int) -> int:
        n = self.incarnation(rank) + 1
        self._write(f"inc_{int(rank)}.json",
                    {"rank": int(rank), "incarnation": n,
                     "ts": time.time()})
        return n

    # -- join requests (healed peers) --------------------------------------

    def request_join(self, rank: int,
                     incarnation: Optional[int] = None) -> None:
        payload = {"rank": int(rank), "ts": time.time()}
        if incarnation is not None:
            payload["incarnation"] = int(incarnation)
        self._write(f"join_{int(rank)}.json", payload)

    def join_requests(self) -> List[int]:
        return sorted(self.join_details())

    def join_details(self) -> Dict[int, dict]:
        """Join requests with their payloads (incarnation, timestamp) —
        what :meth:`~torchmpi_tpu_torch.elastic.ElasticGang.poll` reads to
        tell a healed joiner from a twice-dead rank's new life."""
        out: Dict[int, dict] = {}
        for name in self._ls("join_"):
            d = self._read(name)
            if d is not None:
                out[int(d["rank"])] = d
        return out

    def clear_join(self, rank: int) -> None:
        try:
            os.remove(os.path.join(self.directory,
                                   f"join_{int(rank)}.json"))
        except OSError:
            pass

    # -- rewind records (torchmpi_tpu_torch.guard — docs/GUARD_TORCH.md) ---------------
    #
    # The anomaly-rewind driver runs its agreement over this same board
    # (the transport that is still standing when the step loop's
    # numerics are exactly what broke): a tripped rank posts a rewind
    # request, every rank joins the bounded two-phase verdict
    # (guard.agree_rewind over post_value/values), and the committed
    # outcome is recorded as a ``rewind_<round>.json`` record — the
    # post-mortem row naming the step, the detection evidence, and any
    # quarantined peer.  No membership/epoch state changes: a rewind
    # restores a checkpoint in place, views and plans untouched.

    def request_rewind(self, rank: int, *, step: int,
                       stat: float = 0.0) -> None:
        """A tripped rank's signal: makes the per-step board poll of the
        untripped ranks cheap (one listdir) without them having to
        enter the agreement every step."""
        self._write(f"rewreq_{int(rank)}.json",
                    {"rank": int(rank), "step": int(step),
                     "stat": float(stat), "ts": time.time()})

    def rewind_requests(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for name in self._ls("rewreq_"):
            d = self._read(name)
            if d is not None:
                out[int(d.get("rank", -1))] = d
        return out

    def clear_rewind_request(self, rank: int) -> None:
        try:
            os.remove(os.path.join(self.directory,
                                   f"rewreq_{int(rank)}.json"))
        except OSError:
            pass

    def post_rewind_record(self, round_no: int, payload: dict) -> None:
        self._write(f"rewind_{int(round_no)}.json",
                    dict(payload, round=int(round_no), ts=time.time()))

    def rewind_records(self) -> List[dict]:
        out = []
        for name in self._ls("rewind_"):
            d = self._read(name)
            if d is not None:
                out.append(d)
        return sorted(out, key=lambda d: int(d.get("round", 0)))

    # -- two-phase state ---------------------------------------------------
    #
    # Payloads carry ``voters`` — the ranks whose agreement commits the
    # view — separately from ``members``: at a shrink they are the same
    # set (the survivors), but at an admission the deciding voters are
    # the PRE-grow members, so a healed joiner appears in ``members``
    # without having to vote in the reconcile that admits it.

    def _vote(self, phase: str, epoch: int, rank: int,
              members: Sequence[int], voters: Sequence[int],
              step: int) -> None:
        if self.fence is not None:
            # A vote AT or ABOVE the committed epoch is legitimate
            # protocol progress; one BELOW it is a zombie's stale
            # reconcile and never lands (faults/fencing.py).
            self.fence.check(epoch, what=f"{phase} rank {int(rank)}")
        self._write(f"{phase}_{int(epoch)}_{int(rank)}.json",
                    {"epoch": int(epoch),
                     "members": sorted(int(m) for m in members),
                     "voters": sorted(int(v) for v in voters),
                     "step": int(step)})

    def propose(self, epoch: int, rank: int, members: Sequence[int],
                step: int, voters: Optional[Sequence[int]] = None) -> None:
        self._vote("propose", epoch, rank, members,
                   members if voters is None else voters, step)

    def commit(self, epoch: int, rank: int, members: Sequence[int],
               step: int, voters: Optional[Sequence[int]] = None) -> None:
        self._vote("commit", epoch, rank, members,
                   members if voters is None else voters, step)

    def _votes(self, phase: str, epoch: int) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for name in self._ls(f"{phase}_{int(epoch)}_"):
            d = self._read(name)
            if d is None or "members" not in d:
                continue
            rank = int(name[:-len(".json")].split("_")[-1])
            out[rank] = d
        return out

    def proposals(self, epoch: int) -> Dict[int, dict]:
        return self._votes("propose", epoch)

    def commits(self, epoch: int) -> Dict[int, dict]:
        return self._votes("commit", epoch)

    def committed_view(self) -> Optional[MembershipView]:
        """The highest fully-committed view: every VOTER named in a
        commit payload has itself committed an equal payload for that
        epoch.  None before the first reconcile completes."""
        epochs = set()
        for name in self._ls("commit_"):
            try:
                epochs.add(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        for e in sorted(epochs, reverse=True):
            commits = self.commits(e)
            for d in commits.values():
                voters = [int(v) for v in d.get("voters", d["members"])]
                if voters and all(
                        v in commits and _payload_key(commits[v])
                        == _payload_key(d) for v in voters):
                    return MembershipView.from_json(d)
        return None

    # -- generic bounded min-agreement (recovery-step votes) ---------------

    def post_value(self, tag: str, rank: int, value: int) -> None:
        self._write(f"agree_{tag}_{int(rank)}.json",
                    {"rank": int(rank), "value": int(value)})

    def clear_values(self, rank: int) -> None:
        """Drop every agreement value THIS rank ever posted — called at
        gang construction so a full-gang crash-restart reusing the same
        board cannot hand a peer this rank's previous life's value
        under a re-used tag."""
        suffix = f"_{int(rank)}.json"
        for name in self._ls("agree_"):
            if name.endswith(suffix):
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    def clear_votes_above(self, rank: int, epoch: int) -> None:
        """Drop THIS rank's propose/commit files ABOVE ``epoch`` — a
        previous incarnation's aborted reconcile rounds must not poison
        the next reconcile at the same epochs (committed history at or
        below ``epoch`` stays: ``committed_view`` reads it)."""
        suffix = f"_{int(rank)}.json"
        for phase in ("propose_", "commit_"):
            for name in self._ls(phase):
                if not name.endswith(suffix):
                    continue
                try:
                    e = int(name.split("_")[1])
                except (IndexError, ValueError):
                    continue
                if e > int(epoch):
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except OSError:
                        pass

    def values(self, tag: str) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for name in self._ls(f"agree_{tag}_"):
            d = self._read(name)
            if d is not None:
                out[int(d["rank"])] = int(d["value"])
        return out


def _payload_key(d: dict) -> Tuple:
    return (tuple(sorted(int(m) for m in d["members"])),
            tuple(sorted(int(v) for v in d.get("voters", d["members"]))),
            int(d.get("step", 0)))


_BOARD_RETRIES = 3  # same-epoch retries when the board ITSELF is
#                     unreadable (this rank's own payload missing)


def reconcile(board: Board, local_ranks: Iterable[int],
              members: Iterable[int], *, epoch: int, step: int,
              voters: Optional[Iterable[int]] = None,
              quorum_of: Optional[Iterable[int]] = None,
              deadline_s: float = 30.0, poll_s: float = 0.05,
              ) -> MembershipView:
    """Run the bounded two-phase reconcile for ``local_ranks`` (the
    ranks THIS process speaks for — its own rank in a multi-process
    gang; every simulated member on the single-process CPU sim) until a
    view commits, and return it.

    ``members`` is the set this process proposes (survivors after a
    death; survivors plus the joiner at an admission); ``voters`` the
    subset whose agreement commits it (defaults to ``members``; at an
    admission it is the PRE-grow members, so the healed joiner need not
    vote in the reconcile that admits it); ``epoch`` the epoch to
    propose at (one above the current view).  See the module docstring
    for the drop/intersect retry semantics.  Raises
    :class:`ReconcileDropped` if every local rank was voted out, and
    :class:`ReconcileTimeout` if the voter set would shrink to empty.

    ``quorum_of`` (``Config.elastic_quorum="majority"``) is the LAST
    COMMITTED view's member set: every round's voter set must pass
    :func:`has_quorum` against it BEFORE anything commits — a side
    whose voters fell to a minority (a partition, not deaths) raises
    the typed :class:`QuorumLost` instead of forking the view.  The
    check runs at each round's entry, which covers every commit: a
    round that shrinks its voters (deadline) or resolves differing
    proposals re-enters the loop before committing."""
    members = sorted(set(int(m) for m in members))
    voters = (sorted(set(int(v) for v in voters))
              if voters is not None else list(members))
    if not set(voters) <= set(members):
        raise ValueError(
            f"voters {voters} must be a subset of members {members}")
    local = sorted(set(int(r) for r in local_ranks))
    quorum = (sorted(set(int(m) for m in quorum_of))
              if quorum_of is not None else None)
    e = int(epoch)
    step = int(step)
    while True:
        if not voters:
            raise ReconcileTimeout(
                "reconcile ran out of voters — every participant "
                "stalled past the deadline")
        if quorum is not None and not has_quorum(voters, quorum):
            raise QuorumLost(epoch=e, voters=voters, quorum_of=quorum)
        speak = [r for r in local if r in voters]
        if not speak:
            raise ReconcileDropped(
                f"ranks {local} were dropped from the membership "
                f"(survivors moved on to {members} at epoch {e})")

        def _phase(read, repost) -> Tuple[List[int], List[int], int,
                                          bool]:
            """Poll one phase until every voter's payload is present
            and equal; returns ``(members, voters, step, settled)``.
            Not settled means EVERY participant retries one epoch up
            with the returned resolution — even one whose own payload
            already matched it (committing while others move up would
            fork the view): stalled voters are dropped past the
            deadline; concurrently-differing proposals resolve to the
            member/voter INTERSECTION and the MIN step — all computed
            identically by every party from the same files, and the
            min step is the safe one: every proposer can restore a
            checkpoint at or before its own proposed boundary.

            Board trouble is NOT voter silence: a deadline at which
            even this rank's OWN payload is invisible — it posted one,
            so the board is unreadable or the write was lost — REPOSTS
            and retries the SAME epoch (bounded by _BOARD_RETRIES)
            instead of "dropping" voters that never got a chance to be
            seen; exhausted retries raise ReconcileTimeout naming the
            board, not the voters."""
            t0 = time.monotonic()
            board_tries = 0
            while True:
                got = read(e)
                if all(v in got for v in voters):
                    keys = {_payload_key(got[v]) for v in voters}
                    if len(keys) == 1:
                        return members, voters, step, True
                    inter = set(members)
                    for mset, _, _ in keys:
                        inter &= set(mset)
                    vinter = set(voters)
                    for _, vset, _ in keys:
                        vinter &= set(vset)
                    return (sorted(inter),
                            sorted(v for v in vinter if v in inter),
                            min(s for _, _, s in keys), False)
                if time.monotonic() - t0 > deadline_s:
                    if not any(r in got for r in speak):
                        board_tries += 1
                        if board_tries > _BOARD_RETRIES:
                            raise ReconcileTimeout(
                                f"membership board unreadable at epoch "
                                f"{e}: this rank's own payload is still "
                                f"missing after {board_tries} "
                                f"deadline(s) — board trouble, not "
                                f"voter silence (no voter was dropped)")
                        repost()
                        t0 = time.monotonic()
                        continue
                    alive = [v for v in voters if v in got]
                    return ([m for m in members
                             if m in alive or m not in voters], alive,
                            step, False)
                time.sleep(poll_s)

        def _post(phase_fn):
            for r in speak:
                phase_fn(e, r, members, step, voters)

        _post(board.propose)
        members, voters, step, settled = _phase(
            board.proposals, lambda: _post(board.propose))
        if not settled:
            e += 1
            continue
        _post(board.commit)
        members, voters, step, settled = _phase(
            board.commits, lambda: _post(board.commit))
        if not settled:
            e += 1
            continue
        return MembershipView(epoch=e, members=tuple(members),
                              step=int(step))


def agree_min(board: Board, tag: str, local_ranks: Iterable[int],
              members: Iterable[int], value: int, *,
              deadline_s: float = 30.0, poll_s: float = 0.05) -> int:
    """Bounded cross-member MIN of an int over the board — the
    survivors-only analog of ``checkpoint.agree_min_step`` (which runs
    over the full gang and therefore hangs forever once a member is
    dead).  ``tag`` must be unique per agreement round (the elastic
    driver derives it from (epoch, round))."""
    members = sorted(set(int(m) for m in members))
    for r in set(int(r) for r in local_ranks):
        if r in members:
            board.post_value(tag, r, value)
    t0 = time.monotonic()
    while True:
        got = board.values(tag)
        if all(m in got for m in members):
            return min(got[m] for m in members)
        if time.monotonic() - t0 > deadline_s:
            missing = [m for m in members if m not in got]
            raise ReconcileTimeout(
                f"agreement {tag!r}: members {missing} posted no value "
                f"within {deadline_s:.3g}s")
        time.sleep(poll_s)


def wait_for_view(board: Board, *, containing: Optional[int] = None,
                  min_epoch: int = 0, deadline_s: float = 30.0,
                  poll_s: float = 0.05) -> MembershipView:
    """Poll the board for a committed view (optionally one containing
    rank ``containing`` at epoch >= ``min_epoch``) — the healed peer's
    half of :func:`torchmpi_tpu_torch.elastic.admit`."""
    t0 = time.monotonic()
    while True:
        view = board.committed_view()
        if view is not None and view.epoch >= min_epoch and (
                containing is None or containing in view.members):
            return view
        if time.monotonic() - t0 > deadline_s:
            want = ("" if containing is None
                    else f" containing rank {containing}")
            raise ReconcileTimeout(
                f"no committed view{want} appeared within "
                f"{deadline_s:.3g}s")
        time.sleep(poll_s)
