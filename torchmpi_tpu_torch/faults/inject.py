"""Deterministic fault plans: versioned JSON, seed+site-keyed schedules.

The port's copy of the JAX package's ``faults/inject.py`` (the port
imports nothing of that package): the injection half of
``torchmpi_tpu_torch.faults`` (docs/FAULTS_TORCH.md).  A plan is a list
of rules, each naming a *site*, one of the dispatch points the library
instruments (``SITES``, all fifteen of the JAX package's, so one plan
file is valid for both packages), and a fault *kind*.  Whether the k-th
arrival at a site fires is a pure function of ``(plan.seed, site, k)``
(:func:`decision`): two runs, or two processes, that load the same plan
inject the same faults at the same per-site arrival counts.

A corrupt or mismatched plan RAISES: a chaos plan that silently loads
empty makes a chaos run silently test nothing.

Kinds: ``delay`` (sleep ``delay_s``), ``drop`` (optional ``delay_s`` of
peer silence, then :class:`DroppedPacket`: transient and
timeout-flavored), ``corrupt`` (flip bits in the site's payload, then
:class:`CorruptPayload`: transient, so a bounded ``max_hits`` makes it
corrupt-then-heal), ``corrupt_silent`` (flip bits, raise nothing;
payload sites only), ``fail`` (:class:`InjectedFailure`: a hard peer
death, never retried), ``torn`` (``ckpt.write`` only), ``stall`` (an
indefinite hold that raises nothing; the watchdog breaks it) and
``partition`` (a standing visibility mask of the membership board, read
by ``faults.board_partition()``; ``partition.py``).  The port fires the
``host_staged.*``, ``runtime.barrier``, ``ps.*``, ``aio.submit``,
``serving.*`` and ``ckpt.*`` sites; the ``board.*``, ``elastic.member``
and ``hotstate.*`` sites wait for their modules (ROADMAP A10 (c)) and are
listed here so that plans and lint agree across the packages.

Dependency-free on purpose (no torch, no numpy at import): the chaos
tool (``faults/tool.py``) and the dump path of a dying process load it.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import json
import threading
from typing import Dict, List, Optional, Tuple

FAULT_PLAN_VERSION = 1

# The instrumented dispatch points.  Rules may glob (``host_staged.*``);
# chaos_tool lint flags patterns that match none of these.
SITES = (
    "host_staged.gather",   # eager staged path: devices -> host leg
    "host_staged.scatter",  # eager staged path: host -> devices leg
    "runtime.barrier",      # the DCN barrier
    "ps.request",           # parameter-server client enqueue leg
    "ps.response",          # parameter-server client wait leg
    "aio.submit",           # async host-IO submission
    "serving.replica",      # one replica decode step in the continuous-
    #                         batching server (serving/):
    #                         drop = transient step failure (health
    #                         ledger counts it), fail = the replica dies
    #                         and its sessions drain + re-route
    "serving.admit",        # one arrival at the serving admission gate
    #                         (scheduler._gate, peer = the request id):
    #                         ANY fault verdict at the door is a SHED —
    #                         the request completes immediately with a
    #                         typed rejection, exactly the SLO
    #                         backpressure path (drop = a lost
    #                         admission RPC, fail = the gate refusing).
    #                         Payload-free: there is nothing to corrupt
    #                         at the door
    "elastic.member",       # one member liveness check per step
    #                         boundary in the elastic gang driver
    #                         (torchmpi_tpu/elastic.py): arrival
    #                         ordinal = step * n_members + member
    #                         index, so `fail` with after=k kills a
    #                         SPECIFIC rank at a SPECIFIC step
    #                         (chaos_tool gen --shrink computes k);
    #                         drop = a missed heartbeat the health
    #                         ledger escalates healthy->suspect->dead
    "ckpt.write",           # one checkpoint-file commit (npz or
    #                         metadata json, primaries and buddy
    #                         mirrors alike — utils/checkpoint.py /
    #                         utils/durable.py, docs/CHECKPOINT.md):
    #                         corrupt_silent = bit-rot between
    #                         serialize and fsync, `torn` = a
    #                         truncated-prefix .tmp artifact + crash
    #                         (the mid-save kill), `fail` = an
    #                         ENOSPC-flavored OSError
    "ckpt.read",            # one checkpoint npz read (restore /
    #                         restore_sharded / buddy-repair source):
    #                         corrupt_silent = on-disk bit-rot the
    #                         digest verify must catch, `fail` = an
    #                         EIO-flavored dead disk
    "board.write",          # one membership-board file commit
    #                         (faults/membership.py, docs/ELASTIC.md):
    #                         heartbeats, proposals, commits, joins —
    #                         `drop` loses the write (the file never
    #                         lands), `delay`/`stall` model a slow or
    #                         wedged board filesystem, and `partition`
    #                         rules key their visibility mask here
    "board.read",           # one membership-board listing/file read:
    #                         `drop` = the board is briefly unreadable
    #                         (the reconcile must retry the SAME epoch,
    #                         not vote everyone out), `partition` masks
    #                         which writers this reader can see
    "hotstate.send",        # one hot-state replica shipped to a buddy's
    #                         RAM (torchmpi_tpu/hotstate/,
    #                         docs/HOTSTATE.md): `drop` loses the
    #                         stream message (the chain self-heals at
    #                         the next full snapshot), `corrupt_silent`
    #                         flips bits in the staged delta payload
    #                         before it leaves the sender, `stall`
    #                         models a wedged transport the watchdog
    #                         must flag
    "hotstate.recv",        # the buddy-side receipt of one replica:
    #                         `corrupt_silent` = a bit-flipped RAM
    #                         buffer the digest verify must catch at
    #                         restore time (the ladder falls to the
    #                         disk rung instead of restoring poisoned
    #                         state), `drop` = the receiver missed the
    #                         message, `fail` = the buddy is gone
)

KINDS = ("delay", "drop", "corrupt", "corrupt_silent", "fail", "torn",
         "stall", "partition")

# Sites a ``partition`` rule may target: the membership board is the
# only surface with per-rank file ownership to mask.
BOARD_SITES = ("board.read", "board.write")

# Sites whose ``fire()`` call passes a real writable payload buffer —
# the only sites where a ``corrupt``/``corrupt_silent`` rule can flip
# bits (and where the wire-integrity guard has something to digest).
PAYLOAD_SITES = (
    "host_staged.gather",
    "host_staged.scatter",
    "ps.request",
    "ckpt.write",
    "ckpt.read",
    "hotstate.send",
    "hotstate.recv",
)


class FaultError(RuntimeError):
    """Base of every injected fault."""

    transient = False
    is_timeout = False


class TransientFault(FaultError):
    """Injected fault a retry can survive (the policy layer's cue)."""

    transient = True


class DroppedPacket(TransientFault):
    """A dropped packet: the peer went silent and a timeout fired.
    Timeout-flavored, so exhausting retries on it converts to
    ``PeerTimeoutError`` rather than a bare retries-exhausted error."""

    is_timeout = True


class CorruptPayload(TransientFault):
    """Payload failed its integrity check (bits were really flipped when
    the site carries a buffer — a caller that swallows this error sees
    the corruption)."""


class InjectedFailure(FaultError):
    """Hard failure: the peer is gone.  Never retried."""


class TornWrite(InjectedFailure):
    """A crash mid-checkpoint-write (``torn`` kind, ``ckpt.write``
    only): the site wrapper leaves a truncated ``.tmp`` artifact and
    raises this.  Hard — the writing process is modeled as dead."""


@dataclasses.dataclass
class FaultRule:
    """One scheduled fault at one site (pattern)."""

    site: str                 # exact site name or fnmatch glob
    kind: str                 # delay | drop | corrupt | fail
    prob: float = 1.0         # per-hit firing probability
    after: int = 0            # skip the first ``after`` arrivals
    #                           (partition: the START step of the mask)
    max_hits: int = 1         # fire at most this many times (0 = never,
    #                           -1 = unbounded) — the "heal" knob
    delay_s: float = 0.0      # sleep for delay/drop kinds
    ranks: str = ""           # partition only: the visibility split —
    #                           "2,3" (those vs the rest), "0,1|2,3"
    #                           (explicit symmetric groups), "~2,3"
    #                           (one-way: those ranks go deaf)
    heal_after: int = -1      # partition only: the step the mask lifts
    #                           at (-1 = never heals)

    def validate(self) -> None:
        if not self.site or not isinstance(self.site, str):
            raise ValueError(f"rule has no site: {self!r}")
        if self.kind not in KINDS:
            raise ValueError(
                f"rule kind {self.kind!r} not one of {KINDS}")
        if not (0.0 <= float(self.prob) <= 1.0):
            raise ValueError(f"rule prob {self.prob!r} outside [0, 1]")
        if int(self.after) < 0:
            raise ValueError(f"rule after {self.after!r} must be >= 0")
        if int(self.max_hits) < -1:
            raise ValueError(
                f"rule max_hits {self.max_hits!r} must be >= -1")
        if float(self.delay_s) < 0:
            raise ValueError(f"rule delay_s {self.delay_s!r} must be >= 0")
        if int(self.heal_after) < -1:
            raise ValueError(
                f"rule heal_after {self.heal_after!r} must be >= -1")
        if self.kind == "partition":
            if not str(self.ranks).strip():
                raise ValueError(
                    f"partition rule needs a ranks split: {self!r}")
            parse_partition_ranks(self.ranks)  # raises on bad grammar
            if 0 <= int(self.heal_after) <= int(self.after):
                raise ValueError(
                    f"partition heal_after {self.heal_after} must be "
                    f"> after {self.after} (or -1 = never heals)")
        elif str(self.ranks).strip():
            raise ValueError(
                f"rule ranks {self.ranks!r} is only meaningful on "
                f"kind 'partition'")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        # The partition-only fields are omitted at their defaults so a
        # pre-partition plan round-trips byte-identically (and readers
        # of older dumps never meet fields they cannot hold).
        if not d.get("ranks"):
            d.pop("ranks", None)
        if d.get("heal_after", -1) == -1:
            d.pop("heal_after", None)
        return d

    @staticmethod
    def from_json(d: dict) -> "FaultRule":
        if not isinstance(d, dict):
            raise ValueError(f"fault rule is not an object: {d!r}")
        fields = {f.name for f in dataclasses.fields(FaultRule)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"fault rule has unknown fields {unknown}")
        rule = FaultRule(**d)
        rule.validate()
        return rule


def parse_partition_ranks(spec: str):
    """Parse a partition rule's ``ranks`` grammar into
    ``(groups, one_way)``: ``groups`` is a list of disjoint rank sets,
    ``one_way`` True for the ``~`` (deaf-ranks) form.  Grammar:
    ``"2,3"`` (one group vs. the implicit rest), ``"0,1|2,3"``
    (explicit symmetric groups), ``"~2,3"`` (one-way: the named ranks
    cannot READ anyone else's files; their writes stay visible — the
    asymmetric A-sees-B, B-doesn't-see-A case).  Raises ValueError on
    anything else."""
    s = str(spec).strip()
    one_way = s.startswith("~")
    if one_way:
        s = s[1:]
    groups = []
    seen: set = set()
    for part in s.split("|"):
        try:
            g = frozenset(int(r) for r in part.split(",") if r.strip())
        except ValueError:
            raise ValueError(
                f"partition ranks {spec!r}: want RANK[,RANK...] groups "
                f"separated by '|' (optional leading '~' for one-way)"
            ) from None
        if not g:
            raise ValueError(f"partition ranks {spec!r}: empty group")
        if g & seen:
            raise ValueError(
                f"partition ranks {spec!r}: rank in two groups")
        if any(r < 0 for r in g):
            raise ValueError(
                f"partition ranks {spec!r}: ranks must be >= 0")
        seen |= g
        groups.append(g)
    if one_way and len(groups) != 1:
        raise ValueError(
            f"partition ranks {spec!r}: the one-way '~' form takes "
            f"exactly one group (the deaf ranks)")
    return groups, one_way


def decision(seed: int, site: str, hit: int) -> float:
    """Uniform [0, 1) draw for the ``hit``-th arrival at ``site`` — a
    pure hash of (seed, site, hit), the whole determinism story."""
    h = hashlib.blake2b(f"{seed}:{site}:{hit}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


@dataclasses.dataclass
class FaultPlan:
    """A versioned, seeded rule set plus the per-site hit counters that
    realize its deterministic schedule."""

    seed: int = 0
    rules: List[FaultRule] = dataclasses.field(default_factory=list)
    note: str = ""

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}   # arrivals per site
        self._fired: Dict[int, int] = {}  # fires per rule index —
        # max_hits bounds a RULE's total fires across every site its
        # pattern matches, not per site (a glob rule with max_hits=2
        # firing 2x per matched site would silently exceed the retry
        # budget the plan was written against)

    # -- schedule --------------------------------------------------------

    def arrivals(self, site: str) -> int:
        return self._hits.get(site, 0)

    def decide(self, site: str) -> Optional[Tuple[FaultRule, int]]:
        """Register one arrival at ``site``; return ``(rule, arrival)``
        for the rule that fires on it, if any (first matching rule
        wins).  Deterministic in the per-site arrival ordinal — which is
        why the ordinal is returned from under the lock: a caller
        re-reading the counter afterwards would race other threads'
        arrivals and report (or corrupt with) the wrong ordinal."""
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            for i, rule in enumerate(self.rules):
                if rule.kind == "partition":
                    continue  # a standing mask, not an arrival-fired
                    #           fault (faults.board_partition serves it)
                if not fnmatch.fnmatchcase(site, rule.site):
                    continue
                if hit < rule.after:
                    continue
                fired = self._fired.get(i, 0)
                if rule.max_hits >= 0 and fired >= rule.max_hits:
                    continue
                if decision(self.seed, site, hit) >= rule.prob:
                    continue
                self._fired[i] = fired + 1
                return rule, hit
            return None

    def reset_schedule(self) -> None:
        """Forget arrival/fire counters (a fresh run of the same plan)."""
        with self._lock:
            self._hits.clear()
            self._fired.clear()

    # -- persistence -----------------------------------------------------

    def to_json(self) -> dict:
        return {"version": FAULT_PLAN_VERSION, "seed": int(self.seed),
                "note": self.note,
                "rules": [r.to_json() for r in self.rules]}

    @staticmethod
    def from_json(data: dict) -> "FaultPlan":
        if not isinstance(data, dict):
            raise ValueError("fault plan is not a JSON object")
        if data.get("version") != FAULT_PLAN_VERSION:
            raise ValueError(
                f"fault plan version {data.get('version')!r} != "
                f"{FAULT_PLAN_VERSION}")
        rules = data.get("rules")
        if not isinstance(rules, list):
            raise ValueError("fault plan has no rules list")
        return FaultPlan(
            seed=int(data.get("seed", 0)),
            note=str(data.get("note", "")),
            rules=[FaultRule.from_json(r) for r in rules])

    @staticmethod
    def load(path: str) -> "FaultPlan":
        """Parse ``path``; raises (OSError/ValueError) on anything wrong
        — see the module docstring for why this is NOT never-crash."""
        with open(path) as f:
            try:
                data = json.load(f)
            except ValueError as e:
                raise ValueError(f"{path}: not JSON ({e})") from None
        try:
            return FaultPlan.from_json(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


def lint_plan(plan: FaultPlan) -> List[str]:
    """Problems a schema-valid plan can still have (chaos_tool lint):
    site patterns that match no instrumented site, rules shadowed into
    dead code, corrupt rules on payload-free sites."""
    problems: List[str] = []
    for i, rule in enumerate(plan.rules):
        matched = [s for s in SITES if fnmatch.fnmatchcase(s, rule.site)]
        if not matched:
            problems.append(
                f"rule {i}: site {rule.site!r} matches no instrumented "
                f"site (known: {', '.join(SITES)})")
        if rule.max_hits == 0:
            problems.append(f"rule {i}: max_hits=0 never fires")
        if rule.kind == "corrupt" and matched and not any(
                s in PAYLOAD_SITES for s in matched):
            problems.append(
                f"rule {i}: corrupt at {matched} has no payload to flip "
                f"(raises CorruptPayload without mutating anything)")
        if rule.kind == "corrupt_silent" and matched and not any(
                s in PAYLOAD_SITES for s in matched):
            problems.append(
                f"rule {i}: corrupt_silent at {matched} has no payload "
                f"to flip — the rule is a total no-op (payload sites: "
                f"{', '.join(PAYLOAD_SITES)})")
        if rule.kind == "torn" and matched and "ckpt.write" not in matched:
            problems.append(
                f"rule {i}: torn at {matched} has no staged file write "
                f"to truncate (only ckpt.write models a crash "
                f"mid-checkpoint-write)")
        if rule.kind == "stall" and float(rule.delay_s) > 0:
            problems.append(
                f"rule {i}: stall ignores delay_s={rule.delay_s!r} — "
                f"the hold is indefinite by definition (use kind "
                f"'delay' for a bounded slowdown)")
        if rule.kind == "partition":
            if matched and not all(s in BOARD_SITES for s in matched):
                problems.append(
                    f"rule {i}: partition at {matched} — the visibility "
                    f"mask only exists on the membership board (sites: "
                    f"{', '.join(BOARD_SITES)})")
            if float(rule.delay_s) > 0 or float(rule.prob) < 1.0 \
                    or rule.max_hits != 1:
                problems.append(
                    f"rule {i}: partition ignores prob/max_hits/delay_s "
                    f"— the mask is a standing window [after, "
                    f"heal_after) in gang steps, not an arrival-fired "
                    f"fault")
        elif int(rule.heal_after) != -1:
            problems.append(
                f"rule {i}: heal_after is only meaningful on kind "
                f"'partition' (this rule heals via max_hits)")
    return problems


def corrupt_buffer(buf, seed: int, hit: int) -> None:
    """Flip one bit per 64 bytes of a writable buffer, seeded by the
    schedule draw so the corruption itself is deterministic: a numpy
    array, or a CPU ``torch.Tensor`` (the same bytes flip as in a numpy
    array of the same contents, the JAX package's form).  A read-only
    buffer (a numpy broadcast view, a tensor that is not contiguous or
    not on the CPU) is refused: left untouched, the raise still happens.
    No-op for payload-free sites (``buf is None``)."""
    if buf is None:
        return
    import numpy as np  # local: keep the module import dependency-free

    if type(buf).__module__.startswith("torch"):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            return  # not host memory this process may write in place
        # The bytes of any dtype (bfloat16 has no numpy form).
        import torch

        buf = buf.detach().reshape(-1).view(torch.uint8).numpy()
    flags = getattr(buf, "flags", None)
    if flags is None or not flags.writeable:
        return  # broadcast views etc. — the raise still happens
    try:
        flat = buf.view(np.uint8).reshape(-1)
    except (ValueError, AttributeError):
        return  # non-contiguous / exotic layout: raise-only corrupt
    if flat.size == 0:
        return
    rng = int(decision(seed, "corrupt", hit) * (1 << 32))
    # Vectorized: a multi-GB staged payload must corrupt in one numpy
    # pass, not millions of Python-level element stores.
    offs = rng + np.arange(0, flat.size, 64, dtype=np.int64)
    np.bitwise_xor.at(flat, offs % flat.size,
                      np.left_shift(1, (offs % 8)).astype(np.uint8))
