"""The rule registry: what the analyzer checks (the JAX package's
``analysis/rules.py``; rule ids, severities and messages are JAX's).

Each rule is a function ``fn(ctx) -> list[Finding]`` over a
:class:`RuleContext`: the recorded collective events of one checked call
(:mod:`events`), the layout records its fused launches, ZeRO legs and
codecs emitted, the static pass's branch events (:mod:`static`), the
slice events of an aten graph (:mod:`slices`) and the active Config.
Rules register under a short id; the default run executes all of them,
``check(..., rules=("D1", "P1"))`` selects a subset.

- **D1** (error): a collective inside a branch whose test derives from
  the rank (``runtime.rank()``, ``process_index()``,
  ``torch.distributed.get_rank()``, ``axis_index``, a communicator's
  rank): the ranks that skip the branch never enter it.  From the static
  pass: a recording of one process sees only the branch it took.
- **D2** (error): a collective over an axis name the current
  communicator does not bind (recorded events; the checker also turns
  the port's own raise, ``collectives.UnboundAxisError``, into it).
- **D3** (warning): two branches of one ``if`` / ``elif`` chain reach
  the same collectives in different orders (static pass).
- **P1** (warning): at least ``P1_MIN_COUNT`` small same-dtype, same-axes
  elementwise collectives from one user frame that are not buckets of a
  fused launch: what ``Config.fuse_max_bytes``'s fused path coalesces.
- **P2** (info): a payload at or above ``P2_MIN_NBYTES`` and below
  ``Config.custom_min_bytes``, the selector's cutover.
- **C1** (error): a fused launch's ``FusedSpec`` against its tensors, the
  bucket chain, and a ZeRO reduce-scatter's shard layout against the
  ranks it spans (layout records, checked at the dispatch).
- **C2** (error / info): the dcn codecs' records: a codec on a
  reduction it cannot quantize, an error-feedback residual state that
  does not match the buckets, a leg below ``dcn_compress_min_bytes``.
- **S1** (error / info), **S2** (warning): cache writes of a decode tick
  whose indices are not provably in range, and per-row slot writes whose
  positions bypass ``models.generate.clamp_slot_positions`` (the aten
  graph of ``make_fx``; :mod:`slices`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .events import CollectiveEvent
from .findings import ERROR, INFO, WARNING, Finding

# P1: how many coalescable small collectives constitute a hot-path
# fusion bypass worth flagging.
P1_MIN_COUNT = 4
# P2: payloads at or under this are intentionally tiny (scalar losses,
# flags) and exempt from the "nobody measured this size" report.
P2_MIN_NBYTES = 256

# The elementwise verbs fusion.ELEMENTWISE_OPS coalesces (JAX's psum /
# pmin / pmax, what its allreduce, reduce and broadcast lower to).
_P1_PRIMITIVES = ("allreduce", "reduce", "broadcast")


@dataclasses.dataclass
class RuleContext:
    """Everything one rule invocation may consult."""

    events: Sequence[CollectiveEvent]  # the recorded dispatches
    records: Sequence[dict]          # fusion/ZeRO/codec layout records
    config: object                   # the effective Config
    label: str = ""                  # caller-supplied name of the fn
    # Dynamic-slice event stream (analysis/slices.py) for the S rules;
    # default () keeps record-only constructions (C2's partial-trace
    # path) working unchanged.
    slice_events: Sequence[object] = ()
    # The static pass's collectives inside branches (analysis/static.py):
    # D1's and D3's input.
    static_events: Sequence[CollectiveEvent] = ()


@dataclasses.dataclass
class Rule:
    id: str
    severity: str
    doc: str
    fn: Callable[[RuleContext], List[Finding]]


RULES: Dict[str, Rule] = {}


def register_rule(id: str, severity: str, doc: str):
    def deco(fn):
        RULES[id] = Rule(id=id, severity=severity, doc=doc, fn=fn)
        return fn
    return deco


def resolve_rules(rules: Optional[Sequence[str]] = None) -> List[Rule]:
    if rules is None:
        return list(RULES.values())
    out = []
    for r in rules:
        if r not in RULES:
            raise ValueError(
                f"unknown analysis rule {r!r} (known: {sorted(RULES)})")
        out.append(RULES[r])
    return out


def run_rules(ctx: RuleContext,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for rule in resolve_rules(rules):
        findings.extend(rule.fn(ctx))
    return findings


# ---------------------------------------------------------------------------
# D1: collective under a rank-derived branch (SPMD divergence deadlock)
# ---------------------------------------------------------------------------


@register_rule("D1", ERROR,
               "collective under a cond/switch branch whose predicate "
               "derives from axis_index (rank): SPMD divergence deadlock")
def _rule_d1(ctx: RuleContext) -> List[Finding]:
    out = []
    for ev in ctx.static_events:
        if not ev.under_divergent_cond:
            continue
        frame = next(f for f in ev.cond_stack if f.pred_tainted)
        out.append(Finding(
            rule="D1", severity=ERROR,
            message=(f"{ev.primitive} inside branch {frame.branch} of a "
                     f"cond whose predicate derives from axis_index: "
                     f"ranks taking the other branch never enter this "
                     f"collective (deadlock on hardware)"),
            path=ev.path, source=ev.source or frame.source,
            op=ev.primitive, axes=ev.axes, nbytes=ev.nbytes))
    return out


# ---------------------------------------------------------------------------
# D2: collective over an unbound axis name
# ---------------------------------------------------------------------------


@register_rule("D2", ERROR,
               "collective over an axis name not bound by any enclosing "
               "mesh/shard_map/axis_env")
def _rule_d2(ctx: RuleContext) -> List[Finding]:
    out = []
    for ev in ctx.events:
        missing = ev.unbound_axes
        if not missing:
            continue
        out.append(Finding(
            rule="D2", severity=ERROR,
            message=(f"{ev.primitive} names axis "
                     f"{'/'.join(missing)} which no enclosing mesh or "
                     f"shard_map binds (bound here: "
                     f"{sorted(ev.bound_axes) or 'none'})"),
            path=ev.path, source=ev.source,
            op=ev.primitive, axes=ev.axes, nbytes=ev.nbytes))
    return out


def unbound_axis_finding(exc: BaseException, label: str = "",
                         source: str = "") -> Finding:
    """Convert the port's own unbound-axis raise
    (``collectives.UnboundAxisError``, a collective naming an axis the
    current communicator lacks) into the D2 finding, with its call site
    (JAX's checker converts ``make_jaxpr``'s failure so)."""
    return Finding(
        rule="D2", severity=ERROR,
        message=(f"tracing failed with {type(exc).__name__}: {exc} — a "
                 f"collective names an axis no enclosing mesh/shard_map/"
                 f"axis_env binds"),
        path=label, source=source)


# ---------------------------------------------------------------------------
# D3: mixed collective ordering across branches of one cond
# ---------------------------------------------------------------------------


@register_rule("D3", WARNING,
               "same-axis collectives issued in different orders along "
               "different branches of the same cond/switch")
def _rule_d3(ctx: RuleContext) -> List[Finding]:
    # site id -> branch idx -> ordered [(primitive, axes)]
    sites: Dict[int, Dict[int, List[Tuple[str, Tuple[str, ...]]]]] = {}
    meta: Dict[int, Tuple[str, str]] = {}  # site -> (source, path)
    for ev in ctx.static_events:
        for frame in ev.cond_stack:
            sig = (ev.primitive, ev.axes)
            sites.setdefault(frame.site, {}).setdefault(
                frame.branch, []).append(sig)
            meta.setdefault(frame.site, (frame.source, ev.path))
    out = []
    for site, branches in sites.items():
        # ALL branch pairs, not just adjacent ones: an intervening
        # branch with < 2 collectives must not mask a b0-vs-b2
        # reordering.  Branch counts are tiny; O(n^2) is free.
        seqs = [(b, s) for b, s in sorted(branches.items())
                if len(s) >= 2]
        done = False
        for i, (bi, si) in enumerate(seqs):
            for bj, sj in seqs[i + 1:]:
                if si != sj and sorted(si) == sorted(sj):
                    src, path = meta[site]
                    ops = ", ".join(f"{p} over {'x'.join(a)}"
                                    for p, a in si)
                    out.append(Finding(
                        rule="D3", severity=WARNING,
                        message=(f"branches {bi} and {bj} of this cond "
                                 f"issue the same collectives ({ops}) "
                                 f"in different orders: if branch "
                                 f"selection ever diverges across "
                                 f"ranks the collectives pair up "
                                 f"crosswise and deadlock"),
                        path=path, source=src))
                    done = True  # one finding per cond site
                    break
            if done:
                break
    return out


# ---------------------------------------------------------------------------
# P1: per-leaf launches that bypassed the fused path
# ---------------------------------------------------------------------------


@register_rule("P1", WARNING,
               "many small same-dtype elementwise collectives that the "
               "fused pytree path would coalesce")
def _rule_p1(ctx: RuleContext) -> List[Finding]:
    fuse_max = int(getattr(ctx.config, "fuse_max_bytes", 0) or 0)
    if fuse_max <= 0:
        return []  # fusion disabled on purpose: nothing bypassed it
    groups: Dict[Tuple, List[CollectiveEvent]] = {}
    for ev in ctx.events:
        if ev.primitive not in _P1_PRIMITIVES or ev.fused:
            continue
        if not (0 < ev.nbytes < fuse_max):
            continue
        groups.setdefault(
            (ev.region, ev.primitive, ev.axes, ev.dtype), []).append(ev)
    out = []
    for (region, prim, axes, dtype), evs in groups.items():
        if len(evs) < P1_MIN_COUNT:
            continue
        total = sum(e.nbytes for e in evs)
        out.append(Finding(
            rule="P1", severity=WARNING,
            message=(f"{len(evs)} separate {prim} launches of small "
                     f"{dtype} buffers ({total} bytes total) in one "
                     f"region: the fused pytree path "
                     f"(config.fuse_max_bytes={fuse_max}) would coalesce "
                     f"these into "
                     f"{max(1, -(-total // fuse_max))} launch(es)"),
            path=evs[0].path, source=evs[0].source,
            op=prim, axes=axes, nbytes=total))
    return out


# ---------------------------------------------------------------------------
# P2: collective below the selector cutover / plan bucket floor
# ---------------------------------------------------------------------------


@register_rule("P2", INFO,
               "collective payload below the selector's cutover/plan "
               "bucket floor: too small to ever route to a measured "
               "custom backend")
def _rule_p2(ctx: RuleContext) -> List[Finding]:
    out = []
    for ev in ctx.events:
        f = p2_finding(ev.primitive, ev.axes, ev.nbytes, ev.path, ev.source,
                       ctx.config)
        if f is not None:
            out.append(f)
    return out


def p2_finding(primitive: str, axes, nbytes: int, path: str, source: str,
               config) -> Optional[Finding]:
    """P2 on one dispatch (the rule's body; ``hook.check_dispatch`` calls
    it on an eager plan build)."""
    floor = int(getattr(config, "custom_min_bytes", 0) or 0)
    if not (0 < floor and P2_MIN_NBYTES <= nbytes < floor):
        return None
    return Finding(
        rule="P2", severity=INFO,
        message=(f"{primitive} payload of {nbytes} bytes is "
                 f"below the custom-backend cutover "
                 f"(custom_min_bytes={floor}): it always takes the "
                 f"stock path and no tuning plan will ever measure "
                 f"this size — consider fusing it with neighbors"),
        path=path, source=source, op=primitive, axes=axes, nbytes=nbytes)


# ---------------------------------------------------------------------------
# C1: fused / ZeRO shard-layout invariants (from trace-time records)
# ---------------------------------------------------------------------------


@register_rule("C1", ERROR,
               "fused-collective / ZeRO layout invariants: spec matches "
               "tree, barrier chain spans all dtype-group buckets, shard "
               "layout agrees with the axes spanned")
def _rule_c1(ctx: RuleContext) -> List[Finding]:
    out = []
    for rec in ctx.records:
        kind = rec.get("kind")
        src = rec.get("source", "")
        if kind == "fuse_tree":
            if rec.get("spec_leaves") != rec.get("tree_leaves") or \
                    rec.get("spec_dtypes") != rec.get("tree_dtypes") or \
                    rec.get("spec_sizes") != rec.get("tree_sizes"):
                out.append(Finding(
                    rule="C1", severity=ERROR,
                    message=(f"fused {rec.get('op')} ran with a FusedSpec "
                             f"built for a different tree "
                             f"({rec.get('spec_leaves')} leaves/"
                             f"{rec.get('spec_sizes')} sizes vs "
                             f"{rec.get('tree_leaves')}/"
                             f"{rec.get('tree_sizes')} actual): leaves "
                             f"unpack from the wrong extents"),
                    source=src, op=str(rec.get("op", "")),
                    axes=tuple(rec.get("axes", ()))))
            n_launches = int(rec.get("n_launches", 1))
            if rec.get("barrier") and n_launches > 1 and \
                    int(rec.get("barrier_links", 0)) != n_launches - 1:
                out.append(Finding(
                    rule="C1", severity=ERROR,
                    message=(f"gradsync_barrier chain covers "
                             f"{rec.get('barrier_links')} of the "
                             f"{n_launches - 1} bucket transitions: "
                             f"unchained buckets re-merge in XLA's "
                             f"all-reduce combiner"),
                    source=src, op=str(rec.get("op", "")),
                    axes=tuple(rec.get("axes", ()))))
        elif kind == "zero_reduce_scatter":
            n_shards = int(rec.get("n_shards", 1))
            axis_size = int(rec.get("axis_size", n_shards))
            if n_shards != axis_size:
                out.append(Finding(
                    rule="C1", severity=ERROR,
                    message=(f"ZeRO shard layout was built for "
                             f"{n_shards} shards but the reduce_scatter "
                             f"axes span {axis_size} devices: every "
                             f"device updates the wrong parameter "
                             f"extent"),
                    source=src, axes=tuple(rec.get("axes", ()))))
            for dtype, padded, shard in rec.get("groups", ()):
                if n_shards and padded % n_shards != 0:
                    out.append(Finding(
                        rule="C1", severity=ERROR,
                        message=(f"ZeRO {dtype} group padded length "
                                 f"{padded} is not divisible by "
                                 f"n_shards={n_shards}: group-major "
                                 f"shard extents misalign"),
                        source=src, axes=tuple(rec.get("axes", ()))))
    return out


# ---------------------------------------------------------------------------
# C2: DCN compression / layout consistency (from trace-time records —
# compress.note_leg / compress.residual_note / hierarchical._dcn_codec)
# ---------------------------------------------------------------------------


@register_rule("C2", ERROR,
               "DCN compression consistency: codec vs reduce op, "
               "error-feedback residual structure vs the gradient bucket "
               "layout, quantized legs below the size floor")
def _rule_c2(ctx: RuleContext) -> List[Finding]:
    out = []
    for rec in ctx.records:
        kind = rec.get("kind")
        src = rec.get("source", "")
        if kind == "dcn_compress":
            op = str(rec.get("op", ""))
            codec = str(rec.get("codec", ""))
            if rec.get("incompatible"):
                out.append(Finding(
                    rule="C2", severity=ERROR,
                    message=(f"dcn_compress={codec!r} requested but this "
                             f"two-level {op} cannot quantize its DCN leg "
                             f"(non-sum reduction or non-float payload): "
                             f"the leg silently ran uncompressed — drop "
                             f"the codec for this op or route it "
                             f"separately"),
                    source=src, op=op, axes=tuple(rec.get("axes", ())),
                    nbytes=int(rec.get("nbytes", 0))))
            elif (int(rec.get("nbytes", 0))
                    < int(rec.get("min_bytes", 0))
                    and int(rec.get("wire_nbytes", 0))
                    == int(rec.get("nbytes", 0))):
                out.append(Finding(
                    rule="C2", severity=INFO,
                    message=(f"dcn_compress={codec!r} is on but this "
                             f"{op}'s DCN shard ({rec.get('nbytes')} "
                             f"bytes) is below dcn_compress_min_bytes="
                             f"{rec.get('min_bytes')}: it crossed DCN "
                             f"uncompressed (the floor working as "
                             f"designed — raise it deliberately or fuse "
                             f"the payload if savings were expected)"),
                    source=src, op=op, axes=tuple(rec.get("axes", ())),
                    nbytes=int(rec.get("nbytes", 0))))
        elif kind == "dcn_residual" and not rec.get("ok", True):
            out.append(Finding(
                rule="C2", severity=ERROR,
                message=(f"error-feedback residual state does not match "
                         f"the gradient bucket layout: {rec.get('got')} "
                         f"residual buffer(s) threaded for "
                         f"{rec.get('expected')} bucket(s) — build the "
                         f"state with init_dcn_residuals(...) from the "
                         f"SAME template/n_buckets/max_bytes as the sync"),
                source=src, axes=tuple(rec.get("axes", ()))))
    return out


@register_rule("S1", ERROR,
               "dynamic_update_slice/dynamic_slice start index not "
               "provably clamped to leave room for the update width")
def _rule_s1(ctx: RuleContext) -> List[Finding]:
    """The slot-cache corruption class, statically (JAX's rule, its
    message kept): an index into a cache that is not provably in range
    corrupts rows silently (JAX's ``dynamic_update_slice`` clamps; a
    negative torch index wraps) or faults the card.  A data-dependent
    index feeding a cache write must be provably bounded
    (``torch.clamp`` against ``size - width``) before the write.  Error
    when the write target is a carried/input cache buffer; info for
    reads and scratch intermediates."""
    out: List[Finding] = []
    for ev in ctx.slice_events:
        if ev.safe:
            continue
        hot = ev.write and ev.on_buffer
        kind = "write" if ev.write else "read"
        target = ("carried cache buffer" if ev.on_buffer
                  else "intermediate value")
        out.append(Finding(
            rule="S1", severity=ERROR if hot else INFO,
            message=(f"{ev.op} {kind} into a {target} with an "
                     f"unproven start index ({ev.detail}): an "
                     f"out-of-range start CLAMPS silently — corrupt "
                     f"last rows, no error.  Clamp the index to "
                     f"[0, size - width] (models/generate.py:"
                     f"clamp_slot_positions) before the slice"),
            path=ev.path, source=ev.source, op=ev.op))
    return out


@register_rule("S2", WARNING,
               "slot-indexed cache write whose positions bypass the "
               "clamp helpers in models/generate.py/tp_generate.py")
def _rule_s2(ctx: RuleContext) -> List[Finding]:
    """Per-row (vmapped) slot-cache writes must derive their
    ``pos_offset`` through :func:`models.generate.clamp_slot_positions`
    — the helper both clamps AND leaves a ``slot_clamp`` trace record,
    so the discipline is checkable here.  An inline ``jnp.clip`` may
    satisfy S1 today, but the next edit to the width or the buffer
    shape has no single chokepoint to keep it honest."""
    batched = [ev for ev in ctx.slice_events
               if ev.write and ev.batched and ev.data_dependent]
    if not batched:
        return []
    if any(r.get("kind") == "slot_clamp" for r in ctx.records):
        return []
    ev = batched[0]
    return [Finding(
        rule="S2", severity=WARNING,
        message=(f"{len(batched)} per-row slot-cache write(s) trace "
                 f"without a clamp-helper record: route the positions "
                 f"through models/generate.py:clamp_slot_positions "
                 f"(or tp_generate's re-export) instead of deriving "
                 f"pos_offset ad hoc"),
        path=ev.path, source=ev.source, op=ev.op)]


def rule_catalog() -> List[Tuple[str, str, str]]:
    """(id, severity, doc) for every registered rule — docs/CLI help."""
    return [(r.id, r.severity, r.doc) for r in RULES.values()]
