"""Generate, lint and summarize fault plans (the JAX package's
``scripts/chaos_tool.py``; docs/FAULTS_TORCH.md):

    python -m torchmpi_tpu_torch.faults.tool gen --out plan.json --seed 7 \\
        --rule ps.request:drop:0.5:3:0.01 --rule host_staged.*:corrupt
    python -m torchmpi_tpu_torch.faults.tool gen --out stall.json \\
        --stall 1:3:2      # wedge rank 1's liveness check at step 3
    python -m torchmpi_tpu_torch.faults.tool lint plan.json
    python -m torchmpi_tpu_torch.faults.tool summarize metrics_host*.jsonl

``gen`` writes a versioned plan from ``--rule`` specs
(``site:kind[:prob[:max_hits[:delay_s[:after]]]]``; ``site`` may glob the
instrumented sites, ``max_hits=-1`` means unbounded) and the boundary
recipes: ``--shrink RANK:STEP:NRANKS`` (``fail`` at ``elastic.member``
arrival ``STEP*NRANKS + RANK``), ``--stall RANK:STEP:NRANKS`` (``stall``
there), ``--partition RANKS:STEP[:HEAL_STEP]`` (a ``partition`` rule at
``board.read``) and ``--migrate RANK:STEP:NRANKS`` (``fail`` at arrival
``(STEP+1)*NRANKS + RANK``).  The elastic gang (``elastic.py``) fires
``elastic.member`` and the membership board the ``board.*`` sites; the
``--migrate`` recipe's consumer is the hot-state tier's ``hotstate.migrate``
(docs/HOTSTATE_TORCH.md).
The recipes write and lint plans byte for byte the JAX tool's for the
same arguments, so one plan drives both packages.
``lint`` validates a plan: schema or version errors exit 2, problems a
valid plan can still have (a site pattern that matches no instrumented
site, a dead rule, a payload kind at a payload-free site) print as F1
findings and exit 1.  ``summarize`` reads per-host obs metric dumps
(``Config.obs="metrics"``) and prints their ``tm_fault_*``,
``tm_watchdog_*``, ``tm_serving_*`` (and the JAX package's
``tm_elastic_*``, ``tm_guard_*``, ``tm_ckpt_*``, ``tm_hotstate_*``,
``tm_bench_*``) series; it exits 1 when a chaos run left no such counter
(it injected nothing).

It needs no runtime and no card: the plan schema is ``inject.py``'s.
"""

import argparse
import json
import sys
from typing import Dict, List, Tuple

from ..analysis.findings import ERROR, Finding, sort_findings


def _load_inject():
    """The plan schema (``inject.py``, dependency-free)."""
    from . import inject

    return inject


def parse_rule(inject, spec: str):
    """``site:kind[:prob[:max_hits[:delay_s[:after]]]]`` -> FaultRule.
    ``after`` skips the first N arrivals — how a plain --rule lands a
    fault at a specific mid-run arrival (the boundary recipes compute
    it for the ``elastic.member`` site; everywhere else the arrival
    ordinal is the site's dispatch count)."""
    parts = spec.split(":")
    if len(parts) < 2 or len(parts) > 6:
        raise ValueError(
            f"--rule {spec!r}: want "
            f"site:kind[:prob[:max_hits[:delay_s[:after]]]]")
    kw = {"site": parts[0], "kind": parts[1]}
    if len(parts) > 2:
        kw["prob"] = float(parts[2])
    if len(parts) > 3:
        kw["max_hits"] = int(parts[3])
    if len(parts) > 4:
        kw["delay_s"] = float(parts[4])
    if len(parts) > 5:
        kw["after"] = int(parts[5])
    rule = inject.FaultRule(**kw)
    rule.validate()
    return rule


def _boundary_rule(inject, flag: str, spec: str, kind: str):
    """``RANK:STEP:NRANKS`` -> a deterministic rule at the
    ``elastic.member`` site (the gang fires it once per member per step
    boundary in rank order, so the arrival ordinal is
    ``STEP*NRANKS + RANK``)."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(f"{flag} {spec!r}: want RANK:STEP:NRANKS")
    rank, step, nranks = (int(p) for p in parts)
    if nranks < 1 or not (0 <= rank < nranks) or step < 0:
        raise ValueError(
            f"{flag} {spec!r}: need 0 <= RANK < NRANKS and STEP >= 0")
    rule = inject.FaultRule(site="elastic.member", kind=kind,
                            prob=1.0, after=step * nranks + rank,
                            max_hits=1)
    rule.validate()
    return rule, rank, step, nranks


def parse_shrink(inject, spec: str):
    """Kill-rank-at-step recipe (``fail`` at ``elastic.member``)."""
    return _boundary_rule(inject, "--shrink", spec, "fail")


def parse_partition(inject, spec: str):
    """``RANKS:STEP[:HEAL_STEP]`` -> a ``partition`` rule at the
    ``board.read`` site (docs/ELASTIC.md "Partitions and split-brain"):
    from gang step STEP, the membership board's visibility splits along
    RANKS — ``"2,3"`` (those ranks vs. the rest, symmetric),
    ``"0,1|2,3"`` (explicit groups), ``"~2,3"`` (one-way: the named
    ranks go DEAF — they see nobody else's board files while their own
    writes stay visible; the asymmetric case).  With HEAL_STEP the
    mask lifts once any member's posted progress reaches it; without,
    the partition never heals.  The step clock is the gang's own
    progress, so the recipe replays bit-exactly."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"--partition {spec!r}: want RANKS:STEP[:HEAL_STEP] "
            f"(RANKS e.g. '1' / '0,1|2,3' / '~1')")
    ranks = parts[0]
    step = int(parts[1])
    heal = int(parts[2]) if len(parts) == 3 else -1
    if step < 0:
        raise ValueError(f"--partition {spec!r}: STEP must be >= 0")
    rule = inject.FaultRule(site="board.read", kind="partition",
                            ranks=ranks, after=step, heal_after=heal)
    rule.validate()
    return rule, ranks, step, heal


def parse_migrate(inject, spec: str):
    """``RANK:STEP:NRANKS`` -> the planned-migration drill
    (docs/HOTSTATE.md): the DRIVER is expected to drain rank RANK onto
    a spare at step STEP (``hotstate.migrate`` — e.g.
    ``benchmarks/recovery_bench.py --scenario migration``); this rule
    kills the source at its NEXT boundary arrival,
    ``(STEP+1)*NRANKS + RANK``, so a green run is the proof the drain
    beat the preemption: zero checkpoint rollback and the kill landing
    on an already-retired rank."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(f"--migrate {spec!r}: want RANK:STEP:NRANKS")
    rank, step, nranks = (int(p) for p in parts)
    if nranks < 1 or not (0 <= rank < nranks) or step < 0:
        raise ValueError(
            f"--migrate {spec!r}: need 0 <= RANK < NRANKS and STEP >= 0")
    rule = inject.FaultRule(site="elastic.member", kind="fail",
                            prob=1.0, after=(step + 1) * nranks + rank,
                            max_hits=1)
    rule.validate()
    return rule, rank, step, nranks


def parse_stall(inject, spec: str):
    """Wedge-rank-at-step recipe (docs/WATCHDOG.md): a ``stall`` at
    member RANK's liveness check at step STEP — every process of the
    gang holds at that same boundary arrival, which is exactly the
    symmetric wedge a peer stalled mid-collective produces.  With the
    watchdog off the gang hangs until the harness timeout; with
    ``break`` every rank's hold converts into a
    ``CollectiveHangError`` implicating ``member:RANK`` and the gang
    shrinks to N-1."""
    return _boundary_rule(inject, "--stall", spec, "stall")


def cmd_gen(args) -> int:
    inject = _load_inject()
    try:
        if len(args.shrink) + len(args.migrate) > 1:
            # After the first kill the gang recovers (replaying step
            # boundaries) AND fires one fewer arrival per step, so a
            # second rule's step*NRANKS+RANK ordinal no longer lands on
            # the (rank, step) it names — the recipe is exact for ONE
            # kill per plan (--migrate kills its source too).
            raise ValueError(
                "--shrink/--migrate may be given once per plan: arrival "
                "ordinals are only exact for the first kill (recovery "
                "replays and the shrunken gang shift later arrivals) — "
                "generate separate plans for separate kills")
        rules = [parse_rule(inject, spec) for spec in args.rule]
        for spec in args.shrink:
            rule, rank, step, nranks = parse_shrink(inject, spec)
            rules.append(rule)
            print(f"shrink recipe: kill rank {rank} at step {step} of a "
                  f"{nranks}-rank gang (elastic.member arrival "
                  f"{rule.after})")
        for spec in args.migrate:
            rule, rank, step, nranks = parse_migrate(inject, spec)
            rules.append(rule)
            print(f"migrate recipe: drain rank {rank} onto a spare at "
                  f"step {step} of a {nranks}-rank gang, source killed "
                  f"at step {step + 1} (elastic.member arrival "
                  f"{rule.after}; a green run means the drain beat the "
                  f"preemption — zero rollback, docs/HOTSTATE.md)")
        for spec in args.stall:
            rule, rank, step, nranks = parse_stall(inject, spec)
            rules.append(rule)
            print(f"stall recipe: wedge the gang on rank {rank}'s "
                  f"liveness check at step {step} of a {nranks}-rank "
                  f"gang (elastic.member arrival {rule.after}; "
                  f"watchdog=break recovers at N-1, watchdog=off hangs "
                  f"— docs/WATCHDOG.md)")
        for spec in args.partition:
            rule, ranks, step, heal = parse_partition(inject, spec)
            rules.append(rule)
            heal_s = (f", heals at step {heal}" if heal >= 0
                      else ", never heals")
            print(f"partition recipe: split the membership board "
                  f"along ranks {ranks!r} from step {step}{heal_s} "
                  f"(elastic_quorum=majority parks the minority and "
                  f"rejoins at heal; quorum off forks the view — "
                  f"docs/ELASTIC.md)")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not rules:
        print("error: gen needs at least one --rule, --shrink, "
              "--stall, --partition or --migrate", file=sys.stderr)
        return 2
    plan = inject.FaultPlan(seed=args.seed, note=args.note, rules=rules)
    problems = inject.lint_plan(plan)
    for p in problems:
        print(f"warning: {p}")
    plan.save(args.out)
    print(f"wrote {args.out}: seed={plan.seed} rules={len(plan.rules)}"
          + (f" ({len(problems)} warning(s))" if problems else ""))
    return 0


def cmd_lint(args) -> int:
    """Plan problems surface as F1 error :class:`Finding`\\ s — the
    same structured record (and ``--json`` wire format) as
    JAX package's ``scripts/lint_collectives.py``, so one consumer
    parses every static-analysis stream."""
    inject = _load_inject()
    as_json = getattr(args, "json", False)
    rc = 0
    findings = []
    for path in args.files:
        try:
            plan = inject.FaultPlan.load(path)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        found = [Finding(rule="F1", severity=ERROR, message=p,
                         source=path)
                 for p in inject.lint_plan(plan)]
        findings.extend(found)
        if found:
            rc = 1
        if not as_json:
            status = "OK" if not found else f"{len(found)} problem(s)"
            print(f"{path}: version={inject.FAULT_PLAN_VERSION} "
                  f"seed={plan.seed} rules={len(plan.rules)} — {status}")
            for f in found:
                print(f"  {f}")
    if as_json:
        print(json.dumps(
            [f.to_json() for f in sort_findings(findings)],
            indent=1))
    return rc


def _load_counters(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from None
            if isinstance(rec, dict) and rec.get("kind") == "counter":
                out.append(rec)
    return out


def cmd_summarize(args) -> int:
    totals: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for path in args.files:
        for rec in _load_counters(path):
            name = rec.get("name", "")
            if not name.startswith(("tm_fault_", "tm_elastic_",
                                    "tm_guard_", "tm_ckpt_",
                                    "tm_watchdog_", "tm_hotstate_",
                                    "tm_bench_", "tm_serving_")):
                continue
            key = (name, tuple(sorted(rec.get("labels", {}).items())))
            totals[key] = totals.get(key, 0) + rec.get("value", 0)
    if not totals:
        print("no tm_fault_*/tm_elastic_*/tm_guard_* counters found — "
              "the chaos run injected nothing (plan never matched a "
              "site, or faults were not armed)", file=sys.stderr)
        return 1
    by_action: Dict[str, float] = {}
    print(f"fault summary over {len(args.files)} host dump(s):")
    for (name, labels), v in sorted(totals.items()):
        lab = ",".join(f"{k}={val}" for k, val in labels)
        print(f"  {name}{{{lab}}} = {int(v)}")
        if name.startswith("tm_fault_"):
            action = name[len("tm_fault_"):-len("_total")]
        else:  # tm_elastic_*/tm_guard_*/tm_ckpt_*: keep the subsystem
            #   prefix
            action = name[len("tm_"):-len("_total")]
        by_action[action] = by_action.get(action, 0) + v
    line = "  ".join(f"{a}={int(v)}" for a, v in sorted(by_action.items()))
    print(f"totals: {line}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("gen", help="write a fault plan from --rule specs")
    s.add_argument("--out", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--note", default="")
    s.add_argument("--rule", action="append", default=[],
                   help="site:kind[:prob[:max_hits[:delay_s[:after]]]] "
                        "(repeatable)")
    s.add_argument("--shrink", action="append", default=[],
                   help="RANK:STEP:NRANKS — elastic-gang recipe: kill "
                        "rank RANK at step STEP of an NRANKS-rank gang "
                        "(once per plan — later kills' arrival "
                        "ordinals shift after the first shrink)")
    s.add_argument("--stall", action="append", default=[],
                   help="RANK:STEP:NRANKS — watchdog recipe "
                        "(docs/WATCHDOG.md): wedge the gang on rank "
                        "RANK's liveness check at step STEP (a silent "
                        "indefinite hold; watchdog=break converts it "
                        "into a typed hang + N-1 shrink)")
    s.add_argument("--partition", action="append", default=[],
                   help="RANKS:STEP[:HEAL_STEP] — split-brain recipe "
                        "(docs/ELASTIC.md): partition the membership "
                        "board along RANKS ('2,3' symmetric, "
                        "'0,1|2,3' groups, '~2,3' one-way/deaf) from "
                        "gang step STEP, optionally healing at "
                        "HEAL_STEP; elastic_quorum=majority parks the "
                        "minority, quorum off demonstrably forks")
    s.add_argument("--migrate", action="append", default=[],
                   help="RANK:STEP:NRANKS — planned-migration drill "
                        "(docs/HOTSTATE.md): the driver drains rank "
                        "RANK onto a spare at step STEP "
                        "(hotstate.migrate); this kills the source at "
                        "step STEP+1 — a green run proves the drain "
                        "beat the preemption with zero rollback")
    s.set_defaults(fn=cmd_gen)

    s = sub.add_parser("lint", help="validate plan files")
    s.add_argument("files", nargs="+")
    s.add_argument("--json", action="store_true",
                   help="emit problems as findings JSON (the "
                        "lint_collectives.py wire format)")
    s.set_defaults(fn=cmd_lint)

    s = sub.add_parser("summarize",
                       help="print tm_fault_* counters from obs dumps")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_summarize)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        return 0
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
