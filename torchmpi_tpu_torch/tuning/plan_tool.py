"""Inspect, merge, and prune tuning-plan files.

The port's counterpart of the JAX package's ``scripts/plan_tool.py``
(``show`` / ``merge`` / ``prune`` / ``lint`` / ``dump-live``), over the
same JSON format::

    python -m torchmpi_tpu_torch.tuning.plan_tool show  plans.json [--match cuda]
    python -m torchmpi_tpu_torch.tuning.plan_tool merge merged.json a.json b.json
    python -m torchmpi_tpu_torch.tuning.plan_tool prune plans.json --older-than-days 30
    python -m torchmpi_tpu_torch.tuning.plan_tool prune plans.json --drop-match "ici:4"
    python -m torchmpi_tpu_torch.tuning.plan_tool lint a.json b.json [--json]
    python -m torchmpi_tpu_torch.tuning.plan_tool dump-live [SCRIPT] [--json]

``show`` prints one line per entry (key, backend, evidence medians).
``merge`` unions entries (newer timestamp wins a key conflict) into OUT.
``prune`` drops entries by age and/or key substring, atomically rewriting
the file.  ``lint`` checks plan files against each other (JAX
:111-183): PL1 (error), one key resolving to different backends across
files (hosts replaying different plans pick different implementations
for the same step and deadlock); PL2 (warning), a size bucket more than
4 log2 buckets from its nearest measured neighbour in its group; exit 1
on an error.  ``dump-live`` prints the in-process plan table
(``planner.describe()``) after running SCRIPT in this process (a few
rank-major verbs on the CPU without one; JAX :184-236).  Every command
uses PlanCache's never-crash load: a corrupt input is reported, not a
traceback.
"""

from __future__ import annotations

import argparse
import sys
import time

from .plancache import PlanCache


def _load_or_die(path: str) -> PlanCache:
    cache = PlanCache.load(path)
    if cache.degraded_reason is not None:
        print(f"warning: {path}: {cache.degraded_reason} "
              f"(treating as empty)", file=sys.stderr)
    return cache


def cmd_show(args) -> int:
    cache = _load_or_die(args.file)
    shown = 0
    for key, e in sorted(cache.entries.items()):
        if args.match and args.match not in key:
            continue
        shown += 1
        meds = ""
        if e.median_ms:
            meds = " " + " ".join(
                f"{b}={ms:.3f}ms" for b, ms in sorted(e.median_ms.items()))
        age = ""
        if e.timestamp:
            age = f" age={(time.time() - e.timestamp) / 86400:.1f}d"
        print(f"{key} -> {e.backend} [{e.source} rounds={e.rounds}{age}]"
              f"{meds}")
    print(f"{shown}/{len(cache)} entries"
          + (f" matching {args.match!r}" if args.match else ""))
    return 0


def cmd_merge(args) -> int:
    out = PlanCache(args.out)
    for path in args.inputs:
        src = _load_or_die(path)
        adopted = out.merge_from(src)
        print(f"{path}: {len(src)} entries, {adopted} adopted")
    if not out.save(args.out):
        print(f"error: cannot write {args.out}", file=sys.stderr)
        return 1
    print(f"wrote {args.out}: {len(out)} entries")
    return 0


def cmd_prune(args) -> int:
    cache = _load_or_die(args.file)
    if cache.degraded_reason is not None:
        print("error: refusing to rewrite a degraded file", file=sys.stderr)
        return 1
    cutoff = (time.time() - args.older_than_days * 86400
              if args.older_than_days is not None else None)

    def keep(key, e) -> bool:
        if cutoff is not None and e.timestamp and e.timestamp < cutoff:
            return False
        if args.drop_match and args.drop_match in key:
            return False
        return True

    dropped = cache.prune(keep)
    if not cache.save(args.file, merge=False):
        print(f"error: cannot write {args.file}", file=sys.stderr)
        return 1
    print(f"dropped {dropped}, kept {len(cache)} -> {args.file}")
    return 0


def cmd_lint(args) -> int:
    import json

    from ..analysis.findings import (ERROR, WARNING, Finding, has_errors,
                                     sort_findings)

    findings = []
    seen = {}    # key -> {backend -> [files]} across every input
    caches = []
    for path in args.files:
        cache = _load_or_die(path)
        caches.append((path, cache))
        for key, e in cache.entries.items():
            seen.setdefault(key, {}).setdefault(e.backend, []).append(path)
    # PL1: cross-host divergence — one key, different backends.
    for key, by_backend in sorted(seen.items()):
        if len(by_backend) > 1:
            detail = "; ".join(
                f"{b} in {', '.join(sorted(set(fs)))}"
                for b, fs in sorted(by_backend.items()))
            findings.append(Finding(
                rule="PL1", severity=ERROR,
                message=(f"plan key {key} resolves to different backends "
                         f"across files ({detail}): hosts replaying "
                         f"different plans pick different collective "
                         f"implementations for the same step and "
                         f"deadlock — re-merge with plan_tool merge "
                         f"(newest wins) before deploying"),
                path=key))
    # PL2: orphaned size buckets — a measurement more than 4 log2 buckets
    # from its nearest neighbour in a group that has other entries.
    groups = {}
    for _, cache in caches:
        for key in cache.entries:
            prefix, _, bucket = key.rpartition("|b")
            try:
                groups.setdefault(prefix, set()).add((int(bucket), key))
            except ValueError:
                continue
    for prefix, buckets in sorted(groups.items()):
        ordered = sorted(buckets)
        for i, (b, key) in enumerate(ordered):
            gaps = ([b - ordered[i - 1][0]] if i > 0 else []) + (
                [ordered[i + 1][0] - b] if i + 1 < len(ordered) else [])
            if gaps and min(gaps) > 4:
                findings.append(Finding(
                    rule="PL2", severity=WARNING,
                    message=(f"size bucket b{b} is {min(gaps)} log2 "
                             f"buckets from its nearest measured neighbor "
                             f"in this group — an orphaned one-off "
                             f"measurement (stale experiment?); prune it "
                             f"or re-measure the sizes between"),
                    path=key))
    findings = sort_findings(findings)
    if args.json:
        print(json.dumps([f.to_json() for f in findings], indent=1))
    else:
        total = sum(len(c.entries) for _, c in caches)
        print(f"linted {len(args.files)} file(s), {total} entries: "
              f"{len(findings)} finding(s)")
        for f in findings:
            print(f"  {f}")
    return 1 if has_errors(findings) else 0


def cmd_dump_live(args) -> int:
    import json
    import runpy

    import torch

    from .. import collectives, planner, runtime

    if args.exec_path:
        # The user's entry point in this process, so that its plans fill
        # this interpreter's table (its own init is kept: init is
        # idempotent, and dump-live makes none of its own before it).
        runpy.run_path(args.exec_path, run_name="__main__")
    else:
        # A few representative rank-major dispatches on the CPU (each
        # second call a hit, so the stats line shows replay working).
        if not runtime.is_initialized():
            runtime.init(device="cpu")
        x = torch.arange(4 * 64, dtype=torch.float32).reshape(4, 64)
        for _ in range(2):
            collectives.allreduce_rank_major(x)
            collectives.broadcast_rank_major(x, root=0)
            collectives.allreduce_rank_major(x.half())
    rows = planner.describe()
    st = planner.stats()
    if args.json:
        print(json.dumps({"stats": st, "plans": rows}, indent=1,
                         default=str))
    else:
        for r in rows:
            print(f"{r['kind']:13s} {r['op']:14s} "
                  f"backend={r['backend'] or '-':13s} "
                  f"topo={r.get('topology') or '-':7s} "
                  f"{r['nbytes']:>10d} B  {r['launches']:3d} launches  "
                  f"epoch={r['epoch']}  hits={r['hits']}  "
                  f"build={r['build_ms']:.2f}ms"
                  + ("  staged" if r["staged"] else "")
                  + (f"  analysis={r['analysis']}"
                     if r["analysis"] != "off" else ""))
        print(f"{len(rows)} live plan(s); {st['hits']} hits / "
              f"{st['misses']} misses / {st['invalidations']} "
              f"invalidations this process")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("show", help="list a plan file's entries")
    s.add_argument("file")
    s.add_argument("--match", default=None,
                   help="only keys containing this substring")
    s.set_defaults(fn=cmd_show)

    s = sub.add_parser("merge", help="union plan files into OUT")
    s.add_argument("out")
    s.add_argument("inputs", nargs="+")
    s.set_defaults(fn=cmd_merge)

    s = sub.add_parser("prune", help="drop entries by age / key match")
    s.add_argument("file")
    s.add_argument("--older-than-days", type=float, default=None)
    s.add_argument("--drop-match", default=None,
                   help="drop keys containing this substring")
    s.set_defaults(fn=cmd_prune)

    s = sub.add_parser("lint", help="cross-file divergence (PL1) and "
                                    "orphaned size buckets (PL2)")
    s.add_argument("files", nargs="+")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_lint)

    s = sub.add_parser("dump-live", help="the in-process plan table after "
                                         "a script (or a built-in warmup)")
    s.add_argument("exec_path", nargs="?", default=None,
                   help="a script run in this process first")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_dump_live)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
