"""Inspect, merge, and prune tuning-plan files.

The port's counterpart of the JAX package's ``scripts/plan_tool.py``
(``show`` / ``merge`` / ``prune``), over the same JSON format::

    python -m torchmpi_tpu_torch.tuning.plan_tool show  plans.json [--match cuda]
    python -m torchmpi_tpu_torch.tuning.plan_tool merge merged.json a.json b.json
    python -m torchmpi_tpu_torch.tuning.plan_tool prune plans.json --older-than-days 30
    python -m torchmpi_tpu_torch.tuning.plan_tool prune plans.json --drop-match "ici:4"

``show`` prints one line per entry (key, backend, evidence medians).
``merge`` unions entries (newer timestamp wins a key conflict) into OUT.
``prune`` drops entries by age and/or key substring, atomically rewriting
the file.  Every command uses PlanCache's never-crash load: a corrupt
input is reported, not a traceback.  The in-process plan table is
``torchmpi_tpu_torch.planner.describe()``.
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
