"""Lint the port's host-side protocol surfaces (the JAX package's
``scripts/lint_collectives.py --host``; rules H1-H5, ``hostcheck.py``):

    python torchmpi_tpu_torch/analysis/tool.py --host
    python torchmpi_tpu_torch/analysis/tool.py --host --json
    python torchmpi_tpu_torch/analysis/tool.py --host --rules H1,H4
    python -m torchmpi_tpu_torch.analysis.tool --host

The pass is pure AST and text: run as a file, this script loads
``hostcheck.py`` and ``findings.py`` by path and imports neither torch nor
``torchmpi_tpu_torch``, so the lint cannot trip the import discipline it
checks.  ``--package`` points it at another package tree (its docs
beside it).  Exit codes: 0 clean (or warnings only),
1 error-severity findings, 2 the pass could not run.  The trace-time
rules are not ported yet (ROADMAP queue A, item 11): ``--host`` is the
only mode.
"""

import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load_hostcheck():
    """``hostcheck.py`` by file path (it loads ``findings.py`` the same
    way): no package import."""
    name = "_torchmpi_tpu_torch_lint_hostcheck"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_HERE, "hostcheck.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # registered before exec: dataclasses
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter,
                                epilog=__doc__)
    p.add_argument("--host", action="store_true",
                   help="run the host-side H1-H5 rule pack (the only "
                        "mode: the trace-time rules are not ported)")
    p.add_argument("--json", action="store_true",
                   help="emit the findings as JSON on stdout")
    p.add_argument("--rules", default=None,
                   help="comma-separated H rule subset (e.g. H1,H4)")
    p.add_argument("--package", default=None,
                   help="the package directory (default: this tree's; "
                        "its docs/ beside it)")
    args = p.parse_args(argv)
    if not args.host:
        p.error("--host is the only mode (the trace-time rules are ROADMAP "
                "queue A, item 11)")
    hc = _load_hostcheck()
    rules = ([r.strip().upper() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        found = hc.run_hostcheck(args.package, rules=rules)
    except Exception as e:  # noqa: BLE001 — reported, exit 2
        print(f"error: host pass failed: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps([f.to_json() for f in found], indent=1))
    else:
        tag = hc.max_severity(found) or "clean"
        print(f"host pass (H1-H5): {len(found)} finding(s) [{tag}]")
        for f in found:
            print(f"  {f}")
    return 1 if hc.has_errors(found) else 0


if __name__ == "__main__":
    sys.exit(main())
