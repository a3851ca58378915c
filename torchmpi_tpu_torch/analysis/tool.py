"""Lint step functions, example entry points and the host-side protocol
surfaces of the port for SPMD hazards (the JAX package's
``scripts/lint_collectives.py``; docs/ANALYSIS_TORCH.md).

Three passes:

- **Trace-time** (the targets below): the collective-consistency rules
  and the S1 / S2 cache-write rules, over one recorded call of each
  target and its aten graph (``analysis.check``).
- **Host-side** (``--host``): the H1-H5 AST / doc-drift rule pack
  (``hostcheck.py``) over the package tree.  Pure AST: run as a file with
  ``--host`` alone, this script loads ``hostcheck.py`` and
  ``findings.py`` by path and imports neither torch nor
  ``torchmpi_tpu_torch``; with targets it runs both passes.
- **Default sweep**: with no targets and no ``--host``, lints
  ``tests/_torch_analysis_clean.py`` and ``tests/_torch_lint_sweep.py``
  (the shipped decode / serving entry points) AND the host pass.

Two target forms, told apart per file:

1. **Declared targets**: a Python file with a top-level ``LINT_TARGETS``
   list of dicts ``{"fn": callable, "args": (tensors, ...), "comm":
   {"axis": size, ...}, "rules": None, "label": "..."}``.  The runtime is
   started on ``--device`` (the card by default, ``--device cpu`` for the
   CPU; a world of one process), the file loaded (its tensors made on
   ``runtime.device()``), and each target checked in-process: its call runs
   once there.
2. **Example entry points**: any other Python file (e.g.
   ``torchmpi_tpu_torch/examples/cifar_resnet20.py``), run as a
   subprocess with the runtime hook armed (``TORCHMPI_TPU_ANALYSIS=warn``
   and ``TORCHMPI_TPU_ANALYSIS_OUT``, the capture armed before it runs):
   every step the example builds and
   every eager plan it makes is checked once, and the findings JSON is
   read when the process exits.  Pass its arguments, its own
   ``--device`` among them, after ``--args``.
   Its own exit code is reported but does not gate the verdict unless
   ``--strict-run``.

Exit codes: 0 clean (or warnings / infos only), 1 error-severity
findings, 2 a target could not be loaded or analyzed.

    python torchmpi_tpu_torch/analysis/tool.py              # default sweep
    python torchmpi_tpu_torch/analysis/tool.py --device cpu # ... on the CPU
    python torchmpi_tpu_torch/analysis/tool.py --host       # host pass only
    python torchmpi_tpu_torch/analysis/tool.py tests/_torch_analysis_bad.py
    python torchmpi_tpu_torch/analysis/tool.py \\
        torchmpi_tpu_torch/examples/cifar_resnet20.py \\
        --args "--device cpu --devices 2 --steps 2"
"""

import argparse
import ast
import importlib.util
import json
import os
import shlex
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))

#: Linted when the tool is run with no targets: the clean near-miss
#: fixtures and the shipped decode / serving entry points.
DEFAULT_SWEEP = (
    os.path.join(_REPO, "tests", "_torch_analysis_clean.py"),
    os.path.join(_REPO, "tests", "_torch_lint_sweep.py"),
)


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


def _package():
    """The package's analysis."""
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    from torchmpi_tpu_torch import analysis

    return analysis


def _start_runtime(device: str) -> None:
    """The runtime up on ``device``: the declared targets' world of one
    process, started before the first declared file is loaded."""
    import torchmpi_tpu_torch as mpi

    if not mpi.runtime.is_initialized():
        mpi.init(device=device)


def _declares_lint_targets(path: str) -> bool:
    """True iff ``path`` assigns ``LINT_TARGETS`` at its top level (read
    as AST: a file that only mentions the name is never imported)."""
    try:
        with open(path) as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return False
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "LINT_TARGETS"
               for t in targets):
            return True
    return False


def _load_module(path: str):
    name = "_lint_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lint_declared(analysis, path: str, targets, rules=None) -> list:
    findings = []
    for i, t in enumerate(targets):
        label = t.get("label") or f"{os.path.basename(path)}[{i}]"
        findings.extend(analysis.check(
            t["fn"], *t.get("args", ()), rules=t.get("rules") or rules,
            comm=t.get("comm"), label=label))
    return findings


def lint_example(analysis, path: str, extra_args: str, timeout: float):
    """Run one example under the runtime hook; returns ``(findings,
    run_rc)``, or raises RuntimeError when it left no report."""
    fd, out_path = tempfile.mkstemp(prefix="lint_findings_",
                                    suffix=".json")
    os.close(fd)
    os.unlink(out_path)
    env = dict(os.environ)
    env["TORCHMPI_TPU_ANALYSIS"] = "warn"
    env[analysis.ANALYSIS_OUT_ENV] = out_path
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    # The capture armed before the example runs: an example that never
    # starts the runtime (a sequential baseline) reports an empty list.
    runner = ("import runpy, sys\n"
              "from torchmpi_tpu_torch.analysis import hook\n"
              "hook.arm_runtime_capture()\n"
              "sys.argv = sys.argv[1:]\n"
              "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", runner, os.path.abspath(path),
         *shlex.split(extra_args or "")],
        cwd=_REPO, capture_output=True, text=True, timeout=timeout, env=env)
    try:
        with open(out_path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        raise RuntimeError(
            f"{path}: no analysis report produced (rc={proc.returncode});"
            f"\nstderr tail: {proc.stderr[-800:]}")
    finally:
        try:
            os.unlink(out_path)
        except OSError:
            pass
    return [analysis.Finding.from_json(d) for d in raw], proc.returncode


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__)
    p.add_argument("targets", nargs="*",
                   help="python files: LINT_TARGETS declarations or "
                        "example entry points (none = the default sweep "
                        "and the host pass)")
    p.add_argument("--host", action="store_true",
                   help="run the host-side H1-H5 rule pack; alone = the "
                        "host pass only (no torch import), with targets = "
                        "both passes")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the declared targets run (default: the "
                        "card)")
    p.add_argument("--args", default="",
                   help="arguments passed to example subprocesses")
    p.add_argument("--json", action="store_true",
                   help="emit the findings as JSON on stdout")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset (e.g. D1,D2,H1)")
    p.add_argument("--package", default=None,
                   help="the package directory the host pass reads "
                        "(default: this tree's; its docs/ beside it)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-example subprocess timeout (seconds)")
    p.add_argument("--strict-run", action="store_true",
                   help="also fail when an example subprocess exits "
                        "nonzero")
    args = p.parse_args(argv)

    targets = list(args.targets)
    run_host = args.host
    if not targets and not args.host:
        targets, run_host = list(DEFAULT_SWEEP), True
    hc = _load_hostcheck()
    analysis = _package() if targets else None
    rules = ([r.strip().upper() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    found_all, load_failures, run_failures = [], 0, 0

    if run_host:
        hrules = [r for r in rules if r.startswith("H")] if rules else None
        if rules is None or hrules:
            try:
                found = hc.run_hostcheck(args.package, rules=hrules)
            except Exception as e:  # noqa: BLE001 — reported, exit 2
                print(f"error: host pass failed: {e}", file=sys.stderr)
                load_failures += 1
                found = []
            found_all.extend(found)
            if not args.json:
                tag = hc.max_severity(found) or "clean"
                print(f"host pass (H1-H5): {len(found)} finding(s) [{tag}]")

    trules = ([r for r in rules if not r.startswith("H")] or None
              if rules else None)
    for path in targets:
        try:
            declared = None
            if _declares_lint_targets(path):
                _start_runtime(args.device)
                declared = _load_module(path).LINT_TARGETS
        except Exception as e:  # noqa: BLE001 — report, keep linting
            print(f"error: cannot load {path}: {e}", file=sys.stderr)
            load_failures += 1
            continue
        try:
            if declared is not None:
                found, rc = lint_declared(analysis, path, declared,
                                          trules), 0
            else:
                found, rc = lint_example(analysis, path, args.args,
                                         args.timeout)
        except Exception as e:  # noqa: BLE001 — report, keep linting
            print(f"error: {path}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            load_failures += 1
            continue
        if rc != 0:
            run_failures += 1
            print(f"note: {path} exited {rc} (not gating; --strict-run "
                  f"gates)", file=sys.stderr)
        found_all.extend(found)
        if not args.json:
            tag = hc.max_severity(found) or "clean"
            print(f"{path}: {len(found)} finding(s) [{tag}]")

    if analysis is not None:
        from torchmpi_tpu_torch import runtime

        runtime.stop()  # the declared targets' world, if one was started
    found_all = hc.sort_findings(found_all)
    if args.json:
        print(json.dumps([f.to_json() for f in found_all], indent=1))
    else:
        for f in found_all:
            print(f"  {f}")
    if load_failures:
        return 2
    if hc.has_errors(found_all):
        return 1
    if args.strict_run and run_failures:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
