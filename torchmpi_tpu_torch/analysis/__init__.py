"""Static analysis of the port: the host-side lint pack (the JAX package's
``analysis/``, its host half; docs/API_TORCH.md, docs/HOTSTATE_TORCH.md).

The host pass (:mod:`hostcheck`, rules H1-H5) reads the port's tree and
docs as AST and text and reports the drift of its host protocol layers:
an off-by-default subsystem imported eagerly, a ``tm_*`` metric missing
from docs/OBSERVABILITY_TORCH.md, a ``Config`` field missing from
docs/API_TORCH.md or from the runtime's env pickup and ``set_config``
checks, a fault site missing from ``faults/inject.py`` or
docs/FAULTS_TORCH.md, a lock-order cycle.  Findings are the JAX
package's :class:`Finding` records.

Surfaces:

- :func:`run_hostcheck` — the findings, sorted;
- :func:`lint_full` — the pytest helper: raises on error-severity ones;
- ``python torchmpi_tpu_torch/analysis/tool.py --host [--json]`` — the
  CLI (exit 1 on errors), which imports neither torch nor the package.

Off by default and never imported by ``import torchmpi_tpu_torch`` (H1
holds the package to it).  The trace-time rules (the JAX package's
``checker``, ``events``, ``rules``, ``slices`` and ``hook`` modules) and
``Config.analysis``'s runtime hook are not ported yet (ROADMAP queue A,
item 11).
"""

from .findings import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
    format_findings,
    has_errors,
    max_severity,
    sort_findings,
)
from .hostcheck import (  # noqa: F401
    DOCS,
    GATED_FIELD_FAMILIES,
    GATED_MODULES,
    HOST_RULES,
    JAX_DOCS,
    run_hostcheck,
)


def lint_full(package_root=None, docs_root=None, rules=None):
    """Pytest / CI helper: run the host-side H rule pack and raise
    ``AssertionError`` on error-severity findings.  Returns the full
    finding list."""
    findings = run_hostcheck(package_root, docs_root, rules=rules)
    bad = [f for f in findings if f.severity == ERROR]
    if bad:
        raise AssertionError(
            f"host-side static analysis found {len(bad)} problem(s):\n"
            f"{format_findings(bad)}")
    return findings


__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "format_findings",
    "has_errors", "max_severity", "sort_findings",
    "DOCS", "JAX_DOCS", "GATED_MODULES", "GATED_FIELD_FAMILIES",
    "HOST_RULES", "run_hostcheck", "lint_full",
]
