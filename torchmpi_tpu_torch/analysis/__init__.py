"""Static analysis of the port (the JAX package's ``analysis/``;
docs/ANALYSIS_TORCH.md, docs/API_TORCH.md): the host-side lint pack and
the trace-time collective rules.

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

The trace-time rules (D1-D3, P1-P2, C1-C2, S1-S2; docs/ANALYSIS_TORCH.md)
check one call of a step: :func:`check` reads the step's source for D1
and D3 (:mod:`static`), runs the call once under a recorder of its
collectives and layout records (:mod:`events`; the port's stand-in for
JAX's jaxpr walk), and, for the cache-write rules, walks its aten graph
(:mod:`slices`).  :func:`assert_clean` is the pytest helper, and
``Config.analysis`` ("warn" | "error") arms the runtime hook
(:mod:`hook`): the step builders check each new batch signature once,
the eager verbs each plan build.  ``python
torchmpi_tpu_torch/analysis/tool.py`` lints declared ``LINT_TARGETS``,
example entry points and, with no argument, the default sweep.

Off by default and never imported by ``import torchmpi_tpu_torch`` (H1
holds the package to it).
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
from .events import (  # noqa: F401
    OP_MAP,
    CollectiveEvent,
    CondFrame,
    Recorder,
)
from .rules import (  # noqa: F401
    P1_MIN_COUNT,
    P2_MIN_NBYTES,
    RULES,
    Rule,
    RuleContext,
    register_rule,
    rule_catalog,
    run_rules,
)
from .checker import (  # noqa: F401
    assert_clean,
    check,
    check_events,
    record,
)
from .slices import SliceEvent, trace_graph, trace_slice_events  # noqa: F401
from .hook import (  # noqa: F401
    ANALYSIS_OUT_ENV,
    MODES,
    AnalysisError,
    arm_runtime_capture,
    captured_findings,
    check_dispatch,
    check_once,
    report,
    reset_captured,
    wrap_step,
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
    "OP_MAP", "CollectiveEvent", "CondFrame", "Recorder",
    "RULES", "Rule", "RuleContext", "register_rule", "rule_catalog",
    "run_rules", "P1_MIN_COUNT", "P2_MIN_NBYTES",
    "assert_clean", "check", "check_events", "record",
    "SliceEvent", "trace_graph", "trace_slice_events",
    "AnalysisError", "ANALYSIS_OUT_ENV", "MODES", "arm_runtime_capture",
    "captured_findings", "check_dispatch", "check_once", "report",
    "reset_captured", "wrap_step",
]
