"""``Config.analysis``'s runtime hook (the JAX package's
``analysis/hook.py``).

``Config.analysis`` (env ``TORCHMPI_TPU_ANALYSIS``) turns it on:

- ``"warn"``  — findings are emitted as Python warnings; execution
  continues.
- ``"error"`` — an error-severity finding raises :class:`AnalysisError`
  before the offending collective launches: a D1 / D3 error before the
  step's first call, a D2 / C1 / C2 one at that collective's dispatch.

It sits where the port builds what users call: the step builders
(``gradsync.data_parallel_step(_rank_major)``, the ``recipes`` builders)
wrap their step with :func:`wrap_step`, which checks each new argument
signature (the shapes and dtypes of the batch) once, on the call itself:
the checked call is the step's call, run under the recorder; a later
call of a seen signature pays one signature compare and no host sync.
The eager verbs check once a plan build (``planner._check_dispatch`` ->
:func:`check_dispatch`), so a planner hit pays nothing.  With
``Config.analysis="off"`` (the default) none of this module is imported.

When ``TORCHMPI_TPU_ANALYSIS_OUT`` names a file, every finding the
process produced is written there as JSON at exit (a clean run writes an
empty list): the transport ``analysis/tool.py`` uses to lint example
entry points.
"""

from __future__ import annotations

import atexit
import json
import os
import warnings
from typing import Callable, List, Optional, Sequence

from .checker import SLICE_RULES, run_checked
from .findings import Finding, format_findings, has_errors

MODES = ("off", "warn", "error")

ANALYSIS_OUT_ENV = "TORCHMPI_TPU_ANALYSIS_OUT"

# The rules a step's check runs: every rule but the aten-graph ones (a
# training step launches the port's kernels, which fake tensors cannot
# trace; the decode ticks are checked with ``check(..., rules=["S1",
# "S2"])``).
STEP_RULES = ("D1", "D2", "D3", "P1", "P2", "C1", "C2")
# An eager plan build's: D2 cannot fire there (an unbound axis raises
# ``collectives.UnboundAxisError`` before the planner is reached).
PLAN_RULES = ("P2",)


class AnalysisError(RuntimeError):
    """Raised under ``Config.analysis="error"`` when the checker finds an
    error-severity problem in a call about to launch its collectives."""

    def __init__(self, label: str, findings: List[Finding]):
        self.findings = findings
        super().__init__(
            f"collective-consistency analysis of {label!r}:\n"
            f"{format_findings(findings)}")


# Every finding any runtime check produced, in order (for the atexit
# JSON report and for tests).
_captured: List[Finding] = []
_atexit_armed = False


def captured_findings() -> List[Finding]:
    return list(_captured)


def reset_captured() -> None:
    _captured.clear()


def _write_report() -> None:
    path = os.environ.get(ANALYSIS_OUT_ENV)
    if not path:
        return
    try:
        with open(path, "w") as f:
            json.dump([fi.to_json() for fi in _captured], f, indent=1)
    except OSError:
        pass  # best-effort: a report failure must not mask the run


def arm_runtime_capture() -> None:
    """Idempotently register the atexit JSON report (``runtime.init`` and
    ``set_config`` call it when ``Config.analysis`` is on, so the report
    file exists, possibly empty, for every analyzed process)."""
    global _atexit_armed
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(_write_report)
        _write_report()


def report(label: str, findings: List[Finding], mode: str) -> None:
    """Deliver one check's findings per the configured mode.  Info
    findings are captured but never surfaced as warnings."""
    _captured.extend(findings)
    if not findings:
        return
    if mode == "error" and has_errors(findings):
        raise AnalysisError(label, findings)
    loud = [f for f in findings if f.severity != "info"]
    if loud:
        warnings.warn(
            f"torchmpi_tpu_torch.analysis[{label}]:\n"
            f"{format_findings(loud)}", stacklevel=3)


def check_once(label: str, fn, *args, mode: str, comm=None,
               rules: Optional[Sequence[str]] = None,
               sources: Optional[Sequence] = None, **kwargs):
    """Check one call of ``fn`` (it runs, under the recorder) and report
    per ``mode``; returns the call's result.  Under "error" an error
    finding raises :class:`AnalysisError` before the offending collective
    launches.  The caller keeps the once-per-signature discipline."""
    out, findings, failure = run_checked(
        fn, args, kwargs, rules=STEP_RULES if rules is None else rules,
        comm=comm, label=label, stop=mode == "error", sources=sources,
        run=True, slices=False, stop_static=mode == "error")
    report(label, findings, mode)
    if failure is not None:
        raise failure
    return out


def check_dispatch(label: str, op: str, x, axis, *, mode: str) -> None:
    """One eager plan build's rules (:data:`PLAN_RULES`): P2 on the verb
    ``op`` of one rank's ``x`` over ``axis``, reported per ``mode``."""
    from .events import call_axes, frame_source, user_frame
    from .rules import p2_finding

    from .. import runtime

    f = p2_finding(op.removesuffix("_rank_major"), call_axes(axis),
                   int(x.numel()) * int(x.element_size()), "eager",
                   frame_source(user_frame(2)), runtime.effective_config())
    report(label, [] if f is None else [f], mode)


def _signature(args, kwargs) -> tuple:
    """The shapes and dtypes of a call's tensors (trees flattened): what
    a step is checked once for.  Reads no value."""
    import torch

    from .. import _tree

    sig = []
    for leaf in _tree.leaves((list(args), dict(kwargs))):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), leaf.dtype, leaf.device.type))
        elif isinstance(leaf, (int, float, bool, str)) or leaf is None:
            sig.append(leaf)
        else:
            sig.append(type(leaf).__name__)
    return tuple(sig)


def wrap_step(step: Callable, *, label: str, mode: str,
              sources: Optional[Sequence] = None, comm=None,
              rules: Optional[Sequence[str]] = None) -> Callable:
    """``step`` checked on the first call of each argument signature (the
    shapes and dtypes of its tensors): that call runs under the recorder
    (:func:`check_once`), with the static pass over ``sources`` (default
    ``[step]``: a builder passes its ``loss_fn`` too) first.  A signature
    is marked seen only after a passing check: under "error" a retried
    call of the same shapes checks (and refuses) again."""
    seen = set()
    srcs = list(sources) if sources is not None else [step]

    def checked(*args, **kwargs):
        sig = _signature(args, kwargs)
        if sig in seen:
            return step(*args, **kwargs)
        out = check_once(label, step, *args, mode=mode, comm=comm,
                         rules=rules, sources=srcs, **kwargs)
        seen.add(sig)
        return out

    checked.__wrapped_step__ = step
    checked.__name__ = getattr(step, "__name__", "step")
    return checked


__all__ = ["MODES", "ANALYSIS_OUT_ENV", "STEP_RULES", "PLAN_RULES",
           "AnalysisError",
           "arm_runtime_capture", "captured_findings", "reset_captured",
           "report", "check_once", "check_dispatch", "wrap_step",
           "SLICE_RULES"]
