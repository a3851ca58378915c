"""The analyzer's entry points: the static pass, the recorded call, the
rules (the JAX package's ``analysis/checker.py``).

``check(fn, *args)`` is the pipeline.  JAX traces ``fn`` to a jaxpr and
never runs it; the port has no jaxpr, so:

1. the static pass (:mod:`static`) reads the source of ``fn`` (and of
   the ``sources`` given: a builder's ``loss_fn``) for D1 and D3;
2. one call of ``fn`` runs under a :class:`~events.Recorder` installed
   as the dispatch listener (``fusion.set_trace_listener``): the port's
   stand-in for ``make_jaxpr``.  Every collective it issues and every
   layout record its fused launches, ZeRO legs and codecs emit is kept;
   the dispatch-time rules (D2, C1, C2) are checked as each arrives and,
   with ``stop`` (the default), an error raises there, before that
   collective launches.  The port's own unbound-axis raise
   (``collectives.UnboundAxisError``) becomes the D2 finding, with its
   call site, as JAX's checker converts ``make_jaxpr``'s;
3. where S1 or S2 is selected, ``fn``'s aten graph under fake tensors
   (``make_fx``; :mod:`slices`) for the cache-write rules;
4. the rules over all of it (:mod:`rules`).

With a D1 or D3 error from step 1 the call does not run where the world
has more than one process (a rank-divergent program would deadlock
there), nor ever under the hook's "error" mode.
``comm`` (axis name -> size) pushes a communicator of that shape around
the call, the counterpart of JAX's ``axis_env``.  ``assert_clean`` is
the pytest helper; the runtime hook (``Config.analysis``) is
:mod:`hook`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .events import Recorder, Refused, traceback_source
from .findings import (ERROR, Finding, format_findings, severity_rank,
                       sort_findings)
from .rules import RuleContext, resolve_rules, run_rules, \
    unbound_axis_finding

STATIC_RULES = ("D1", "D3")
SLICE_RULES = ("S1", "S2")


def _effective_config(config):
    if config is not None:
        return config
    from .. import runtime

    return runtime.effective_config()


def _selected(rules: Optional[Sequence[str]]) -> Tuple[str, ...]:
    return tuple(r.id for r in resolve_rules(rules))


class _Pushed:
    """``with _Pushed(comm):`` — a communicator of shape ``comm`` (axis
    name -> size) around the checked call; nothing for None."""

    def __init__(self, comm: Optional[Dict[str, int]]) -> None:
        self.comm = comm

    def __enter__(self):
        if self.comm is not None:
            from .. import runtime

            runtime.push_communicator(
                "analysis:" + ",".join(f"{a}={s}" for a, s in
                                       self.comm.items()),
                shape=dict(self.comm))
        return self

    def __exit__(self, *exc):
        if self.comm is not None:
            from .. import runtime

            runtime.pop_communicator()
        return False


def record(fn, *args, comm: Optional[Dict[str, int]] = None,
           **kwargs) -> Tuple[Any, Recorder]:
    """Run ``fn(*args, **kwargs)`` once under a recorder that never
    refuses: ``(result, recorder)``, its ``events`` and ``records`` for
    :func:`check_events`."""
    from .. import fusion

    rec = Recorder()
    prev = fusion.set_trace_listener(rec)
    try:
        with _Pushed(comm):
            out = fn(*args, **kwargs)
    finally:
        fusion.set_trace_listener(prev)
        rec.close()
    return out, rec


def check_events(events, *, records: Sequence[dict] = (),
                 bound_axes: Optional[Sequence[str]] = None,
                 rules: Optional[Sequence[str]] = None, config=None,
                 label: str = "", static_events=(),
                 slice_events=()) -> List[Finding]:
    """The rules over an already-recorded stream (JAX ``check_jaxpr``).
    ``bound_axes`` re-reads every event as if only these axes were
    bound."""
    import dataclasses

    if bound_axes is not None:
        bound = frozenset(bound_axes)
        events = [dataclasses.replace(e, bound_axes=bound) for e in events]
    ctx = RuleContext(events=list(events), records=list(records),
                      config=_effective_config(config), label=label,
                      slice_events=list(slice_events),
                      static_events=list(static_events))
    return sort_findings(run_rules(ctx, rules))


def run_checked(fn, args, kwargs, *, rules: Optional[Sequence[str]] = None,
                comm: Optional[Dict[str, int]] = None, config=None,
                label: str = "", stop: bool = True,
                sources: Optional[Sequence] = None,
                run: Optional[bool] = None, slices: Optional[bool] = None,
                stop_static: Optional[bool] = None
                ) -> Tuple[Any, List[Finding], Optional[BaseException]]:
    """One checked call: ``(result, findings, failure)``.  ``failure`` is
    the call's own raise where it became a finding (the hook re-raises it
    where it does not refuse).  ``run`` None runs the call
    where a selected rule reads the recording; ``slices`` None builds the
    aten graph where S1 or S2 is selected.  ``stop_static``: a static
    error (D1 / D3) stops before the call; None stops only where the world
    has more than one process (a recording of a world of one cannot
    deadlock, and it adds the call's own findings)."""
    from .. import fusion
    from . import static

    picked = _selected(rules)
    cfg = _effective_config(config)
    findings: List[Finding] = []
    static_rules = [r for r in picked if r in STATIC_RULES]
    if static_rules:
        stat = static.scan(list(sources) if sources is not None else [fn])
        findings += run_rules(RuleContext(
            events=(), records=(), config=cfg, label=label,
            static_events=stat), static_rules)
        if stop_static is None:
            from .. import runtime

            stop_static = stop and runtime.is_initialized() \
                and runtime.size() > 1
        if stop_static and any(f.severity == ERROR for f in findings):
            return None, sort_findings(findings), None
    recorded = [r for r in picked
                if r not in STATIC_RULES and r not in SLICE_RULES]
    if run is None:
        run = bool(recorded)
    out, failure = None, None
    if run:
        rec = Recorder(rules=picked, config=cfg, label=label, stop=stop)
        prev = fusion.set_trace_listener(rec)
        refused = False
        try:
            with _Pushed(comm):
                out = fn(*args, **kwargs)
        except Refused:
            refused = True
        except Exception as e:  # noqa: BLE001 — sorted out below
            failure = e
        finally:
            fusion.set_trace_listener(prev)
            rec.close()
        got = run_rules(RuleContext(
            events=rec.events, records=rec.records, config=cfg,
            label=label), recorded)
        if failure is not None:
            from ..collectives import UnboundAxisError

            if isinstance(failure, UnboundAxisError) and "D2" in picked:
                got.append(unbound_axis_finding(
                    failure, label, traceback_source(failure)))
            elif not any(f.severity == ERROR for f in got):
                # A raise with no error finding behind it stays loud.
                raise failure
        findings += got
        if refused or failure is not None:
            # The call stopped short: no graph to walk (JAX's check
            # returns the trace failure's finding alone).
            return out, sort_findings(findings), failure
    slice_rules = [r for r in picked if r in SLICE_RULES]
    explicit = rules is not None
    if slices is None:
        slices = bool(slice_rules)
    if slices and slice_rules:
        from . import slices as sl

        try:
            with _Pushed(comm):
                gm, records = sl.trace_graph(fn, *args, **kwargs)
        except Exception:  # noqa: BLE001 — see below
            if explicit:
                raise
            # The default catalog on a call fake tensors cannot trace (a
            # kernel launch, a host read of a value): no aten graph, no
            # cache write to check.
            return out, sort_findings(findings), failure
        findings += run_rules(RuleContext(
            events=(), records=records, config=cfg, label=label,
            slice_events=sl.trace_slice_events(gm)), slice_rules)
    return out, sort_findings(findings), failure


def check(fn, *args, rules: Optional[Sequence[str]] = None,
          comm: Optional[Dict[str, int]] = None, config=None,
          label: str = "", sources: Optional[Sequence] = None,
          **kwargs) -> List[Finding]:
    """Analyze one step function; returns sorted findings.

    ``fn(*args, **kwargs)`` runs once under the recorder (the static pass
    first; an error there, or at a dispatch, stops it before the
    offending collective launches).  ``comm`` pushes a communicator of
    that shape (axis name -> size) around the call, for code written
    against named axes (JAX's ``axis_env``).  ``rules`` selects a subset
    of the registry (default: all); ``config`` overrides the Config the
    perf rules read; ``sources`` the functions the static pass reads
    (default ``[fn]``)."""
    return run_checked(fn, args, kwargs, rules=rules, comm=comm,
                       config=config, label=label, sources=sources)[1]


def assert_clean(fn, *args, rules: Optional[Sequence[str]] = None,
                 comm: Optional[Dict[str, int]] = None, config=None,
                 fail_on: str = ERROR, label: str = "",
                 **kwargs) -> List[Finding]:
    """Pytest helper: run :func:`check` and raise ``AssertionError`` if
    any finding is at least ``fail_on`` severe (default: errors only —
    perf warnings don't fail a correctness suite).  Returns the full
    finding list so callers can still inspect the quieter ones."""
    findings = check(fn, *args, rules=rules, comm=comm, config=config,
                     label=label, **kwargs)
    threshold = severity_rank(fail_on)
    bad = [f for f in findings if severity_rank(f.severity) <= threshold]
    if bad:
        raise AssertionError(
            f"collective-consistency analysis of "
            f"{label or getattr(fn, '__name__', fn)!r} found "
            f"{len(bad)} problem(s):\n{format_findings(bad)}")
    return findings


__all__ = ["check", "check_events", "assert_clean", "record", "run_checked",
           "STATIC_RULES", "SLICE_RULES"]
