"""The collective-event stream of one checked call, from a recorder (the
JAX package's ``analysis/events.py``).

JAX walks a jaxpr; the port has no jaxpr.  Its collectives all pass
through a few dispatch homes (``collectives._eager`` for the rank-major
verbs, ``collectives._world`` for the process-world and in-axis verbs,
``fusion.run_bucket`` for every fused bucket and the overlap schedule's),
and each of them offers the call to ``fusion._trace_listener`` when one is
installed (one ``None`` check per dispatch when none is).  A
:class:`Recorder` is that listener for one checked call: it turns each
offer into a :class:`CollectiveEvent` with JAX's fields, and keeps the
layout records the fused launches, ZeRO's reduce-scatter legs and the
codecs emit (``kind`` "fuse_tree", "zero_reduce_scatter", "dcn_compress",
"dcn_residual", "slot_clamp"; JAX's record schema).

The recorder reads only ``.shape``, ``.dtype`` and ``.device``: it never
syncs with the host.  It checks the dispatch-time rules (D2, C1, C2) on
each offer as it arrives; with ``stop`` an error finding raises
:class:`Refused` there, before the offending collective launches.

``op`` is the port's verb.  JAX's primitives map to it (:data:`OP_MAP`):
psum and pmean are ``allreduce``, all_gather ``allgather``, psum_scatter
and reduce_scatter ``reduce_scatter``, ppermute ``sendreceive``,
all_to_all ``alltoall``; pmax and pmin have no verb (the port reduces by
sum or mean), and the counterpart programs use another verb over the same
axes where JAX's use them.  A region is one user frame (a function
invocation) of the checked call: events issued from the same function
share one, as the collectives of one jaxpr do.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

OP_MAP = {
    "psum": "allreduce", "pmean": "allreduce", "pmax": None, "pmin": None,
    "all_gather": "allgather", "all_gather_invariant": "allgather",
    "reduce_scatter": "reduce_scatter", "psum_scatter": "reduce_scatter",
    "ppermute": "sendreceive", "all_to_all": "alltoall",
    "pgather": "gather",
}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH = None


@dataclasses.dataclass
class CondFrame:
    """One enclosing ``if`` / ``while`` branch around a collective (the
    static pass's; a recorded event has none)."""

    site: int          # per-pass unique id of the branch statement
    branch: int        # which branch the collective sits in
    n_branches: int
    pred_tainted: bool  # the test derives from the rank
    source: str = ""   # ``file.py:line`` of the branch statement


@dataclasses.dataclass
class CollectiveEvent:
    """One collective the checked call issued (or, from the static pass,
    one it reaches inside a branch)."""

    index: int                     # issue order within the check
    primitive: str                 # the port's verb ("allreduce", ...)
    axes: Tuple[str, ...]          # the communicator axes it spans
    nbytes: int                    # one rank's payload bytes
    dtype: str                     # the payload's dtype name
    path: str                      # the dispatch home ("eager", "bucket", ...)
    source: str                    # user frame ``file.py:line (fn)`` or ""
    bound_axes: FrozenSet[str]     # the current communicator's axes
    cond_stack: Tuple[CondFrame, ...] = ()
    region: int = 0                # the user frame it came from
    fused: bool = False            # one bucket of a fused launch

    @property
    def unbound_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a not in self.bound_axes)

    @property
    def under_divergent_cond(self) -> bool:
        return any(f.pred_tainted for f in self.cond_stack)


class Refused(Exception):
    """An error finding at a dispatch of a call checked with ``stop``:
    raised by the recorder before that collective launches, caught by the
    checker (``findings`` holds it)."""

    def __init__(self, findings):
        self.findings = list(findings)
        super().__init__(f"{len(self.findings)} error finding(s)")


def _internal(filename: str) -> bool:
    global _TORCH
    if _TORCH is None:
        import torch

        _TORCH = os.path.dirname(os.path.abspath(torch.__file__))
    path = os.path.abspath(filename)
    return path.startswith(_PKG) or path.startswith(_TORCH)


def user_frame(skip: int = 1):
    """The innermost stack frame outside this package and torch."""
    fr = sys._getframe(skip)
    while fr is not None and _internal(fr.f_code.co_filename):
        fr = fr.f_back
    return fr


def frame_source(fr) -> str:
    """``file.py:line (fn)`` of a frame, "" for None."""
    if fr is None:
        return ""
    name = fr.f_code.co_name
    return f"{fr.f_code.co_filename}:{fr.f_lineno}" + (
        f" ({name})" if name else "")


def traceback_source(exc: BaseException) -> str:
    """``file.py:line (fn)`` of the innermost frame of ``exc``'s traceback
    outside this package and torch."""
    tb, found = exc.__traceback__, ""
    while tb is not None:
        if not _internal(tb.tb_frame.f_code.co_filename):
            found = (f"{tb.tb_frame.f_code.co_filename}:{tb.tb_lineno} "
                     f"({tb.tb_frame.f_code.co_name})")
        tb = tb.tb_next
    return found


def call_axes(axis) -> Tuple[str, ...]:
    """The axes a dispatch over ``axis`` spans: the named ones (a name or
    a tuple of names), or every axis of the current communicator for
    None."""
    if axis is not None:
        return (axis,) if isinstance(axis, str) else tuple(axis)
    from .. import runtime

    return (tuple(runtime.current_communicator().axes)
            if runtime.is_initialized() else ())


class Recorder:
    """The trace listener of one checked call (``fusion._trace_listener``):
    :meth:`collective` per dispatch, :meth:`record` per layout record.
    ``rules`` the selected rule ids, ``config`` the Config the rules read;
    with ``stop`` an error finding at a dispatch raises :class:`Refused`
    before the collective launches."""

    # The rules a single dispatch or record decides.
    DISPATCH_RULES = ("D2", "C1", "C2")

    def __init__(self, *, rules: Optional[Sequence[str]] = None,
                 config=None, label: str = "", stop: bool = False) -> None:
        self.events: List[CollectiveEvent] = []
        self.records: List[dict] = []
        self.rules = rules
        self.config = config
        self.label = label
        self.stop = stop
        self._regions: Dict[int, int] = {}
        self._frames: list = []  # keeps region frames alive for the check

    def _bound(self) -> FrozenSet[str]:
        from .. import runtime

        if not runtime.is_initialized():
            return frozenset()
        return frozenset(runtime.current_communicator().axes)

    def _immediate(self, events: Sequence[CollectiveEvent],
                   records: Sequence[dict]) -> None:
        if not self.stop:
            return
        from .findings import ERROR
        from .rules import RuleContext, run_rules

        picked = [r for r in self.DISPATCH_RULES
                  if self.rules is None or r in self.rules]
        if not picked:
            return
        ctx = RuleContext(events=events, records=records,
                          config=self.config, label=self.label)
        bad = [f for f in run_rules(ctx, picked) if f.severity == ERROR]
        if bad:
            raise Refused(bad)

    def collective(self, op: str, x, axis=None, *, fused: bool = False,
                   path: str = "eager") -> None:
        """One dispatch of verb ``op`` on one rank's tensor ``x`` over
        ``axis`` (a name, a tuple of names, or None for every axis of the
        current communicator)."""
        bound = self._bound()
        axes = call_axes(axis)
        fr = user_frame(2)
        region = self._regions.setdefault(id(fr), len(self._regions))
        self._frames.append(fr)
        nbytes = int(x.numel()) * int(x.element_size())
        ev = CollectiveEvent(
            index=len(self.events), primitive=op.removesuffix("_rank_major"),
            axes=axes, nbytes=nbytes, dtype=str(x.dtype).removeprefix(
                "torch."), path=path, source=frame_source(fr),
            bound_axes=bound, region=region, fused=fused)
        self.events.append(ev)
        self._immediate([ev], [])

    def record(self, rec: dict) -> None:
        """One layout record (JAX's schema); its ``source`` is the user
        call site where the emitter left none."""
        rec = dict(rec)
        if not rec.get("source"):
            rec["source"] = frame_source(user_frame(2))
        self.records.append(rec)
        self._immediate([], [rec])

    def close(self) -> None:
        self._frames.clear()


class RecordsOnly(Recorder):
    """A listener that keeps the layout records and ignores dispatches
    (the slice pass's, under ``make_fx``)."""

    def collective(self, op, x, axis=None, *, fused=False, path="eager"):
        return None


__all__ = ["OP_MAP", "CondFrame", "CollectiveEvent", "Recorder",
           "RecordsOnly", "Refused", "call_axes", "user_frame",
           "frame_source", "traceback_source"]
