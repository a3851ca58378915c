"""Deterministic membership-board partitions: the ``partition`` fault
kind's engine (the port's copy of the JAX package's
``faults/partition.py``).

A partition rule (:class:`~.inject.FaultRule` with ``kind="partition"``
at a ``board.*`` site) splits the gang's ranks into groups; while the
mask is active a reader sees only the board files written by ranks on
its own side of the split.  The one-way form (``"~2,3"``) makes the
named ranks *deaf*: they see nobody else's files while their own writes
stay visible.  The window is step-deterministic: active from gang step
``rule.after`` until ``rule.heal_after`` (-1 = never), on the highest
step any member has posted, so the heal is globally consistent.

The membership board (``faults/membership.py``) consults the mask
through :func:`~torchmpi_tpu_torch.faults.board_partition` on every read;
the chaos tool's ``--partition`` recipe writes its rules.  Never imported
unless an armed plan holds a partition rule.  Dependency-free, like the rest of the
package.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Tuple

from .inject import FaultPlan, parse_partition_ranks


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """One partition rule, parsed: disjoint rank ``groups`` (ranks in
    no group form the implicit "rest" side), ``one_way`` (the named
    group is deaf: it reads nobody, everybody reads it), active for
    gang steps in ``[start, heal)`` (``heal`` -1 = never lifts)."""

    groups: Tuple[FrozenSet[int], ...]
    one_way: bool
    start: int
    heal: int

    def active(self, step: int) -> bool:
        return step >= self.start and (self.heal < 0 or step < self.heal)

    def _side(self, rank: int) -> int:
        for i, g in enumerate(self.groups):
            if rank in g:
                return i
        return -1  # the implicit "rest" side

    def masked(self, reader: int, writer: int) -> bool:
        """Can ``reader`` NOT see a file ``writer`` wrote?"""
        if reader == writer:
            return False  # a rank always sees its own writes
        if self.one_way:
            # The named ranks are deaf: they cannot read anyone else's
            # files; their own writes stay visible to everyone.
            return reader in self.groups[0]
        return self._side(reader) != self._side(writer)


class BoardPartition:
    """Every partition window of one armed plan; the Board consults
    :meth:`masked` per (reader, writer, step)."""

    def __init__(self, windows: List[PartitionWindow]):
        self.windows = list(windows)

    def masked(self, reader: int, writer: int, step: int) -> bool:
        return any(w.active(step) and w.masked(reader, writer)
                   for w in self.windows)

    def any_active(self, step: int) -> bool:
        return any(w.active(step) for w in self.windows)

    def healed(self, step: int) -> bool:
        """Every window has a heal step and the clock has passed it —
        the partition is over for good (parked-rank triage)."""
        return all(w.heal >= 0 and step >= w.heal for w in self.windows)


def build(plan: FaultPlan) -> Optional[BoardPartition]:
    """Parse ``plan``'s partition rules into a mask; None when it has
    none (the common case — the Board then pays one attribute check)."""
    windows = []
    for rule in plan.rules:
        if rule.kind != "partition":
            continue
        groups, one_way = parse_partition_ranks(rule.ranks)
        windows.append(PartitionWindow(
            groups=tuple(groups), one_way=one_way,
            start=int(rule.after), heal=int(rule.heal_after)))
    return BoardPartition(windows) if windows else None
