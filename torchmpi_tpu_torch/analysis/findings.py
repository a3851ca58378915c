"""Structured findings: what the port's static analysis reports (the JAX
package's ``analysis/findings.py``).

A :class:`Finding` is one rule violation, carrying the rule id, a
severity, a path and a source location (``file.py:123``) — enough for a
human to jump to the site and for tools (``analysis/tool.py --json``,
``faults/tool.py lint``) to machine-process the report.  The fields, the
text form and the JSON form are the JAX package's, so both packages'
tools print and emit the same records.  Dependency-free: the host-side
lint loads this file standalone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

# Severity ladder.  ERROR findings are correctness hazards — the CLI
# exits nonzero on them.  WARNING findings are likely hazards or
# measurable performance losses; INFO findings are observations worth a
# look.
ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


def severity_rank(severity: str) -> int:
    """Lower rank = more severe; unknown severities sort last."""
    return _SEVERITY_ORDER.get(severity, len(_SEVERITY_ORDER))


@dataclasses.dataclass
class Finding:
    """One rule violation.

    ``path`` is where in the checked structure the problem lives (a
    plan rule's index, a traversal path); ``source`` is the file and
    line (``file.py:123``), empty when none applies.
    """

    rule: str
    severity: str
    message: str
    path: str = ""
    source: str = ""
    op: str = ""
    axes: Tuple[str, ...] = ()
    nbytes: int = 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["axes"] = list(self.axes)
        return d

    @staticmethod
    def from_json(d: dict) -> "Finding":
        fields = {f.name for f in dataclasses.fields(Finding)}
        kept = {k: v for k, v in d.items() if k in fields}
        kept["axes"] = tuple(kept.get("axes") or ())
        return Finding(**kept)

    def __str__(self) -> str:
        loc = self.source or self.path or "<unknown>"
        extra = ""
        if self.op:
            extra = f" [{self.op}"
            if self.axes:
                extra += f" over {'x'.join(self.axes)}"
            extra += "]"
        return f"{self.rule} {self.severity}: {self.message}{extra} at {loc}"


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    """Severity-major, then rule id — the report order every surface
    (API return value, CLI text, ``--json``) shares."""
    return sorted(findings,
                  key=lambda f: (severity_rank(f.severity), f.rule, f.path))


def max_severity(findings: Sequence[Finding]) -> Optional[str]:
    """The most severe level present, or None for a clean bill."""
    if not findings:
        return None
    return min((f.severity for f in findings), key=severity_rank)


def has_errors(findings: Sequence[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "clean: no findings"
    lines = [str(f) for f in sort_findings(findings)]
    return "\n".join(lines)
