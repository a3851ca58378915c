"""Persistent, versioned collective-plan database.

The PyTorch counterpart of ``torchmpi_tpu/tuning/plancache.py`` (:22-236),
in the same JSON format, so a plan file written by one package loads in
the other.  One file holds every measured decision for a machine (or a
fleet, when plans are merged with ``python -m
torchmpi_tpu_torch.tuning.plan_tool merge``), keyed by the topology
fingerprint of :mod:`torchmpi_tpu_torch.tuning.fingerprint`: the
measurement is paid once per (op, size bucket, grid, platform) and every
later process reads the answer from disk.

Durability rules (a tuning cache must never take down a training job):

- ``load`` NEVER raises: a missing, corrupt, or version-mismatched file
  yields an empty cache with ``degraded_reason`` set, and the caller
  falls back to static selection.
- ``save`` is atomic (tmp file + ``os.replace``) and merges with
  whatever is on disk first, so concurrent writers union their entries
  instead of clobbering each other; on conflict the newer entry wins.
- ``save`` returns False instead of raising on unwritable paths.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional

PLAN_VERSION = 1

# Default location, beside the checkout (the JAX package's is
# ``<repo>/.tuning_plans``; the port keeps its own, since its keys name
# other platforms and its backends other implementations).
DEFAULT_PLAN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".tuning_plans_torch")
DEFAULT_PLAN_PATH = os.path.join(DEFAULT_PLAN_DIR, "plans.json")


def resolve_plan_path(path: Optional[str] = None) -> str:
    """Explicit arg > ``TORCHMPI_TPU_TUNING_PLAN`` env > default."""
    return (path
            or os.environ.get("TORCHMPI_TPU_TUNING_PLAN")
            or DEFAULT_PLAN_PATH)


@dataclasses.dataclass
class PlanEntry:
    """One measured decision: the winning backend plus its evidence."""

    backend: str
    # Where the decision came from: "measured" (online autoselect),
    # "autotune" (offline benchmarks/autotune.py), "merged", "manual".
    source: str = "measured"
    # candidate -> median ms / jitter ms of the measurement that decided.
    median_ms: Optional[Dict[str, float]] = None
    jitter_ms: Optional[Dict[str, float]] = None
    rounds: int = 0
    timestamp: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None,)}

    @staticmethod
    def from_json(d: dict) -> "PlanEntry":
        if not isinstance(d, dict):
            raise ValueError(f"plan entry is not an object: {d!r}")
        fields = {f.name for f in dataclasses.fields(PlanEntry)}
        kept = {k: v for k, v in d.items() if k in fields}
        if "backend" not in kept or not isinstance(kept["backend"], str):
            raise ValueError(f"plan entry missing backend: {d!r}")
        # Hand-edited / foreign files may carry non-numeric timestamps or
        # rounds; coerce instead of letting a later merge comparison raise
        # (the never-crash contract covers every field, not just backend).
        if not isinstance(kept.get("timestamp", 0.0), (int, float)):
            kept["timestamp"] = 0.0
        if not isinstance(kept.get("rounds", 0), int):
            kept["rounds"] = 0
        if not isinstance(kept.get("source", ""), str):
            kept["source"] = "manual"
        for field in ("median_ms", "jitter_ms"):
            v = kept.get(field)
            if v is None:
                continue
            if not isinstance(v, dict):
                kept[field] = None
                continue
            kept[field] = {str(b): float(ms) for b, ms in v.items()
                           if isinstance(ms, (int, float))}
        return PlanEntry(**kept)


class PlanCache:
    """In-memory view of one plan file; see module docstring for rules."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self.entries: Dict[str, PlanEntry] = {}
        # Non-None when the backing file existed but could not be used
        # (corrupt JSON, wrong version, ...) — the silent-degrade marker.
        self.degraded_reason: Optional[str] = None

    # -- queries ---------------------------------------------------------

    def get(self, key: str) -> Optional[PlanEntry]:
        return self.entries.get(key)

    def put(self, key: str, entry: PlanEntry) -> None:
        if not entry.timestamp:
            entry.timestamp = time.time()
        self.entries[key] = entry

    def __len__(self) -> int:
        return len(self.entries)

    # -- persistence -----------------------------------------------------

    @classmethod
    def load(cls, path: Optional[str] = None) -> "PlanCache":
        """Read ``path`` (resolved via :func:`resolve_plan_path`).

        Never raises: any failure returns an empty cache whose
        ``degraded_reason`` says why, so ``"auto"`` degrades to static
        selection instead of crashing a training job.
        """
        path = resolve_plan_path(path)
        cache = cls(path)
        if not os.path.exists(path):
            return cache
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            cache.degraded_reason = f"unreadable plan file: {e}"
            return cache
        if not isinstance(data, dict):
            cache.degraded_reason = "plan file is not a JSON object"
            return cache
        if data.get("version") != PLAN_VERSION:
            cache.degraded_reason = (
                f"plan version {data.get('version')!r} != {PLAN_VERSION}")
            return cache
        entries = data.get("entries")
        if not isinstance(entries, dict):
            cache.degraded_reason = "plan file has no entries object"
            return cache
        for key, raw in entries.items():
            try:
                cache.entries[key] = PlanEntry.from_json(raw)
            except (TypeError, ValueError):
                # One bad entry must not poison the rest.
                continue
        return cache

    def to_json(self) -> dict:
        return {
            "version": PLAN_VERSION,
            "saved_at": time.time(),
            "entries": {k: e.to_json()
                        for k, e in sorted(self.entries.items())},
        }

    def save(self, path: Optional[str] = None, *,
             merge: bool = True) -> bool:
        """Atomically write the cache; by default merged with the file's
        current contents so concurrent writers keep each other's entries
        (newer timestamp wins a key conflict).  ``merge=False`` replaces
        the file outright — what prune/rewrite tools need, since a merge
        would resurrect the entries just dropped.  Returns False on
        failure (unwritable dir, ...) — persistence is best-effort by
        design.
        """
        path = resolve_plan_path(path or self.path)
        lock_file = None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # Serialize the load-merge-replace against other writers:
            # without the lock, two concurrent savers can each load a
            # snapshot missing the other's new key and the second
            # os.replace clobbers the first.  Best-effort — a platform
            # without flock just degrades to last-writer-wins.
            try:
                import fcntl

                lock_file = open(path + ".lock", "w")
                fcntl.flock(lock_file, fcntl.LOCK_EX)
            except (ImportError, OSError):
                lock_file = None
            if merge:
                merged = PlanCache.load(path)
                if merged.degraded_reason is None:
                    self.merge_from(merged)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                       prefix=".plan_tmp_")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(self.to_json(), f, indent=1, sort_keys=True)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            return False
        finally:
            if lock_file is not None:
                try:
                    lock_file.close()  # releases the flock
                except OSError:
                    pass
        self.path = path
        return True

    # -- maintenance (tuning/plan_tool.py) -------------------------------

    def merge_from(self, other: "PlanCache") -> int:
        """Union ``other``'s entries into this cache; on a key conflict
        the newer ``timestamp`` wins.  Returns the number adopted."""
        adopted = 0
        for key, entry in other.entries.items():
            mine = self.entries.get(key)
            if mine is None or entry.timestamp > mine.timestamp:
                self.entries[key] = entry
                adopted += 1
        return adopted

    def prune(self, keep: Callable[[str, PlanEntry], bool]) -> int:
        """Drop entries for which ``keep(key, entry)`` is false; returns
        the number dropped."""
        doomed = [k for k, e in self.entries.items() if not keep(k, e)]
        for k in doomed:
            del self.entries[k]
        return len(doomed)
