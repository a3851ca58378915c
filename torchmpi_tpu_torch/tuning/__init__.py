"""Tuning subsystem: persistent, topology-keyed collective plans.

The PyTorch counterpart of ``torchmpi_tpu/tuning/`` (:20-55).  TorchMPI's
``collectiveSelector`` picked an implementation from hand-tuned constants
(here ``Config.custom_min_bytes``, carried over from the TPU); this
package replaces the constants with a measured, persisted, per-topology
plan database behind ``backend="auto"``:

- :mod:`fingerprint`: the key space (platform, grid, op, dtype, log2 size
  bucket);
- :mod:`plancache`: the versioned JSON plan DB with atomic writes,
  concurrent-writer merge, and never-crash load semantics;
- :mod:`measure`: the noise-gated median measurement;
- :mod:`autoselect`: the online ``backend="auto"`` mode: the first eager
  call of an uncached key measures, caches and persists; every later call
  (this process or any future one) replays the plan;
- :mod:`plan_tool`: ``python -m torchmpi_tpu_torch.tuning.plan_tool
  show | merge | prune`` over plan files.
"""

from . import autoselect, fingerprint, measure, plancache  # noqa: F401
from .fingerprint import fingerprint as make_fingerprint  # noqa: F401
from .fingerprint import Grid, bucket_bytes, mesh_key, size_bucket  # noqa: F401
from .plancache import (  # noqa: F401
    DEFAULT_PLAN_PATH,
    PLAN_VERSION,
    PlanCache,
    PlanEntry,
    resolve_plan_path,
)
from .measure import measure as measure_step, noise_gate  # noqa: F401
from .autoselect import (  # noqa: F401
    DEFAULT_BACKEND,
    configure,
    decisions,
    is_active,
    measurement_count,
    plan,
    plan_bucket_bytes,
    plan_lookup,
    reset,
    reset_measurement_count,
    resolve_eager,
    set_decision_logger,
)

__all__ = [
    "fingerprint", "measure", "plancache", "autoselect",
    "make_fingerprint", "Grid", "size_bucket", "bucket_bytes", "mesh_key",
    "PLAN_VERSION", "DEFAULT_PLAN_PATH", "PlanCache", "PlanEntry",
    "resolve_plan_path", "measure_step", "noise_gate",
    "configure", "reset", "is_active", "plan", "plan_lookup",
    "resolve_eager", "plan_bucket_bytes", "decisions",
    "set_decision_logger",
    "measurement_count", "reset_measurement_count", "DEFAULT_BACKEND",
]
