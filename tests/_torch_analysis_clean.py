"""Clean near-miss programs for ``torchmpi_tpu_torch/analysis/tool.py``:
the same shapes as ``tests/_torch_analysis_bad.py`` with the hazard
removed, the counterparts of the JAX package's
``tests/fixtures_analysis_clean.py``.  The tool must exit 0 on this file.
Not a pytest module.
"""

import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.models.generate import clamp_slot_positions

_DEV = mpi.runtime.device()

_VEC = torch.zeros(8, 131072, device=_DEV)


def clean_data_dependent_cond(xs):
    """Both branches issue the SAME collective sequence; the test is
    data-derived, not rank-derived."""
    if xs.sum() > 0:
        return mpi.allreduce_rank_major(xs, axis_names="i")
    return mpi.allreduce_rank_major(2.0 * xs, axis_names="i")


def clean_bound_axis(xs):
    """Two collectives over a bound axis (JAX's pmax of a psum: the port
    reduces by sum or mean, so the outer one is a mean)."""
    return mpi.allreduce_rank_major(
        mpi.allreduce_rank_major(xs, axis_names="i"), op="mean",
        axis_names="i")


_CACHE = torch.zeros(4, 16, 8, device=_DEV)
_ROW = torch.zeros(4, 1, 8, device=_DEV)
_POS = torch.zeros(1, dtype=torch.long, device=_DEV)
_POS_ROWS = torch.zeros(4, dtype=torch.long, device=_DEV)


def clean_s1_clamped_cache_write(cache, row, pos):
    """The good half of the S1 pair: the position is clamped to
    ``[0, size - 1]`` before the write, so S1 certifies it."""
    pos = torch.clamp(pos, 0, cache.shape[1] - 1)
    for _ in range(2):
        cache[:, pos] = row
    return cache


def clean_s2_chokepoint_slot_write(cache, rows, pos_rows):
    """Per-row slot write through the clamp chokepoint: the helper both
    bounds the positions for S1 and leaves the record S2 looks for."""
    pos_rows = clamp_slot_positions(pos_rows, cache.shape[1])
    slots = torch.arange(cache.shape[0], device=cache.device)
    for _ in range(2):
        cache[slots, pos_rows] = rows
    return cache


LINT_TARGETS = [
    dict(fn=clean_data_dependent_cond, args=(_VEC,), comm={"i": 8},
         label="clean_cond"),
    dict(fn=clean_bound_axis, args=(_VEC,), comm={"i": 8},
         label="clean_bound"),
    dict(fn=clean_s1_clamped_cache_write, args=(_CACHE, _ROW, _POS),
         label="clean_s1"),
    dict(fn=clean_s2_chokepoint_slot_write,
         args=(_CACHE, torch.zeros(4, 8, device=_DEV), _POS_ROWS),
         label="clean_s2"),
]
