"""Seeded-bad programs for ``torchmpi_tpu_torch/analysis/tool.py``
(declared ``LINT_TARGETS``): the counterparts of the JAX package's
``tests/fixtures_analysis_bad.py``, one target for each of its four.
Each trips one rule, three of them error-severity, so the tool exits 1
on this file.  Not a pytest module: ``tests/test_torch_analysis.py``
drives the tool over it.

The collective targets take rank-major stacks [8, ...] under ``comm``
(the communicator the check pushes: JAX's ``axis_env``); the cache
targets are checked on their aten graph (``make_fx``, fake tensors).
The tool starts the runtime (on its ``--device``) before it loads
this file, which makes its tensors on ``runtime.device()``.
"""

import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import runtime

_DEV = mpi.runtime.device()

_VEC = torch.zeros(8, 128, device=_DEV)


def bad_d1_rank_divergent_collective(xs):
    """Rank-derived branch; the allreduce only on rank 0's side."""
    r = runtime.rank()
    if r == 0:
        xs = mpi.allreduce_rank_major(xs, axis_names="i")
    return xs


def bad_d2_unbound_axis(xs):
    """Collective over an axis no communicator binds."""
    return mpi.allreduce_rank_major(xs, axis_names="nonexistent_axis")


_CACHE = torch.zeros(4, 16, 8, device=_DEV)
_ROW = torch.zeros(4, 1, 8, device=_DEV)
_POS = torch.zeros(1, dtype=torch.long, device=_DEV)
_POS_ROWS = torch.zeros(4, dtype=torch.long, device=_DEV)


def bad_s1_unclamped_cache_write(cache, row, pos):
    """A data-dependent position written into the carried cache with NO
    bound: a negative one wraps silently onto the last rows, one past
    the end faults the card."""
    for _ in range(2):
        cache[:, pos] = row
    return cache


def bad_s2_inline_clip_slot_write(cache, rows, pos_rows):
    """Per-row slot write clamped with an inline ``torch.clamp`` instead
    of ``models.generate.clamp_slot_positions``: S1 holds, but no
    ``slot_clamp`` record exists, so S2 flags it (warning)."""
    pos_rows = torch.clamp(pos_rows, 0, cache.shape[1] - 1)
    slots = torch.arange(cache.shape[0], device=cache.device)
    for _ in range(2):
        cache[slots, pos_rows] = rows
    return cache


LINT_TARGETS = [
    dict(fn=bad_d1_rank_divergent_collective, args=(_VEC,),
         comm={"i": 8}, label="bad_d1"),
    dict(fn=bad_d2_unbound_axis, args=(_VEC,), comm={"i": 8},
         label="bad_d2"),
    dict(fn=bad_s1_unclamped_cache_write, args=(_CACHE, _ROW, _POS),
         label="bad_s1"),
    dict(fn=bad_s2_inline_clip_slot_write,
         args=(_CACHE, torch.zeros(4, 8, device=_DEV), _POS_ROWS),
         label="bad_s2"),
]
