"""Tracing / profiling hooks.

The PyTorch counterpart of ``torchmpi_tpu/utils/tracing.py``: a step or a
collective can be annotated so ``torch.profiler`` traces show named
ranges, and a region can be captured as a Chrome trace (viewable in
``chrome://tracing`` or ui.perfetto.dev) with the card's kernels beside
the host's ranges.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator

import torch

_active = []  # the one profile this module has running, if any


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in profiler traces (``torch.profiler.record_function``);
    nearly free when no profiler runs."""
    with torch.profiler.record_function(name):
        yield


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "torchmpi_tpu_trace")


@contextlib.contextmanager
def trace(log_dir: str = None) -> Iterator[str]:
    """Capture a profiler trace around a code region, CPU ranges and (with
    a card) CUDA kernels, written on exit as ``<log_dir>/trace.json``, a
    Chrome trace.  Yields ``log_dir`` (default: ``torchmpi_tpu_trace``
    under the temporary directory).

    Robust to nested or failed starts, as the JAX package's (:23-54): one
    trace runs at a time, so a ``trace()`` inside another (or one whose
    profiler fails to start) runs its body unprofiled instead of raising,
    and the trace is stopped and exported only when OUR start succeeded,
    so a failed stop or export never masks the body's own exception."""
    log_dir = log_dir or _default_dir()
    os.makedirs(log_dir, exist_ok=True)
    prof = None
    if not _active:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            _active.append(prof)
        except RuntimeError:
            prof = None  # another profiler runs: the body runs unprofiled
    ok = False
    try:
        yield log_dir
        ok = True
    finally:
        if prof is not None:
            _active.remove(prof)
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except (RuntimeError, OSError):
                if ok:
                    raise
