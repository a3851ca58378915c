"""Shared plumbing for the port's example scripts.

The counterpart of the JAX package's ``examples/common.py``: the same
flags and defaults (``--devices``, ``--dcn``, ``--steps``, ``--batch-size``,
``--lr``, ``--momentum``, ``--backend``, ``--buckets``, ``--seed``), plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU, gloo).  The
examples run as a world of one process, or one rank per process under
``torchrun`` (``runtime.init`` reads ``RANK`` / ``WORLD_SIZE``); each rank
takes its slice of every global batch.  ``--devices N`` (N >= 2) runs N
ranks rank-major on the one device instead, the port's form of the JAX
examples' N simulated devices (``--backend pallas`` then runs the ring
kernels).  ``--buckets`` sets ``Config.gradsync_buckets`` (the bucketed
gradient allreduce).  Flags whose machinery is not ported raise naming
their ROADMAP item: ``--dcn`` and ``--backend hierarchical`` (queue A,
item 4).

Short runs (under 60 steps) stop before convergence, so the accuracy bar
of each example holds from 60 steps on (JAX ``mnist_allreduce.py`` :155).
"""

from __future__ import annotations

import argparse
import time
from contextlib import contextmanager
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

import torchmpi_tpu_torch as mpi

FULL_RUN_STEPS = 60


def parse_args(description: str, argv: Optional[Sequence[str]] = None,
               defaults: Optional[dict] = None, **extra):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--devices", type=int, default=0,
                   help="N ranks rank-major on the one device (0 = one "
                        "rank per process)")
    p.add_argument("--dcn", type=int, default=None,
                   help="outer (inter-node) axis size: not ported")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--backend", type=str, default=None,
                   choices=[None, "xla", "hierarchical", "pallas"])
    p.add_argument("--buckets", type=int, default=None,
                   help="gradient allreduce buckets (Config.gradsync_"
                        "buckets)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    for name, kw in extra.items():
        p.add_argument(f"--{name.replace('_', '-')}", **kw)
    if defaults:
        p.set_defaults(**defaults)
    args = p.parse_args(argv)
    if args.dcn is not None or args.backend == "hierarchical":
        raise NotImplementedError(
            "--dcn / --backend hierarchical: the two-level collectives are "
            "not ported yet (ROADMAP queue A, item 4)")
    if args.devices == 1:
        args.devices = 0
    return args


@contextmanager
def runtime(args) -> Iterator[torch.device]:
    """The runtime on ``args.device`` for the example's duration: started
    here (and stopped at the end) unless the caller already started it;
    ``--backend`` and ``--buckets`` applied as the JAX examples apply
    them (the knobs restored at the end in a runtime the caller owns)."""
    started = not mpi.is_initialized()
    dev = mpi.init(device=args.device)
    before = mpi.config()
    knobs = {}
    if args.backend:
        knobs.update(backend=args.backend, custom_min_bytes=0)
    if args.buckets is not None:
        knobs.update(gradsync_buckets=args.buckets)
    if knobs:
        mpi.set_config(**knobs)
    try:
        yield dev
    finally:
        if started:
            mpi.stop()
        elif knobs:
            mpi.set_config(**{k: getattr(before, k) for k in knobs})


def local_slice(xb: np.ndarray, yb: np.ndarray, *, rank_major: bool):
    """This process's slice of a global batch (all of it rank-major or in
    a world of one)."""
    if rank_major or mpi.size() == 1:
        return xb, yb
    b = xb.shape[0] // mpi.size()
    lo = mpi.rank() * b
    return xb[lo:lo + b], yb[lo:lo + b]


def to_device(xb: np.ndarray, yb: np.ndarray, dev: torch.device):
    """NHWC numpy images as NCHW on ``dev`` (channels-last memory, no
    copy on the device), labels as int64."""
    x = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
    return x.permute(0, 3, 1, 2), torch.from_numpy(yb).to(dev).long()


@torch.no_grad()
def evaluate(model, images: np.ndarray, labels: np.ndarray,
             dev: torch.device, batch: int = 512, **kw) -> float:
    correct = 0
    for i in range(0, len(images), batch):
        x, y = to_device(images[i:i + batch], labels[i:i + batch], dev)
        correct += int((model(x, **kw).argmax(1) == y).sum())
    return correct / len(images)


def check_accuracy(acc: float, bar: float, steps: int, what: str) -> None:
    """The example's convergence bar, held on full-length runs."""
    if steps >= FULL_RUN_STEPS and not acc > bar:
        raise AssertionError(f"{what} did not converge: accuracy {acc:.3f} "
                             f"<= {bar}")


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    """Images a second over the timed steps; waits for the card."""

    def __init__(self, dev: torch.device):
        self.dev, self.t0, self.steps = dev, None, 0

    def start(self):
        sync(self.dev)
        self.t0 = time.perf_counter()

    def tick(self):
        self.steps += 1

    def rate(self, batch_size: int) -> float:
        sync(self.dev)
        dt = time.perf_counter() - self.t0
        return self.steps * batch_size / dt if dt > 0 else float("inf")
