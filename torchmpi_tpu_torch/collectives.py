"""Eager collectives on tensors: allreduce, broadcast, allreduce_in_axis,
allreduce_rank_major.

The PyTorch counterpart of ``torchmpi_tpu/collectives.py``.  The JAX package
drives every device from one controller, so its eager ``allreduce(x)`` takes
a rank-major stack ``x[i]`` = rank i's tensor.  Here each rank is a process
that holds its own tensor, the torch.distributed convention: ``allreduce(x)``
returns the reduction of every rank's ``x``.  ``allreduce_rank_major(xs)``
is the JAX package's eager form: the n ranks' tensors stacked on one device.
The calls are out of place: the caller's tensor is never modified.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from . import runtime, selector
from .ops import ring

AxisNames = Union[str, Sequence[str], None]

# The JAX package's world mesh axes; in the port both name the world group.
WORLD_AXES = ("dcn", "ici")


def _check_op(op: str) -> None:
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")


def _stock_allreduce_(buf: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """In place on ``buf``: SUM over the world, then divide for mean (gloo
    has no AVG, and one rule on both backends keeps them alike)."""
    _check_op(op)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    if op == "mean":
        n = dist.get_world_size()
        if n > 1:
            buf.div_(n)
    return buf


def _stock_broadcast_(buf: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    dist.broadcast(buf, src=root)
    return buf


def _ring_allreduce_(buf: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """The ring across processes: a world of one returns ``buf`` itself (the
    ring of one member, JAX :926); a larger world raises."""
    _check_op(op)
    if dist.get_world_size() > 1:
        raise NotImplementedError(
            "backend 'pallas' across processes: the ring's peers would be "
            "other processes' buffers, which needs CUDA IPC or symmetric "
            "memory on two or more cards (ROADMAP queue B); the ring runs "
            "rank-major on one card (allreduce_rank_major)")
    return ring.ring_allreduce(buf[None], op=op)[0]


def _stock_allreduce_rank_major(xs: torch.Tensor, *,
                                op: str = "sum") -> torch.Tensor:
    """The stock rank-major route: a sum over the rank axis in the stack's
    dtype, divided for mean, on every rank's slice."""
    _check_op(op)
    out = xs.sum(0, dtype=xs.dtype)
    if op == "mean":
        out = out / xs.shape[0]
    return out.expand_as(xs).clone()


selector.register("allreduce", "xla", _stock_allreduce_)
selector.register("allreduce", "pallas", _ring_allreduce_)
selector.register("broadcast", "xla", _stock_broadcast_)
selector.register("allreduce_rank_major", "xla", _stock_allreduce_rank_major)
selector.register("allreduce_rank_major", "pallas", ring.ring_allreduce)


def _check_tensor(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    runtime._require_init()
    if x.device.type != runtime.device().type:
        raise ValueError(f"tensor on {x.device}, runtime on "
                         f"{runtime.device()}")
    return x


def allreduce(x: torch.Tensor, *, op: str = "sum",
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.allreduceTensor``.  Returns the sum (or mean) of
    every rank's ``x``."""
    x = _check_tensor(x)
    impl = selector.select("allreduce", backend, nbytes=_nbytes(x))
    return impl(x.clone(), op=op)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def allreduce_rank_major(xs: torch.Tensor, *, op: str = "sum",
                         backend: Optional[str] = None) -> torch.Tensor:
    """The JAX package's eager ``allreduce`` (:772): ``xs[i]`` is rank i's
    tensor, n = ``xs.shape[0]`` ranks, all on ``xs``'s device; every slice
    of the result is the sum (or mean) over ranks.  ``backend="pallas"``
    runs the ring kernels (``ops/ring.py``), ``"xla"`` a sum over the rank
    axis; the cutover and fallback rules are the selector's, on one rank's
    bytes."""
    if not isinstance(xs, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(xs).__name__}")
    if xs.dim() < 1 or xs.shape[0] < 1:
        raise ValueError(f"allreduce_rank_major: leading (rank) axis must "
                         f"have length >= 1; got shape {tuple(xs.shape)}")
    impl = selector.select("allreduce_rank_major", backend,
                           nbytes=_nbytes(xs[0]))
    return impl(xs, op=op)


def broadcast(x: torch.Tensor, *, root: int = 0,
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.broadcastTensor(root, t)``.  Returns rank
    ``root``'s ``x`` on every rank."""
    x = _check_tensor(x)
    return selector.select("broadcast", backend)(x.clone(), root=root)


def allreduce_in_axis(x: torch.Tensor, axis_names: AxisNames = None, *,
                      op: str = "sum",
                      backend: Optional[str] = None) -> torch.Tensor:
    """The in-step allreduce (stage B reduces its loss with it).  The JAX
    package reduces over named mesh axes; the port's only group is the
    world, so ``axis_names`` must be None or all of the world axes."""
    if axis_names is not None:
        axes = (axis_names,) if isinstance(axis_names, str) else tuple(
            axis_names)
        if sorted(axes) != sorted(WORLD_AXES):
            raise NotImplementedError(
                f"allreduce_in_axis over {axes}: sub-communicators are not "
                "ported yet (ROADMAP queue A, item 1)")
    return allreduce(x, op=op, backend=backend)
