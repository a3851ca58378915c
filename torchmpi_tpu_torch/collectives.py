"""Eager collectives on tensors: allreduce, broadcast, reduce_scatter,
allgather, their ``_in_axis`` forms, and their rank-major forms.

The PyTorch counterpart of ``torchmpi_tpu/collectives.py``.  The JAX package
drives every device from one controller, so its eager ``allreduce(x)`` takes
a rank-major stack ``x[i]`` = rank i's tensor.  Here each rank is a process
that holds its own tensor, the torch.distributed convention: ``allreduce(x)``
returns the reduction of every rank's ``x``, ``reduce_scatter(x)`` this
rank's tile of it and ``allgather(x)`` the stack of every rank's ``x``, as
the JAX package's in-axis verbs do inside a ``shard_map``.  The
``*_rank_major`` forms are the JAX package's eager ones: the n ranks'
tensors stacked on one device.  The calls are out of place: the caller's
tensor is never modified.
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


def _ring_world_of_one(rank_major_verb: str) -> None:
    """The ring across processes runs only in a world of one process (the
    ring of one member, JAX :926, :1028, :1092); a larger world raises."""
    if dist.get_world_size() > 1:
        raise NotImplementedError(
            "backend 'pallas' across processes: the ring's peers would be "
            "other processes' buffers, which needs CUDA IPC or symmetric "
            "memory on two or more cards (ROADMAP queue B); the ring runs "
            f"rank-major on one card ({rank_major_verb})")


def _ring_allreduce_(buf: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    _check_op(op)
    _ring_world_of_one("allreduce_rank_major")
    return ring.ring_allreduce(buf[None], op=op)[0]


def _check_tiles(x: torch.Tensor, n: int) -> None:
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(f"reduce_scatter needs a leading dim divisible by "
                         f"the group size {n}, got shape {tuple(x.shape)}")


def _check_sum(op: str) -> None:
    if op != "sum":
        raise ValueError(f"reduce_scatter supports op='sum', got {op!r}")


# torch >= 2.13 names them *_single; older releases *_tensor.
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _stock_reduce_scatter(x: torch.Tensor, *,
                          op: str = "sum") -> torch.Tensor:
    """This rank's tile of the sum over the world (the process group's
    reduce-scatter, tiled like ``lax.psum_scatter(tiled=True)``)."""
    _check_sum(op)
    n = dist.get_world_size()
    _check_tiles(x, n)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _reduce_scatter_single(out, x.contiguous())
    return out


def _stock_allgather(x: torch.Tensor) -> torch.Tensor:
    """The stack [n, ...] of every rank's ``x``; gathered into one flat
    buffer, the layout both NCCL and gloo take."""
    n = dist.get_world_size()
    out = x.new_empty(n * x.numel())
    _all_gather_single(out, x.contiguous().view(-1))
    return out.view((n,) + tuple(x.shape))


def _ring_reduce_scatter(x: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    _ring_world_of_one("reduce_scatter_rank_major")
    return ring.ring_reduce_scatter(x[None], op=op)[0]


def _ring_allgather(x: torch.Tensor) -> torch.Tensor:
    _ring_world_of_one("allgather_rank_major")
    return ring.ring_all_gather(x[None])[0]


def _stock_allreduce_rank_major(xs: torch.Tensor, *,
                                op: str = "sum") -> torch.Tensor:
    """The stock rank-major route: a sum over the rank axis in the stack's
    dtype, divided for mean, on every rank's slice."""
    _check_op(op)
    out = xs.sum(0, dtype=xs.dtype)
    if op == "mean":
        out = out / xs.shape[0]
    return out.expand_as(xs).clone()


def _stock_reduce_scatter_rank_major(xs: torch.Tensor, *,
                                     op: str = "sum") -> torch.Tensor:
    """The stock rank-major route: ``xs`` [n, k, ...] viewed [rank, tile,
    rest] and summed over the rank axis in the stack's dtype."""
    _check_sum(op)
    n = xs.shape[0]
    _check_tiles(xs[0], n)
    return xs.reshape(n, n, -1).sum(0, dtype=xs.dtype).reshape(
        n, xs.shape[1] // n, *xs.shape[2:])


def _stock_allgather_rank_major(shards: torch.Tensor) -> torch.Tensor:
    """The stock rank-major route: a copy of the stack for every rank."""
    return shards.unsqueeze(0).expand(shards.shape[0], *shards.shape).clone()


selector.register("allreduce", "xla", _stock_allreduce_)
selector.register("allreduce", "pallas", _ring_allreduce_)
selector.register("broadcast", "xla", _stock_broadcast_)
selector.register("reduce_scatter", "xla", _stock_reduce_scatter)
selector.register("reduce_scatter", "pallas", _ring_reduce_scatter)
selector.register("allgather", "xla", _stock_allgather)
selector.register("allgather", "pallas", _ring_allgather)
selector.register("allreduce_rank_major", "xla", _stock_allreduce_rank_major)
selector.register("allreduce_rank_major", "pallas", ring.ring_allreduce)
selector.register("reduce_scatter_rank_major", "xla",
                  _stock_reduce_scatter_rank_major)
selector.register("reduce_scatter_rank_major", "pallas",
                  ring.ring_reduce_scatter)
selector.register("allgather_rank_major", "xla", _stock_allgather_rank_major)
selector.register("allgather_rank_major", "pallas", ring.ring_all_gather)


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


def _rank_major(verb: str, xs, backend: Optional[str]):
    """The implementation of rank-major ``verb`` for ``xs`` [n, ...] (the
    selector's rules on one rank's bytes)."""
    if not isinstance(xs, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(xs).__name__}")
    if xs.dim() < 1 or xs.shape[0] < 1:
        raise ValueError(f"{verb}: leading (rank) axis must have length "
                         f">= 1; got shape {tuple(xs.shape)}")
    return selector.select(verb, backend, nbytes=_nbytes(xs[0]))


def allreduce_rank_major(xs: torch.Tensor, *, op: str = "sum",
                         backend: Optional[str] = None) -> torch.Tensor:
    """The JAX package's eager ``allreduce`` (:772): ``xs[i]`` is rank i's
    tensor, n = ``xs.shape[0]`` ranks, all on ``xs``'s device; every slice
    of the result is the sum (or mean) over ranks.  ``backend="pallas"``
    runs the ring kernels (``ops/ring.py``), ``"xla"`` a sum over the rank
    axis; the cutover and fallback rules are the selector's, on one rank's
    bytes."""
    return _rank_major("allreduce_rank_major", xs, backend)(xs, op=op)


def reduce_scatter_rank_major(xs: torch.Tensor, *, op: str = "sum",
                              backend: Optional[str] = None) -> torch.Tensor:
    """The JAX package's eager ``reduce_scatter`` (:806): ``xs[i]`` [k, ...]
    is rank i's tensor, k divisible by the n ranks; slice i of the result
    [n, k / n, ...] is tile i of the sum over ranks.  ``backend="pallas"``
    runs the ring reduce-scatter kernels, ``"xla"`` a sum over the rank
    axis of ``xs`` viewed [rank, tile, rest]."""
    return _rank_major("reduce_scatter_rank_major", xs, backend)(xs, op=op)


def allgather_rank_major(shards: torch.Tensor, *,
                         backend: Optional[str] = None) -> torch.Tensor:
    """The JAX package's eager ``allgather`` (:797): ``shards[i]`` is rank
    i's tensor; every slice of the result [n, n, ...] is the stack of all
    of them.  ``backend="pallas"`` runs the ring all-gather kernels,
    ``"xla"`` a copy of the stack per rank."""
    return _rank_major("allgather_rank_major", shards, backend)(shards)


def broadcast(x: torch.Tensor, *, root: int = 0,
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.broadcastTensor(root, t)``.  Returns rank
    ``root``'s ``x`` on every rank."""
    x = _check_tensor(x)
    return selector.select("broadcast", backend)(x.clone(), root=root)


def reduce_scatter(x: torch.Tensor, *, op: str = "sum",
                   backend: Optional[str] = None) -> torch.Tensor:
    """This rank's tile of the sum of every rank's ``x`` [k, ...], k
    divisible by the world size: [k / n, ...], rank r holding tile r
    (``lax.psum_scatter(tiled=True)``; sum only)."""
    x = _check_tensor(x)
    impl = selector.select("reduce_scatter", backend, nbytes=_nbytes(x))
    return impl(x, op=op)


def allgather(x: torch.Tensor, *,
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.allgatherTensor``.  The stack [n, ...] of every
    rank's ``x``, in rank order."""
    x = _check_tensor(x)
    return selector.select("allgather", backend, nbytes=_nbytes(x))(x)


def _world_axes(verb: str, axis_names: AxisNames) -> None:
    """The JAX package's in-axis verbs span named mesh axes; the port's
    only group is the world, so ``axis_names`` must be None or all of the
    world axes."""
    if axis_names is not None:
        axes = (axis_names,) if isinstance(axis_names, str) else tuple(
            axis_names)
        if sorted(axes) != sorted(WORLD_AXES):
            raise NotImplementedError(
                f"{verb} over {axes}: sub-communicators are not ported yet "
                "(ROADMAP queue A, item 1)")


def allreduce_in_axis(x: torch.Tensor, axis_names: AxisNames = None, *,
                      op: str = "sum",
                      backend: Optional[str] = None) -> torch.Tensor:
    """The in-step allreduce (stage B reduces its loss with it) over the
    world axes."""
    _world_axes("allreduce_in_axis", axis_names)
    return allreduce(x, op=op, backend=backend)


def reduce_scatter_in_axis(x: torch.Tensor, axis_names: AxisNames = None, *,
                           op: str = "sum",
                           backend: Optional[str] = None) -> torch.Tensor:
    """The in-step reduce-scatter (ZeRO's gradient leg) over the world
    axes: :func:`reduce_scatter`."""
    _world_axes("reduce_scatter_in_axis", axis_names)
    return reduce_scatter(x, op=op, backend=backend)


def allgather_in_axis(x: torch.Tensor, axis_names: AxisNames = None, *,
                      backend: Optional[str] = None) -> torch.Tensor:
    """The in-step all-gather (ZeRO's parameter leg) over the world axes:
    :func:`allgather`."""
    _world_axes("allgather_in_axis", axis_names)
    return allgather(x, backend=backend)
