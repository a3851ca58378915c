"""Eager collectives on tensors: the nine verbs (allreduce, broadcast,
reduce, allgather, reduce_scatter, gather, scatter, sendreceive, alltoall),
their ``_in_axis`` forms, their rank-major forms, the host-staged path and
the asynchronous facade.

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

Every verb is registered under ``"xla"`` (the process group's own backend
across processes, the closed form over a rank-major stack); allreduce,
reduce_scatter and allgather also under ``"pallas"``, the ring kernels, as
in the JAX package (:297; ``ops/ring.py`` :966, :1118-1119); six under
``"hierarchical"`` (``parallel/hierarchical.py``).  The world is the
(dcn, ici) grid of ``runtime.py``: the in-axis verbs span both axes, or
one of them (``"dcn"`` or ``"ici"``: this process's subgroup), and the
rank-major verbs take ``axis_names`` the same way, over the sub-stacks of
the grid of n.  The
rank-major closed forms are the JAX package's ``_host_staged`` (:497-560):
non-root slices unchanged by ``reduce``, zeros for ``gather``, ``scatter``
raising on an indivisible leading dim, ``alltoall`` tiled over
``split_axis`` / ``concat_axis``.  A sum over ranks is a left fold in rank
order in the stack's dtype, so it gives the same bits on every device and
for every bucket layout; ``mean`` divides the sum (an integer mean is
float32).

Staged mode (``Config.staged``, ``staged=True`` or ``backend="host"``, the
reference's staged collectives): the rank-major stack goes device ->
pinned host, the closed form runs on the host CPU, and the result goes
back to the device: the same answer op for op, dtype included.

Every dispatch goes through its plan (``planner.py``): the route (the
Config's backend, the selector's rules, and under ``"auto"`` the tuning
plans' measured choice) and a tree's fused layout are decided on the
first call of a structure and replayed after;
:func:`clear_cache` drops the plans.  With ``planner.set_enabled(False)``
each call derives them again (the unplanned path, the same bits).

The asynchronous facade (``async_.<verb>`` rank-major, ``async_in_axis.
<verb>`` across processes) returns an :class:`AsyncHandle`.  A direct
rank-major collective is enqueued on a side CUDA stream after the caller's
stream; a process-world one is ``torch.distributed``'s ``async_op=True``
work; a staged one runs on one worker thread.  ``wait()`` returns the
result with the caller's current stream ordered after it (no host block
for the direct flavours).  The JAX package's watchdog, telemetry and
flight-recorder hooks of ``wait()`` are not ported (ROADMAP queue A, item
10).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from . import _tree, fusion, planner, runtime, selector
from .ops import ring

AxisNames = Union[str, Sequence[str], None]

# The JAX package's world mesh axes, the port's grid (runtime.py).
WORLD_AXES = ("dcn", "ici")


class PeerTimeoutError(RuntimeError):
    """A wait exceeded its deadline (the JAX package's
    ``faults/policy.py`` :72, without the flight-recorder tail, which
    belongs to the telemetry layer, ROADMAP queue A, item 10)."""

    def __init__(self, site: str, *, peer: str = "", elapsed_s: float = 0.0,
                 deadline_s: float = 0.0,
                 last_error: Optional[BaseException] = None):
        self.site = site
        self.peer = peer
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        self.last_error = last_error
        peer_s = f" (peer {peer})" if peer else ""
        super().__init__(
            f"{site}{peer_s}: no progress within {deadline_s:.3g}s "
            f"deadline (elapsed {elapsed_s:.3g}s, "
            f"last error: {last_error!r})")


def _check_op(op: str) -> None:
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")


def _check_sum(op: str) -> None:
    if op != "sum":
        raise ValueError(f"reduce_scatter supports op='sum', got {op!r}")


def _check_tiles(x: torch.Tensor, n: int, verb: str = "reduce_scatter"
                 ) -> None:
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(f"{verb} needs a leading dim divisible by the "
                         f"group size {n}, got shape {tuple(x.shape)}")


def _mean_of(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` (float32 for an integer total, as ``lax.pmean``)."""
    return total / n


# ---------------------------------------------------------------------------
# Across processes: the process group's verbs ("xla")
# ---------------------------------------------------------------------------


class _Pending:
    """A process-group collective in flight: its ``torch.distributed``
    works and the function that makes the result once they complete."""

    __slots__ = ("works", "finish")

    def __init__(self, works: List, finish: Callable[[], torch.Tensor]):
        self.works = works
        self.finish = finish

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.finish()


def _issue(async_op: bool, works: List, finish: Callable):
    """The pending collective (``async_op``) or its result: ``Work.wait()``
    orders the current stream after a NCCL collective without blocking
    the host."""
    pending = _Pending([w for w in works if w is not None], finish)
    return pending if async_op else pending.wait()


def _global(group, r: int) -> int:
    """Global rank of member ``r`` of ``group`` (None: the world)."""
    return r if group is None else dist.get_global_rank(group, r)


def _stock_allreduce_(buf: torch.Tensor, *, op: str = "sum",
                      async_op: bool = False, group=None):
    """In place on ``buf``: SUM over the world (or ``group``), then divide
    for mean (gloo has no AVG, and one rule on both backends keeps them
    alike)."""
    _check_op(op)
    n = dist.get_world_size(group)
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                           async_op=True)

    def finish():
        if op != "mean":
            return buf
        if not buf.is_floating_point():
            return _mean_of(buf, n)
        return buf.div_(n) if n > 1 else buf
    return _issue(async_op, [work], finish)


def _stock_broadcast_(buf: torch.Tensor, *, root: int = 0,
                      async_op: bool = False, group=None):
    return _issue(async_op, [dist.broadcast(buf, src=_global(group, root),
                                            group=group, async_op=True)],
                  lambda: buf)


def _stock_reduce(x: torch.Tensor, *, root: int = 0, op: str = "sum",
                  async_op: bool = False, group=None):
    """Rank ``root`` gets the sum (or mean) of every rank's ``x``; every
    other rank keeps its own (MPI_Reduce), in the result's dtype."""
    _check_op(op)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    buf = x.clone()
    work = dist.reduce(buf, dst=_global(group, root), op=dist.ReduceOp.SUM,
                       group=group, async_op=True)

    def finish():
        out = buf if me == root else x.clone()
        if op == "mean":
            return _mean_of(out, n) if me == root else (
                out if out.is_floating_point() else out.float())
        return out
    return _issue(async_op, [work], finish)


def _stock_reduce_scatter(x: torch.Tensor, *, op: str = "sum",
                          async_op: bool = False, group=None):
    """This rank's tile of the sum over the world (the process group's
    reduce-scatter, tiled like ``lax.psum_scatter(tiled=True)``)."""
    _check_sum(op)
    n = dist.get_world_size(group)
    _check_tiles(x, n)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    work = _reduce_scatter_single(out, x.contiguous(), group=group,
                                  async_op=True)
    return _issue(async_op, [work], lambda: out)


def _stock_allgather(x: torch.Tensor, *, async_op: bool = False,
                     group=None):
    """The stack [n, ...] of every rank's ``x``; gathered into one flat
    buffer, the layout both NCCL and gloo take."""
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    work = _all_gather_single(out, x.contiguous().view(-1), group=group,
                              async_op=True)
    return _issue(async_op, [work],
                  lambda: out.view((n,) + tuple(x.shape)))


def _stock_gather(x: torch.Tensor, *, root: int = 0,
                  async_op: bool = False, group=None):
    """Rank ``root`` gets the stack [n, ...] of every rank's ``x``; the
    other ranks get zeros of that shape (the JAX package's defined analog
    of MPI's untouched non-root buffers)."""
    n = dist.get_world_size(group)
    out = x.new_zeros((n,) + tuple(x.shape))
    gather_list = (list(out.unbind(0)) if dist.get_rank(group) == root
                   else None)
    work = dist.gather(x.contiguous(), gather_list,
                       dst=_global(group, root), group=group, async_op=True)
    return _issue(async_op, [work], lambda: out)


def _stock_scatter(x: torch.Tensor, *, root: int = 0,
                   async_op: bool = False, group=None):
    """Rank i gets tile i of rank ``root``'s ``x`` [k, ...] (k divisible by
    the world size): [k / n, ...] (MPI_Scatter)."""
    n = dist.get_world_size(group)
    _check_tiles(x, n, "scatter")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    tiles = (list(x.contiguous().chunk(n)) if dist.get_rank(group) == root
             else None)
    work = dist.scatter(out, tiles, src=_global(group, root), group=group,
                        async_op=True)
    return _issue(async_op, [work], lambda: out)


def _stock_sendreceive(x: torch.Tensor, *, src: int, dst: int,
                       async_op: bool = False, group=None):
    """Rank ``dst`` gets rank ``src``'s ``x``; every other rank keeps its
    own (``mpi.sendreceiveTensor``)."""
    rank = dist.get_rank(group)
    if src == dst or rank not in (src, dst):
        out = x.clone()
        return _issue(async_op, [], lambda: out)
    if rank == src:
        out = x.clone()
        return _issue(async_op, [dist.isend(out, _global(group, dst))],
                      lambda: out)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    return _issue(async_op, [dist.irecv(out, _global(group, src))],
                  lambda: out)


def _stock_alltoall(x: torch.Tensor, *, split_axis: int = 0,
                    concat_axis: int = 0, async_op: bool = False,
                    group=None):
    """Rank i gets every rank's i-th piece of ``x`` split n ways along
    ``split_axis``, concatenated in rank order along ``concat_axis``
    (the tiled ``lax.all_to_all``)."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall needs dim {split_axis} divisible by the "
                         f"group size {n}, got shape {tuple(x.shape)}")
    send = torch.stack(x.chunk(n, dim=split_axis))
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return _issue(async_op, [work],
                  lambda: torch.cat(recv.unbind(0), dim=concat_axis))


# torch >= 2.13 names them *_single; older releases *_tensor.
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _ring_world_of_one(rank_major_verb: str, group=None) -> None:
    """The ring across processes runs only in a world (or group) of one
    process (the ring of one member, JAX :926, :1028, :1092); a larger one
    raises."""
    if dist.get_world_size(group) > 1:
        raise NotImplementedError(
            "backend 'pallas' across processes: the ring's peers would be "
            "other processes' buffers, which needs CUDA IPC or symmetric "
            "memory on two or more cards (ROADMAP queue B); the ring runs "
            f"rank-major on one card ({rank_major_verb})")


def _ring_allreduce_(buf: torch.Tensor, *, op: str = "sum",
                     group=None) -> torch.Tensor:
    _check_op(op)
    _ring_world_of_one("allreduce_rank_major", group)
    return ring.ring_allreduce(buf[None], op=op)[0]


def _ring_reduce_scatter(x: torch.Tensor, *, op: str = "sum",
                         group=None) -> torch.Tensor:
    _ring_world_of_one("reduce_scatter_rank_major", group)
    return ring.ring_reduce_scatter(x[None], op=op)[0]


def _ring_allgather(x: torch.Tensor, *, group=None) -> torch.Tensor:
    _ring_world_of_one("allgather_rank_major", group)
    return ring.ring_all_gather(x[None])[0]


# ---------------------------------------------------------------------------
# Rank-major closed forms ("xla" over a stack, and the staged host compute)
# ---------------------------------------------------------------------------


def _fold_ranks(xs) -> torch.Tensor:
    """The sum over the rank axis of ``xs`` [n, ...] (or of a sequence of n
    tensors) in its dtype, as a left fold in rank order: elementwise adds,
    so the same bits on every device and in every bucket layout."""
    acc = xs[0].clone()
    for r in range(1, len(xs)):
        acc += xs[r]
    return acc


def _reduced(xs: torch.Tensor, op: str) -> torch.Tensor:
    """The reduction over the rank axis: the left fold for sum and mean,
    the elementwise extreme for max and min (the JAX package's
    ``_host_staged`` :492-493)."""
    if op in ("max", "min"):
        return xs.amax(0) if op == "max" else xs.amin(0)
    _check_op(op)
    total = _fold_ranks(xs)
    return _mean_of(total, xs.shape[0]) if op == "mean" else total


def _stock_allreduce_rank_major(xs: torch.Tensor, *,
                                op: str = "sum") -> torch.Tensor:
    """Every rank's slice is the sum (or mean, max, min) over ranks."""
    return _reduced(xs, op).expand(xs.shape[0], *xs.shape[1:]).clone()


def _stock_broadcast_rank_major(xs: torch.Tensor, *,
                                root: int = 0) -> torch.Tensor:
    return xs[root].expand_as(xs).clone()


def _stock_reduce_rank_major(xs: torch.Tensor, *, root: int = 0,
                             op: str = "sum") -> torch.Tensor:
    """Slice ``root`` is the sum (or mean, max, min) over ranks, the others
    are unchanged (in the result's dtype: float32 for an integer mean)."""
    red = _reduced(xs, op)
    out = xs.to(red.dtype, copy=True)
    out[root] = red
    return out


def _stock_reduce_scatter_rank_major(xs: torch.Tensor, *,
                                     op: str = "sum") -> torch.Tensor:
    """Slice i is tile i of the sum over ranks of ``xs`` [n, k, ...]."""
    _check_sum(op)
    n = xs.shape[0]
    _check_tiles(xs[0], n)
    return _fold_ranks(xs).reshape(n, xs.shape[1] // n, *xs.shape[2:])


def _stock_allgather_rank_major(shards: torch.Tensor) -> torch.Tensor:
    """A copy of the stack for every rank."""
    return shards.unsqueeze(0).expand(shards.shape[0], *shards.shape).clone()


def _stock_gather_rank_major(xs: torch.Tensor, *,
                             root: int = 0) -> torch.Tensor:
    """Slice ``root`` is the stack, the others zeros: [n, n, ...]."""
    out = xs.new_zeros((xs.shape[0],) + tuple(xs.shape))
    out[root] = xs
    return out


def _stock_scatter_rank_major(xs: torch.Tensor, *,
                              root: int = 0) -> torch.Tensor:
    """Slice i is tile i of ``xs[root]`` [k, ...]: [n, k / n, ...]."""
    n = xs.shape[0]
    if xs.dim() < 2 or xs.shape[1] % n:
        raise ValueError(f"scatter needs a leading dim divisible by the "
                         f"group size: {tuple(xs.shape[1:])} over {n}")
    return xs[root].reshape(n, xs.shape[1] // n, *xs.shape[2:]).clone()


def _stock_sendreceive_rank_major(xs: torch.Tensor, *, src: int = 0,
                                  dst: int = 1) -> torch.Tensor:
    out = xs.clone()
    out[dst] = xs[src]
    return out


def _stock_alltoall_rank_major(xs: torch.Tensor, *, split_axis: int = 0,
                               concat_axis: int = 0) -> torch.Tensor:
    """Slice i is every rank's i-th piece (split n ways along
    ``split_axis``), concatenated in rank order along ``concat_axis``."""
    n = xs.shape[0]
    if xs.shape[split_axis + 1] % n:
        raise ValueError(f"alltoall needs dim {split_axis} divisible by the "
                         f"group size {n}, got {tuple(xs.shape[1:])}")
    pieces = xs.chunk(n, dim=split_axis + 1)
    return torch.stack([torch.cat([pieces[i][j] for j in range(n)],
                                  dim=concat_axis) for i in range(n)])


CLOSED_FORMS: Dict[str, Callable] = {
    "allreduce": _stock_allreduce_rank_major,
    "broadcast": _stock_broadcast_rank_major,
    "reduce": _stock_reduce_rank_major,
    "allgather": _stock_allgather_rank_major,
    "reduce_scatter": _stock_reduce_scatter_rank_major,
    "gather": _stock_gather_rank_major,
    "scatter": _stock_scatter_rank_major,
    "sendreceive": _stock_sendreceive_rank_major,
    "alltoall": _stock_alltoall_rank_major,
}
VERBS = tuple(CLOSED_FORMS)

_WORLD_STOCK = {
    "allreduce": _stock_allreduce_,
    "broadcast": _stock_broadcast_,
    "reduce": _stock_reduce,
    "allgather": _stock_allgather,
    "reduce_scatter": _stock_reduce_scatter,
    "gather": _stock_gather,
    "scatter": _stock_scatter,
    "sendreceive": _stock_sendreceive,
    "alltoall": _stock_alltoall,
}
# The process-world verbs whose implementation works in place on a copy.
_IN_PLACE = ("allreduce", "broadcast")

for _verb in VERBS:
    selector.register(_verb, "xla", _WORLD_STOCK[_verb])
    selector.register(f"{_verb}_rank_major", "xla", CLOSED_FORMS[_verb])
selector.register("allreduce", "pallas", _ring_allreduce_)
selector.register("reduce_scatter", "pallas", _ring_reduce_scatter)
selector.register("allgather", "pallas", _ring_allgather)
selector.register("allreduce_rank_major", "pallas", ring.ring_allreduce)
selector.register("reduce_scatter_rank_major", "pallas",
                  ring.ring_reduce_scatter)
selector.register("allgather_rank_major", "pallas", ring.ring_all_gather)
# The hierarchical backend's rank-major data movement: on one device it has
# no levels, so it is the stock closed form (the two-level allreduce and
# reduce, whose fold order and mean differ, are parallel/hierarchical.py's).
for _verb in ("broadcast", "allgather", "gather", "scatter"):
    selector.register(f"{_verb}_rank_major", "hierarchical",
                      CLOSED_FORMS[_verb])


def clear_cache() -> None:
    """Drop every collective plan: the one invalidation point
    (``planner.invalidate``, JAX :470-476)."""
    planner.invalidate()


# ---------------------------------------------------------------------------
# Process-world verbs
# ---------------------------------------------------------------------------


def _check_tensor(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    runtime._require_init()
    if x.device.type != runtime.device().type:
        raise ValueError(f"tensor on {x.device}, runtime on "
                         f"{runtime.device()}")
    return x


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _world(verb: str, x, backend: Optional[str], params: dict, *,
           async_op: bool = False, axis: Optional[str] = None,
           owned: bool = False):
    """Process-world ``verb`` on this rank's ``x``: its plan's
    implementation (``planner.plan_world``; with the planner off, the
    selector's for its bytes), run by :func:`_world_run`."""
    x = _check_tensor(x)
    if planner.enabled():
        return planner.plan_world(verb, x, backend, params, axis).replay(
            x, async_op=async_op, owned=owned)
    impl = selector.select(verb, backend, nbytes=_nbytes(x),
                           n_dcn=None if axis is None else 1, dtype=x.dtype,
                           device=x.device,
                           axes=None if axis is None else (axis,))
    return _world_run(verb, impl, x, params, async_op=async_op, axis=axis,
                      owned=owned)


def _world_run(verb: str, impl: Callable, x: torch.Tensor, params: dict,
               *, async_op: bool = False, axis: Optional[str] = None,
               owned: bool = False):
    """``impl`` of process-world ``verb`` on ``x`` (the in-place ones on a
    copy, unless the caller ``owned`` ``x``).  ``axis`` ("dcn" or "ici")
    runs it on that axis's subgroup (an axis of one member computes the
    closed form here; the hierarchical backend spans both axes, so it
    falls back there).  With ``async_op`` the process group's work in
    flight (a :class:`_Pending`), or the result of an implementation that
    has no asynchronous form."""
    if axis is not None:
        if runtime.grid()[0 if axis == "dcn" else 1] == 1:
            return CLOSED_FORMS[verb](x[None], **params)[0]
        params = dict(params, group=runtime.group(axis))
    arg = x.clone() if verb in _IN_PLACE and not owned else x
    if async_op and impl is _WORLD_STOCK[verb]:
        return impl(arg, async_op=True, **params)
    return impl(arg, **params)


def allreduce(x: torch.Tensor, *, op: str = "sum",
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.allreduceTensor``.  Returns the sum (or mean) of
    every rank's ``x``."""
    return _world("allreduce", x, backend, {"op": op})


def broadcast(x: torch.Tensor, *, root: int = 0,
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.broadcastTensor(root, t)``.  Returns rank
    ``root``'s ``x`` on every rank."""
    return _world("broadcast", x, backend, {"root": root})


def reduce(x: torch.Tensor, *, root: int = 0, op: str = "sum",
           backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.reduceTensor(root, t)``.  Rank ``root`` gets the
    sum (or mean) of every rank's ``x``; the others keep their own."""
    return _world("reduce", x, backend, {"root": root, "op": op})


def reduce_scatter(x: torch.Tensor, *, op: str = "sum",
                   backend: Optional[str] = None) -> torch.Tensor:
    """This rank's tile of the sum of every rank's ``x`` [k, ...], k
    divisible by the world size: [k / n, ...], rank r holding tile r
    (``lax.psum_scatter(tiled=True)``; sum only)."""
    return _world("reduce_scatter", x, backend, {"op": op})


def allgather(x: torch.Tensor, *,
              backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.allgatherTensor``.  The stack [n, ...] of every
    rank's ``x``, in rank order."""
    return _world("allgather", x, backend, {})


def gather(x: torch.Tensor, *, root: int = 0,
           backend: Optional[str] = None) -> torch.Tensor:
    """MPI_Gather: rank ``root`` gets the stack [n, ...] of every rank's
    ``x``, the other ranks zeros of that shape."""
    return _world("gather", x, backend, {"root": root})


def scatter(x: torch.Tensor, *, root: int = 0,
            backend: Optional[str] = None) -> torch.Tensor:
    """MPI_Scatter: rank i gets tile i of rank ``root``'s ``x`` [k, ...],
    k divisible by the world size: [k / n, ...]."""
    return _world("scatter", x, backend, {"root": root})


def sendreceive(x: torch.Tensor, *, src: int, dst: int,
                backend: Optional[str] = None) -> torch.Tensor:
    """Reference: ``mpi.sendreceiveTensor``: rank ``dst`` gets rank
    ``src``'s ``x``, every other rank keeps its own."""
    return _world("sendreceive", x, backend, {"src": src, "dst": dst})


def alltoall(x: torch.Tensor, *, split_axis: int = 0, concat_axis: int = 0,
             backend: Optional[str] = None) -> torch.Tensor:
    """All-to-all: rank i gets every rank's i-th piece of ``x`` (split n
    ways along ``split_axis``), concatenated along ``concat_axis``."""
    return _world("alltoall", x, backend,
                  {"split_axis": split_axis, "concat_axis": concat_axis})


def _world_axes(verb: str, axis_names: AxisNames) -> Optional[str]:
    """The axis an in-axis verb spans: None for the world (``axis_names``
    None or both world axes), else "dcn" or "ici".  Other communicators
    (``push_communicator``) are not ported yet (ROADMAP queue A, item
    1)."""
    if axis_names is None:
        return None
    axes = (axis_names,) if isinstance(axis_names, str) else tuple(
        axis_names)
    if sorted(axes) == sorted(WORLD_AXES):
        return None
    if len(axes) == 1 and axes[0] in WORLD_AXES:
        return axes[0]
    raise NotImplementedError(
        f"{verb} over {axes}: the world axes are {WORLD_AXES}; other "
        f"communicators are not ported yet (ROADMAP queue A, item 1)")


def _leaf_tensor(x):
    """A tree's leaf for a verb: a Python number becomes a 0-d tensor on
    the runtime's device, as a JAX verb takes it as an array."""
    if isinstance(x, (bool, int, float)):
        runtime._require_init()
        return torch.as_tensor(x, device=runtime.device())
    return x


def _tree_in_axis(verb: str, tree, kw: dict, axis: Optional[str]):
    """In-axis ``verb`` over every leaf of ``tree`` (JAX :376-386): fused
    by dtype group and bucket for allreduce, reduce and broadcast, in the
    tile-interleaved layout for reduce_scatter, else per leaf."""
    leaves, treedef = _tree.flatten(tree)
    for x in leaves:
        if isinstance(x, torch.Tensor):
            _check_tensor(x)
    backend = kw.get("backend")
    params = {k: v for k, v in kw.items() if k != "backend"}
    if planner.enabled():
        plan = planner.plan_in_axis(verb, tree, backend, params, axis)
        if plan is not None:
            return plan.replay(tree)
    fused = None
    if verb in fusion.ELEMENTWISE_OPS:
        fused = fusion.maybe_fuse(verb, tree, backend=backend, axis=axis,
                                  **params)
    elif verb == "reduce_scatter":
        fused = fusion.maybe_fuse_reduce_scatter(
            tree, backend=backend, axis=axis, **params)
    if fused is not None:
        return fused
    return _tree.unflatten(treedef, [
        _world(verb, _leaf_tensor(x), backend, params, axis=axis)
        for x in leaves])


def _in_axis(verb: str):
    """The in-step form of process-world ``verb`` over the world axes or
    one of them (JAX :365-447): one tensor as :func:`verb` takes it, or a
    tree (dict, list, tuple) of them."""

    def in_axis(x, axis_names: AxisNames = None, *,
                backend: Optional[str] = None, **params):
        axis = _world_axes(f"{verb}_in_axis", axis_names)
        if isinstance(x, torch.Tensor):
            return _world(verb, x, backend, params, axis=axis)
        return _tree_in_axis(verb, x, dict(params, backend=backend), axis)

    in_axis.__name__ = in_axis.__qualname__ = f"{verb}_in_axis"
    in_axis.__doc__ = (f"The in-step ``{verb}`` over the world axes, or over "
                       f"one of them (``axis_names`` \"dcn\" or \"ici\": "
                       f"this process's subgroup): :func:`{verb}` on one "
                       f"tensor, or on every tensor of a tree (dict, list, "
                       f"tuple), fused as the JAX package fuses it "
                       f"(``fusion``).")
    return in_axis


allreduce_in_axis = _in_axis("allreduce")
broadcast_in_axis = _in_axis("broadcast")
reduce_in_axis = _in_axis("reduce")
reduce_scatter_in_axis = _in_axis("reduce_scatter")
allgather_in_axis = _in_axis("allgather")
gather_in_axis = _in_axis("gather")
scatter_in_axis = _in_axis("scatter")
sendreceive_in_axis = _in_axis("sendreceive")
alltoall_in_axis = _in_axis("alltoall")


# ---------------------------------------------------------------------------
# Rank-major verbs (the JAX package's eager mode) and the staged path
# ---------------------------------------------------------------------------


def _check_stack(verb: str, xs) -> torch.Tensor:
    if not isinstance(xs, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(xs).__name__}")
    if xs.dim() < 1 or xs.shape[0] < 1:
        raise ValueError(f"{verb}: leading (rank) axis must have length "
                         f">= 1; got shape {tuple(xs.shape)}")
    return xs


def _rank_major(verb: str, xs, backend: Optional[str],
                n_dcn: Optional[int] = None):
    """The implementation of rank-major ``verb`` for ``xs`` [n, ...] (the
    selector's rules on one rank's bytes), on ``n_dcn`` nodes (None: the
    world's grid of n); the unplanned path's."""
    _check_stack(verb, xs)
    return selector.select(f"{verb}_rank_major", backend,
                           nbytes=_nbytes(xs[0]), ranks=xs.shape[0],
                           n_dcn=n_dcn, dtype=xs.dtype, device=xs.device)


def _staged_requested(backend: Optional[str],
                      staged: Optional[bool]) -> bool:
    """Whether a rank-major call takes the staged path: ``staged`` when
    given, else ``backend="host"`` (the JAX package's name), else
    ``Config.staged`` when no backend is named (an explicit backend forces
    the direct path, JAX :653)."""
    if staged is not None:
        return bool(staged)
    if backend == "host":
        return True
    return backend is None and runtime.effective_config().staged


def _to_host(xs: torch.Tensor) -> torch.Tensor:
    """A host copy of ``xs`` (pinned when it comes from the card)."""
    if xs.device.type == "cpu":
        return xs.detach().clone()
    host = torch.empty(xs.shape, dtype=xs.dtype, pin_memory=True)
    host.copy_(xs)
    return host


def _host_compute(verb: str, host: torch.Tensor, params: dict,
                  device: torch.device) -> torch.Tensor:
    """The closed form on the host copy; pinned when bound for the card."""
    out = CLOSED_FORMS[verb](host, **params)
    return out.pin_memory() if device.type == "cuda" else out


def _place(out: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host result on ``device``, enqueued on the current stream."""
    return out.to(device, non_blocking=True) if device.type == "cuda" \
        else out


def _axis_view(xs: torch.Tensor, axis: str) -> torch.Tensor:
    """``xs`` [n, ...] as [groups, members, ...] of ``axis`` on the grid of
    n (dcn-major ranks): the nodes' ici ranks for "ici", the ranks sharing
    an ici index for "dcn"."""
    n_dcn, n_ici = runtime.grid(xs.shape[0])
    v = xs.reshape(n_dcn, n_ici, *xs.shape[1:])
    return v.transpose(0, 1) if axis == "dcn" else v


def _from_axis_view(out: torch.Tensor, axis: str) -> torch.Tensor:
    """The inverse of :func:`_axis_view` on a result [groups, members,
    ...]: [n, ...] in global rank order."""
    if axis == "dcn":
        out = out.transpose(0, 1)
    return out.reshape(-1, *out.shape[2:])


def _eager(verb: str, xs, backend: Optional[str], staged: Optional[bool],
           params: dict, axis_names: AxisNames = None,
           n_dcn: Optional[int] = None) -> torch.Tensor:
    _check_stack(verb, xs)
    axis = _world_axes(f"{verb}_rank_major", axis_names)
    if planner.enabled():
        return planner.plan_for(verb, xs, backend, staged, params, axis,
                                n_dcn).replay(xs)
    return _eager_unplanned(verb, xs, backend, staged, params, axis, n_dcn)


def _eager_unplanned(verb: str, xs: torch.Tensor, backend: Optional[str],
                     staged: Optional[bool], params: dict,
                     axis: Optional[str], n_dcn: Optional[int]
                     ) -> torch.Tensor:
    """A rank-major call derived in full: staged or direct, the axis's
    groups, the selector's implementation."""
    if axis is not None:
        # Each group of one axis is a one-level stack.
        v = _axis_view(xs, axis)
        outs = [_eager_unplanned(verb, v[g], backend, staged, params, None,
                                 1) for g in range(v.shape[0])]
        return _from_axis_view(torch.stack(outs), axis)
    if _staged_requested(backend, staged):
        return _place(_host_compute(verb, _to_host(xs), params, xs.device),
                      xs.device)
    return _rank_major(verb, xs, backend, n_dcn)(xs, **params)


def allreduce_rank_major(xs: torch.Tensor, *, op: str = "sum",
                         backend: Optional[str] = None,
                         staged: Optional[bool] = None,
                         axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``allreduce`` (:772): ``xs[i]`` is rank i's
    tensor, n = ``xs.shape[0]`` ranks, all on ``xs``'s device; every slice
    of the result is the sum (or mean) over ranks.  ``backend="pallas"``
    runs the ring kernels (``ops/ring.py``), ``"xla"`` the left fold over
    the rank axis, ``"hierarchical"`` the two-level verb
    (``parallel/hierarchical.py``); the cutover and fallback rules are the
    selector's, on one rank's bytes.  ``staged`` (default
    ``Config.staged``) stages through host memory.

    Every rank-major verb takes ``axis_names`` as the in-axis verbs do:
    "ici" or "dcn" runs it over each group of that axis of the grid of n
    (``runtime.grid``), one level each, the result in global rank
    order."""
    return _eager("allreduce", xs, backend, staged, {"op": op}, axis_names)


def broadcast_rank_major(xs: torch.Tensor, *, root: int = 0,
                         backend: Optional[str] = None,
                         staged: Optional[bool] = None,
                         axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``broadcast`` (:781): every slice is
    ``xs[root]``."""
    return _eager("broadcast", xs, backend, staged, {"root": root}, axis_names)


def reduce_rank_major(xs: torch.Tensor, *, root: int = 0, op: str = "sum",
                      backend: Optional[str] = None,
                      staged: Optional[bool] = None,
                      axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``reduce`` (:789): slice ``root`` is the sum
    (or mean) over ranks, the other slices unchanged (float32 for an
    integer mean)."""
    return _eager("reduce", xs, backend, staged, {"root": root, "op": op}, axis_names)


def reduce_scatter_rank_major(xs: torch.Tensor, *, op: str = "sum",
                              backend: Optional[str] = None,
                              staged: Optional[bool] = None,
                              axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``reduce_scatter`` (:806): ``xs[i]`` [k, ...]
    is rank i's tensor, k divisible by the n ranks; slice i of the result
    [n, k / n, ...] is tile i of the sum over ranks.  ``backend="pallas"``
    runs the ring reduce-scatter kernels, ``"xla"`` the left fold over the
    rank axis, tiled."""
    return _eager("reduce_scatter", xs, backend, staged, {"op": op}, axis_names)


def allgather_rank_major(shards: torch.Tensor, *,
                         backend: Optional[str] = None,
                         staged: Optional[bool] = None,
                         axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``allgather`` (:797): ``shards[i]`` is rank
    i's tensor; every slice of the result [n, n, ...] is the stack of all
    of them.  ``backend="pallas"`` runs the ring all-gather kernels,
    ``"xla"`` a copy of the stack per rank."""
    return _eager("allgather", shards, backend, staged, {}, axis_names)


def gather_rank_major(xs: torch.Tensor, *, root: int = 0,
                      backend: Optional[str] = None,
                      staged: Optional[bool] = None,
                      axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``gather`` (:815): slice ``root`` of the
    result [n, n, ...] is the stack, the other slices zeros."""
    return _eager("gather", xs, backend, staged, {"root": root}, axis_names)


def scatter_rank_major(xs: torch.Tensor, *, root: int = 0,
                       backend: Optional[str] = None,
                       staged: Optional[bool] = None,
                       axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``scatter`` (:824): slice i of the result
    [n, k / n, ...] is tile i of ``xs[root]`` [k, ...]; an indivisible k
    raises ValueError."""
    return _eager("scatter", xs, backend, staged, {"root": root}, axis_names)


def sendreceive_rank_major(xs: torch.Tensor, *, src: int, dst: int,
                           backend: Optional[str] = None,
                           staged: Optional[bool] = None,
                           axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``sendreceive`` (:834): slice ``dst`` is
    ``xs[src]``, the others unchanged."""
    return _eager("sendreceive", xs, backend, staged,
                  {"src": src, "dst": dst}, axis_names)


def alltoall_rank_major(xs: torch.Tensor, *, split_axis: int = 0,
                        concat_axis: int = 0, backend: Optional[str] = None,
                        staged: Optional[bool] = None,
                        axis_names: AxisNames = None) -> torch.Tensor:
    """The JAX package's eager ``alltoall`` (:843): slice i is every rank's
    i-th piece of its tensor split n ways along ``split_axis``,
    concatenated in rank order along ``concat_axis``."""
    return _eager("alltoall", xs, backend, staged,
                  {"split_axis": split_axis, "concat_axis": concat_axis}, axis_names)


# ---------------------------------------------------------------------------
# Async facade (reference: mpi.async.* + syncHandle; JAX :871-1344)
# ---------------------------------------------------------------------------


class AsyncHandle:
    """Handle of a collective in flight; ``wait()`` / ``done`` / ``error``.

    Flavours:

    - **side stream** (a direct rank-major collective on the card): the
      collective was enqueued on a side stream after the caller's stream;
      ``wait()`` makes the caller's current stream wait for it and returns
      the result, ``done`` polls its event;
    - **work** (a process-world collective): ``torch.distributed``'s
      ``async_op=True`` work, whose ``wait()`` orders the current stream
      after a NCCL collective (gloo's blocks the host); ``done`` polls it;
    - **staged**: the device -> host -> compute exchange on the one staged
      worker thread; ``wait()`` joins it and enqueues the result's copy to
      the device on the current stream;
    - **done** (CPU tensors, implementations with no asynchronous form):
      the value itself.

    A failed collective is **done** (``done`` is True): ``wait()``
    re-raises its error on every call and ``error`` exposes it.
    """

    __slots__ = ("_value", "_future", "_event", "_work", "_device",
                 "_error", "_op", "_placed")

    def __init__(self, value=None, *, future=None, event=None, work=None,
                 device: Optional[torch.device] = None, op: str = "",
                 error: Optional[BaseException] = None):
        self._value = value
        self._future = future
        self._event = event
        self._work = work
        self._device = device
        self._error = error
        self._op = op
        self._placed = future is None

    @property
    def op(self) -> str:
        return self._op

    @property
    def error(self) -> Optional[BaseException]:
        """The failure of a handle that completed with an error."""
        self.done
        return self._error

    @property
    def done(self) -> bool:
        """Non-blocking poll: True once the collective completed, also
        when it FAILED (its error then raises from ``wait()``)."""
        if self._error is not None:
            return True
        if self._future is not None:
            if not self._future.done():
                return False
            self._resolve_future()
            return True
        if self._work is not None:
            try:
                return self._work.is_completed()
            except Exception as e:  # noqa: BLE001 - a poll error IS done
                self._error = e
                return True
        if self._event is not None:
            return self._event.query()
        return True

    def _resolve_future(self) -> None:
        fut, self._future = self._future, None
        try:
            self._value = fut.result()
        except Exception as e:  # noqa: BLE001 - carried to wait()/done
            self._error = e

    def wait(self, timeout_s: Optional[float] = None):
        """The collective's result, the caller's current stream ordered
        after it.  Re-raises the collective's error, on every call.
        ``timeout_s`` bounds the wait for completion: on expiry a
        :class:`PeerTimeoutError` raises (the collective is not
        cancelled)."""
        if timeout_s is not None:
            t0 = time.monotonic()
            while not self.done:
                elapsed = time.monotonic() - t0
                if elapsed >= timeout_s:
                    raise PeerTimeoutError(
                        f"async.wait({self._op})", elapsed_s=elapsed,
                        deadline_s=float(timeout_s))
                time.sleep(0.0005 if elapsed < 0.01
                           else (0.002 if elapsed < 0.1 else 0.02))
        if self._future is not None:
            self._resolve_future()
        if self._error is not None:
            raise self._error
        if self._work is not None:
            work, self._work = self._work, None
            try:
                self._value = work.wait()
            except Exception as e:  # noqa: BLE001 - kept for every wait
                self._error = e
                raise
        if not self._placed:
            self._value = _place(self._value, self._device)
            self._placed = True
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            _record_stream(self._value, stream)
        return self._value


def _record_stream(value, stream) -> None:
    if isinstance(value, torch.Tensor) and value.is_cuda:
        value.record_stream(stream)


def sync_handle(handle: AsyncHandle):
    """Reference: ``mpi.syncHandle(h)``."""
    return handle.wait()


def wait_all(handles: Sequence[AsyncHandle],
             timeout_s: Optional[float] = None) -> List:
    """``wait()`` on every handle; the results in INPUT order.  Every
    handle is driven to completion before the first error (in input
    order) re-raises.  ``timeout_s`` is one deadline across the batch: on
    expiry :class:`PeerTimeoutError` raises at once and the remaining
    handles stay in flight (JAX :1030-1108)."""
    hs = list(handles)
    t0 = time.monotonic()
    first_err: Optional[BaseException] = None
    out = []
    for h in hs:
        left = (None if timeout_s is None
                else max(0.0, float(timeout_s) - (time.monotonic() - t0)))
        try:
            out.append(h.wait(timeout_s=left))
        except PeerTimeoutError:
            raise
        except Exception as e:  # noqa: BLE001 - re-raised below
            out.append(None)
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    return out


# One staged worker on purpose (JAX :1134): the reference's collective
# thread pool sequenced collectives per communicator, and FIFO completion
# keeps two staged collectives on one buffer in order.
_staged_pool = None
_staged_pool_lock = threading.Lock()


def _staged_executor():
    global _staged_pool
    if _staged_pool is None:
        with _staged_pool_lock:
            if _staged_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                _staged_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="tm-async-staged")
    return _staged_pool


def _staged_async_work(verb: str, xs: torch.Tensor, params: dict,
                       donate: bool, ready) -> torch.Tensor:
    """The staged worker's part of one handle: wait until the caller's
    stream reached the dispatch, stage ``xs`` to host (releasing its
    storage when donated), and run the closed form on the host.  The copy
    back to the device is ``wait()``'s."""
    if ready is not None:
        ready.synchronize()
        with torch.cuda.device(xs.device):
            host = _to_host(xs)
    else:
        host = _to_host(xs)
    if donate:
        xs.untyped_storage().resize_(0)
    return _host_compute(verb, host, params, xs.device)


_side_streams: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream the direct async collectives of ``device`` run
    on (one per card)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    s = _side_streams.get(idx)
    if s is None:
        s = _side_streams[idx] = torch.cuda.Stream(device=idx)
    return s


def _async_rank_major(verb: str, xs, *, backend: Optional[str] = None,
                      staged: Optional[bool] = None, donate: bool = False,
                      **params) -> AsyncHandle:
    """Dispatch rank-major ``verb`` and return its handle (JAX :1199).

    Direct: enqueued on the side stream after the caller's stream (the
    input recorded on the side stream, so the allocator keeps it until the
    collective is done); CPU tensors compute at once.  Staged: the
    exchange runs on the staged worker, which with ``donate=True``
    releases the input's storage once it is on the host (every view of
    it becomes empty).  A collective that fails gives a failed handle."""
    _check_stack(verb, xs)
    if _staged_requested(backend, staged):
        if donate and not xs.untyped_storage().resizable():
            raise ValueError("donate=True releases the input's storage, "
                             "which this tensor does not own (e.g. one "
                             "made by torch.from_numpy)")
        ready = None
        if xs.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(xs.device))
        fut = _staged_executor().submit(_staged_async_work, verb, xs,
                                        dict(params), donate, ready)
        return AsyncHandle(future=fut, device=xs.device, op=verb)
    try:
        # The route ("auto" measured on a plan miss) is resolved here, on
        # the caller's stream, never on the side stream.
        if planner.enabled():
            run = planner.plan_for(verb, xs, backend, False, params, None,
                                   None).replay
        else:
            impl = _rank_major(verb, xs, backend)

            def run(x):
                return impl(x, **params)
        if not xs.is_cuda:
            return AsyncHandle(run(xs), op=verb)
        side = side_stream(xs.device)
        side.wait_stream(torch.cuda.current_stream(xs.device))
        with torch.cuda.stream(side):
            out = run(xs)
            event = torch.cuda.Event()
            event.record(side)
        xs.record_stream(side)
    except Exception as e:  # noqa: BLE001 - a failed handle is done
        return AsyncHandle(op=verb, error=e)
    return AsyncHandle(out, event=event, device=xs.device, op=verb)


def _async_world(verb: str, x, axis_names: AxisNames = None, *,
                 backend: Optional[str] = None,
                 impl: Optional[Callable] = None, **params) -> AsyncHandle:
    """Dispatch process-world ``verb`` and return its handle: the process
    group's ``async_op=True`` work (an implementation with no asynchronous
    form, the ring in a world of one, runs at once).  ``impl``: a plan's
    implementation, run as it is."""
    axis = _world_axes(f"async_in_axis.{verb}", axis_names)
    try:
        if impl is not None:
            got = _world_run(verb, impl, _check_tensor(x), params,
                             async_op=True, axis=axis)
        else:
            got = _world(verb, x, backend, params, async_op=True, axis=axis)
    except Exception as e:  # noqa: BLE001 - a failed handle is done
        return AsyncHandle(op=verb, error=e)
    if isinstance(got, _Pending):
        return AsyncHandle(work=got, op=verb)
    return AsyncHandle(got, op=verb)


class _AsyncNamespace:
    """``collectives.async_.<verb>(xs)`` -> :class:`AsyncHandle`, the
    rank-major verbs dispatched without waiting (reference:
    ``mpi.async.allreduceTensor``); ``staged`` / ``backend="host"`` take
    the staged worker, where ``donate=True`` releases the input's storage
    once staged."""

    @staticmethod
    def allreduce(xs, *, op: str = "sum", **kw) -> AsyncHandle:
        return _async_rank_major("allreduce", xs, op=op, **kw)

    @staticmethod
    def broadcast(xs, *, root: int = 0, **kw) -> AsyncHandle:
        return _async_rank_major("broadcast", xs, root=root, **kw)

    @staticmethod
    def reduce(xs, *, root: int = 0, op: str = "sum", **kw) -> AsyncHandle:
        return _async_rank_major("reduce", xs, root=root, op=op, **kw)

    @staticmethod
    def allgather(xs, **kw) -> AsyncHandle:
        return _async_rank_major("allgather", xs, **kw)

    @staticmethod
    def reduce_scatter(xs, *, op: str = "sum", **kw) -> AsyncHandle:
        return _async_rank_major("reduce_scatter", xs, op=op, **kw)

    @staticmethod
    def gather(xs, *, root: int = 0, **kw) -> AsyncHandle:
        return _async_rank_major("gather", xs, root=root, **kw)

    @staticmethod
    def scatter(xs, *, root: int = 0, **kw) -> AsyncHandle:
        return _async_rank_major("scatter", xs, root=root, **kw)

    @staticmethod
    def sendreceive(xs, *, src: int, dst: int, **kw) -> AsyncHandle:
        return _async_rank_major("sendreceive", xs, src=src, dst=dst, **kw)

    @staticmethod
    def alltoall(xs, *, split_axis: int = 0, concat_axis: int = 0,
                 **kw) -> AsyncHandle:
        return _async_rank_major("alltoall", xs, split_axis=split_axis,
                                 concat_axis=concat_axis, **kw)


async_ = _AsyncNamespace()


class _AsyncInAxisNamespace:
    """Handle-returning forms of the nine process-world verbs
    (``*_in_axis``): the collective is issued at the call, as
    ``torch.distributed`` ``async_op=True`` work, and ``wait()`` hands
    over the result; what the caller runs in between overlaps it."""

    @staticmethod
    def allreduce(x, axis_names: AxisNames = None, *, op: str = "sum",
                  **kw) -> AsyncHandle:
        return _async_world("allreduce", x, axis_names, op=op, **kw)

    @staticmethod
    def broadcast(x, axis_names: AxisNames = None, *, root: int = 0,
                  **kw) -> AsyncHandle:
        return _async_world("broadcast", x, axis_names, root=root, **kw)

    @staticmethod
    def reduce(x, axis_names: AxisNames = None, *, root: int = 0,
               op: str = "sum", **kw) -> AsyncHandle:
        return _async_world("reduce", x, axis_names, root=root, op=op, **kw)

    @staticmethod
    def allgather(x, axis_names: AxisNames = None, **kw) -> AsyncHandle:
        return _async_world("allgather", x, axis_names, **kw)

    @staticmethod
    def reduce_scatter(x, axis_names: AxisNames = None, *, op: str = "sum",
                       **kw) -> AsyncHandle:
        return _async_world("reduce_scatter", x, axis_names, op=op, **kw)

    @staticmethod
    def gather(x, axis_names: AxisNames = None, *, root: int = 0,
               **kw) -> AsyncHandle:
        return _async_world("gather", x, axis_names, root=root, **kw)

    @staticmethod
    def scatter(x, axis_names: AxisNames = None, *, root: int = 0,
                **kw) -> AsyncHandle:
        return _async_world("scatter", x, axis_names, root=root, **kw)

    @staticmethod
    def sendreceive(x, axis_names: AxisNames = None, *, src: int, dst: int,
                    **kw) -> AsyncHandle:
        return _async_world("sendreceive", x, axis_names, src=src, dst=dst,
                            **kw)

    @staticmethod
    def alltoall(x, axis_names: AxisNames = None, *, split_axis: int = 0,
                 concat_axis: int = 0, **kw) -> AsyncHandle:
        return _async_world("alltoall", x, axis_names,
                            split_axis=split_axis, concat_axis=concat_axis,
                            **kw)


async_in_axis = _AsyncInAxisNamespace()
