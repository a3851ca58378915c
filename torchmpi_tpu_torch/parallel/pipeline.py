"""Pipeline (stage) parallelism: the GPipe and the interleaved schedules.

The PyTorch counterpart of ``torchmpi_tpu/parallel/pipeline.py``.  Every
stage runs the same tick loop as JAX's SPMD program:

- :func:`gpipe_apply` (JAX :38): ``M + S - 1`` ticks.  At each tick a
  stage receives its predecessor's activation (a linear shift, no
  wraparound), stage 0 instead injects the next microbatch (zeros once
  they run out), every stage applies its own parameters, and the last
  stage's outputs are collected.  Bubble ``(S - 1) / (M + S - 1)``.
- :func:`interleaved_apply` (JAX :132): ``V * M + S - 1`` ticks, each stage
  holding ``V`` non-adjacent chunks (logical stage ``v * S + d`` on stage
  ``d``, the layout of :func:`interleave_stages`); a stage decodes its
  chunk for the tick from ``u = t - d`` as ``((u mod V S) // S)``, and the
  activations ride a shift WITH wraparound (the ``S - 1 -> 0`` hop is the
  chunk ``v -> v + 1`` handoff).  ``M`` must be a multiple of ``S``.

Autograd runs the schedule backward: the shift's backward is the reverse
shift, so the activations' gradients flow back through the pipe in
reverse stage order.  ``remat=True`` recomputes each stage application in
the backward (``torch.utils.checkpoint``, non-reentrant): the same
numbers, one stored activation a tick.  ``broadcast_out`` hands the last
stage's outputs to every stage (its backward the sum of the stages'
cotangents on the last stage, the broadcast's transpose); without it the
other stages' outputs are zeros, and a loss masks to the last stage.  In
the process world every stage's backward must run (each reverse shift
pairs with a neighbour's), so a loss keeps the outputs in its graph on
every stage and masks with ``torch.where`` on the stage index, as JAX's
``jnp.where`` does, never with a Python branch.

Two forms.  Over an axis of the process world (``axis_name`` as the
in-axis verbs take it), on this stage's parameters and ``[M, ...]``
microbatches: the shift is ``collectives.shift_in_axis_grad``, one
``batch_isend_irecv`` a tick.  And rank-major (``*_rank_major``), on
stacks [n, ...] of the current communicator's ranks (``stage_params``
leaves [n, ...], ``microbatches`` [n, M, ...]): the shift is an index
move on the stage dim, and each tick calls ``stage_fn`` once on the whole
stack, so every stage applies its own parameters in one call.  The
rank-major form computes the bubble's applications as JAX's program and
the process world do (their outputs are thrown away and their gradients
are zero), so the two forms do the same work tick for tick.  Each
tick's shift runs in a ``pp/shift`` profiler range.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import _tree, collectives, runtime


def _maybe_remat(stage_fn: Callable, remat: bool) -> Callable:
    if not remat:
        return stage_fn
    return lambda params, x: checkpoint(stage_fn, params, x,
                                        use_reentrant=False)


def interleave_stages(stage_tree, n_devices: int):
    """Reorder an ``[L, ...]`` per-stage tree (numpy or torch leaves) into
    the ``[S, V, ...]`` round-robin layout of :func:`interleaved_apply`:
    element ``[d, v]`` is logical stage ``v * S + d``."""
    def re(leaf):
        L = leaf.shape[0]
        if L % n_devices:
            raise ValueError(
                f"stage count {L} not divisible by pipeline size "
                f"{n_devices}")
        V = L // n_devices
        return leaf.reshape(V, n_devices, *leaf.shape[1:]).swapaxes(0, 1)
    return _tree.map(re, stage_tree)


def _decode(t: int, d: int, S: int, V: int, M: int):
    """Stage ``d``'s work at tick ``t`` of the interleaved schedule (JAX
    :193-223): its chunk, the microbatch stage 0 injects (or None) and the
    microbatch the last stage completes (or None)."""
    VS = V * S
    v = ((t - d) % VS) // S
    g, r = t // VS, t % VS
    m_in = g * S + r
    inject = m_in if r < S and m_in < M else None
    u_last = t - (S - 1)
    gl, rl = u_last // VS, u_last % VS
    m_out = gl * S + (rl - (V - 1) * S)
    done = m_out if (u_last >= 0 and rl >= (V - 1) * S and m_out < M) \
        else None
    return v, inject, done


def _select(flag: bool, a: torch.Tensor, b) -> torch.Tensor:
    """``a`` where this stage's ``flag``, else ``b``, as JAX's ``where`` on
    the stage index: the tensor not taken stays in the graph with a zero
    gradient, so that every stage's backward runs every reverse shift
    (each pairs with a neighbour's)."""
    cond = (a.new_ones if flag else a.new_zeros)((), dtype=torch.bool)
    return torch.where(cond, a, b)


class _BroadcastFromLast(torch.autograd.Function):
    """The process world's ``broadcast_out``: the last stage's tensor on
    every stage; backward, the stages' cotangents summed onto the last."""

    @staticmethod
    def forward(ctx, x, axis, root, my):
        ctx.args = (axis, root, my)
        return collectives.broadcast_in_axis(x.contiguous(), axis, root=root)

    @staticmethod
    def backward(ctx, g):
        axis, root, my = ctx.args
        total = collectives.allreduce_in_axis(g.contiguous(), axis)
        return (total if my == root else torch.zeros_like(g)), None, None, \
            None


# ---------------------------------------------------------------------------
# Over an axis of the process world
# ---------------------------------------------------------------------------


def gpipe_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                axis_name, *, broadcast_out: bool = True,
                remat: bool = False) -> torch.Tensor:
    """Run a linear pipeline over ``axis_name``.

    - ``stage_fn(stage_params, x) -> y``: one stage, the same activation
      shape in and out.
    - ``stage_params``: this stage's parameters.
    - ``microbatches``: ``[M, mb, ...]``, the whole input (only stage 0
      reads it).

    Returns ``[M, mb, ...]``: the last stage's outputs, on every stage
    with ``broadcast_out``, else zeros off the last stage."""
    axis = collectives._world_axes("gpipe_apply", axis_name)
    S, my = runtime.axis_size(axis), runtime.axis_index(axis)
    M = microbatches.shape[0]
    fn = _maybe_remat(stage_fn, remat)
    zero = microbatches.new_zeros(microbatches.shape[1:])
    T = M + S - 1
    recv, outs = zero, []
    for t in range(T):
        x = _select(my == 0, microbatches[t] if t < M else zero, recv)
        h = fn(stage_params, x)
        if t >= S - 1:
            outs.append(_select(my == S - 1, h, 0.0))
        if t < T - 1:  # the last tick's shift would feed nothing
            with record_function("pp/shift"):
                recv = collectives.shift_in_axis_grad(h, axis, wrap=False)
    result = torch.stack(outs)
    if broadcast_out:
        result = _BroadcastFromLast.apply(result, axis, S - 1, my)
    return result


def interleaved_apply(stage_fn: Callable, stage_params,
                      microbatches: torch.Tensor, axis_name, *,
                      broadcast_out: bool = True,
                      remat: bool = False) -> torch.Tensor:
    """The interleaved (virtual-stage) pipeline over ``axis_name``:
    ``stage_params`` is this stage's ``[V, ...]`` chunk tree (a row of
    :func:`interleave_stages`), ``microbatches`` ``[M, mb, ...]`` with
    ``M`` a multiple of ``S``.  ``V == 1`` is :func:`gpipe_apply` tick for
    tick.  Returns as :func:`gpipe_apply`."""
    axis = collectives._world_axes("interleaved_apply", axis_name)
    S, my = runtime.axis_size(axis), runtime.axis_index(axis)
    fn = _maybe_remat(stage_fn, remat)
    leaves = _tree.leaves(stage_params)
    if not leaves:
        raise ValueError("stage_params is empty")
    V = leaves[0].shape[0]
    M = microbatches.shape[0]
    if M % S:
        raise ValueError(
            f"interleaved schedule needs M % S == 0, got M={M}, S={S}")
    T = V * M + S - 1
    zero = microbatches.new_zeros(microbatches.shape[1:])
    recv = zero
    outs = [zero] * M
    for t in range(T):
        v, inject, _ = _decode(t, my, S, V, M)
        _, _, done = _decode(t, S - 1, S, V, M)
        x = (recv if inject is None
             else _select(my == 0, microbatches[inject], recv))
        h = fn(_tree.map(lambda l: l[v], stage_params), x)
        if done is not None:
            outs[done] = _select(my == S - 1, h, 0.0)
        if t < T - 1:
            with record_function("pp/shift"):
                recv = collectives.shift_in_axis_grad(h, axis, wrap=True)
    result = torch.stack(outs)
    if broadcast_out:
        result = _BroadcastFromLast.apply(result, axis, S - 1, my)
    return result


# ---------------------------------------------------------------------------
# Rank-major: stacks [n, ...] of the current communicator's ranks
# ---------------------------------------------------------------------------


def _stages(xs: torch.Tensor, axis) -> torch.Tensor:
    """A stack [n, ...] as [S, R, ...]: the stage dim first, each stage's
    R = n / S ranks in order."""
    return collectives._axis_view(xs, axis).transpose(0, 1)


def _unstages(v: torch.Tensor, axis) -> torch.Tensor:
    """The inverse of :func:`_stages`."""
    return collectives._from_axis_view(v.transpose(0, 1), axis)


def _rank_major_out(outs, axis, S: int, broadcast_out: bool):
    """The last stage's outputs ``outs`` [R, M, ...] as the stack [n, M,
    ...]: on every stage, or zeros off the last."""
    if broadcast_out:
        full = outs.unsqueeze(0).expand(S, *outs.shape)
    else:
        full = torch.cat([outs.new_zeros((S - 1,) + tuple(outs.shape)),
                          outs[None]])
    return _unstages(full, axis)


def gpipe_apply_rank_major(stage_fn: Callable, stage_params,
                           microbatches: torch.Tensor, axis_name, *,
                           broadcast_out: bool = True,
                           remat: bool = False) -> torch.Tensor:
    """:func:`gpipe_apply` on stacks: ``stage_params`` leaves [n, ...] (rank
    r's stage parameters), ``microbatches`` [n, M, mb, ...] (rank r's
    stream; stage 0's ranks inject theirs); ``stage_fn(params, x)`` takes
    and returns stacks [n, ...].  Returns [n, M, mb, ...]."""
    axis = collectives._world_axes("gpipe_apply_rank_major", axis_name)
    n = microbatches.shape[0]
    S = runtime.axis_size(axis, n)
    M = microbatches.shape[1]
    fn = _maybe_remat(stage_fn, remat)
    inject = _stages(microbatches, axis)[0]          # [R, M, ...]
    zero = inject.new_zeros((1,) + tuple(inject.shape[:1])
                            + tuple(inject.shape[2:]))
    T = M + S - 1
    recv, outs = zero.expand(S, *zero.shape[1:]), []
    for t in range(T):
        first = inject[:, t][None] if t < M else zero
        x = torch.cat([first, recv[1:]])
        h = _stages(fn(stage_params, _unstages(x, axis)), axis)
        if t >= S - 1:
            outs.append(h[S - 1])
        if t < T - 1:  # the linear shift: stage s gets stage s - 1's
            with record_function("pp/shift"):
                recv = torch.cat([zero, h[:-1]])
    return _rank_major_out(torch.stack(outs, 1), axis, S, broadcast_out)


def interleaved_apply_rank_major(stage_fn: Callable, stage_params,
                                 microbatches: torch.Tensor, axis_name, *,
                                 broadcast_out: bool = True,
                                 remat: bool = False) -> torch.Tensor:
    """:func:`interleaved_apply` on stacks: ``stage_params`` leaves [n, V,
    ...] (rank r's chunks, rows of :func:`interleave_stages`),
    ``microbatches`` [n, M, mb, ...].  Each tick gathers every stage's
    chunk for the tick into one stack [n, ...] and calls ``stage_fn`` on
    it.  Returns [n, M, mb, ...]."""
    axis = collectives._world_axes("interleaved_apply_rank_major", axis_name)
    n = microbatches.shape[0]
    S = runtime.axis_size(axis, n)
    fn = _maybe_remat(stage_fn, remat)
    leaves = _tree.leaves(stage_params)
    if not leaves:
        raise ValueError("stage_params is empty")
    V = leaves[0].shape[1]
    M = microbatches.shape[1]
    if M % S:
        raise ValueError(
            f"interleaved schedule needs M % S == 0, got M={M}, S={S}")
    staged = _tree.map(lambda l: _stages(l, axis), stage_params)
    inject = _stages(microbatches, axis)[0]          # [R, M, ...]
    zero = inject.new_zeros(tuple(inject.shape[:1]) + tuple(inject.shape[2:]))
    T = V * M + S - 1
    recv = zero.expand(S, *zero.shape)
    outs = [zero] * M
    for t in range(T):
        chunks = [_decode(t, d, S, V, M)[0] for d in range(S)]
        m_in = _decode(t, 0, S, V, M)[1]
        done = _decode(t, S - 1, S, V, M)[2]
        first = recv[0] if m_in is None else inject[:, m_in]
        x = torch.cat([first[None], recv[1:]])
        params = _tree.map(lambda l: _unstages(torch.stack(
            [l[d, :, chunks[d]] for d in range(S)]), axis), staged)
        h = _stages(fn(params, _unstages(x, axis)), axis)
        if done is not None:
            outs[done] = h[S - 1]
        if t < T - 1:  # the shift with wraparound
            with record_function("pp/shift"):
                recv = torch.cat([h[-1:], h[:-1]])
    return _rank_major_out(torch.stack(outs, 1), axis, S, broadcast_out)
