"""Data-parallel parameter and gradient synchronization.

The PyTorch counterpart of ``torchmpi_tpu/parallel/gradsync.py``
(``synchronize_parameters`` :51, ``synchronize_gradients`` :243,
``accumulate_gradients`` :803, ``data_parallel_step`` :852), in the
reference's training-loop shape: broadcast the parameters once, then each
step computes local gradients, allreduces them, and applies the
optimizer.  The JAX package returns new pytrees; the port works on an
``nn.Module`` (or a list of parameters) and updates parameters and their
``.grad`` in place, as PyTorch training code does, so no second copy of a
model's state exists.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from .. import collectives, fusion, runtime
from ..config import wire_compress

Params = Union[torch.nn.Module, Iterable[torch.Tensor]]


def _param_list(params: Params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


def synchronize_parameters(params: Params, *, root: int = 0,
                           backend: Optional[str] = None) -> Params:
    """Broadcast every parameter from rank ``root``, in place (reference:
    ``mpinn.synchronizeParameters``), in fused buckets."""
    with torch.no_grad():
        fusion.fused_("broadcast", [p.data for p in _param_list(params)],
                      backend=backend, root=root)
    return params


def _sync_(grads: List[torch.Tensor], fused_allreduce_: Callable, *,
           op: Optional[str], compress: Optional[str]) -> None:
    """``fused_allreduce_(tensors, op)`` on ``grads`` in place, with the
    Config's defaults for ``op`` and ``compress``."""
    cfg = runtime.effective_config()
    if op is None:
        op = "mean" if cfg.gradsync_average else "sum"
    if compress is None:
        compress = cfg.gradsync_compress
    compress = wire_compress(compress, site="synchronize_gradients")
    if compress == "bf16":
        wire = [g.to(torch.bfloat16) for g in grads]
        fused_allreduce_(wire, op)
        for g, w in zip(grads, wire):
            g.copy_(w)
    else:
        fused_allreduce_(grads, op)


def synchronize_gradients(params: Params, *, op: Optional[str] = None,
                          backend: Optional[str] = None,
                          compress: Optional[str] = None) -> Params:
    """Allreduce the ``.grad`` of every parameter across the world, in
    place (reference: ``mpinn.synchronizeGradients``).

    ``op`` defaults to mean when ``Config.gradsync_average`` (the reference
    summed, then divided by ``mpi.size()``).  The gradients ride the fused
    collectives (``Config.fuse_max_bytes``): dtype-grouped buckets, one
    allreduce each.  Parameters without a gradient are skipped.

    ``compress="bf16"`` (default ``Config.gradsync_compress``) reduces in
    bfloat16, as the JAX package does (:296-299, :372-382): every gradient
    is cast to bf16, the bf16 copies sync as their own dtype group, and the
    result is cast back into ``.grad`` in the gradient's dtype."""
    synchronize_gradient_tensors(
        [p.grad for p in _param_list(params) if p.grad is not None],
        op=op, backend=backend, compress=compress)
    return params


def synchronize_gradient_tensors(grads: Sequence[torch.Tensor], *,
                                 op: Optional[str] = None,
                                 backend: Optional[str] = None,
                                 compress: Optional[str] = None) -> None:
    """:func:`synchronize_gradients` on the gradient tensors themselves
    (the JAX function's pytree of gradients), in place."""
    _sync_(list(grads), lambda ts, op: fusion.fused_(
        "allreduce", ts, backend=backend, op=op), op=op, compress=compress)


def synchronize_gradients_rank_major(stacks: Sequence[torch.Tensor], *,
                                     op: Optional[str] = None,
                                     backend: Optional[str] = None,
                                     compress: Optional[str] = None
                                     ) -> None:
    """:func:`synchronize_gradients` for n ranks on one device, in place:
    ``stacks[i][r]`` is rank r's gradient i ([n, ...] each), synced by
    ``fusion.fused_allreduce_rank_major_`` (``backend="pallas"``: one ring
    launch per bucket), the same defaults and compression."""
    _sync_(list(stacks), lambda ts, op: fusion.fused_allreduce_rank_major_(
        ts, backend=backend, op=op), op=op, compress=compress)


def accumulate_gradients(loss_fn: Callable[..., torch.Tensor],
                         params: Sequence[torch.Tensor], *batch: torch.Tensor,
                         n_accum: int) -> Tuple[torch.Tensor,
                                                List[torch.Tensor]]:
    """Microbatched gradient accumulation: split each batch tensor's
    leading axis into ``n_accum`` equal microbatches, run
    ``loss_fn(params, *microbatch) -> scalar loss`` on each in turn, and
    return ``(mean_loss, mean_grads)``, numerically the full-batch gradient
    for a mean loss at 1/n_accum the activation memory.  As in the JAX
    package, the losses and gradients are summed from zero in microbatch
    order and scaled by ``1 / n_accum`` once; ``n_accum <= 1`` is one plain
    gradient.  The gradients are taken with respect to ``params`` (new
    tensors; ``params`` and their ``.grad`` are not touched).  Composes with
    :func:`synchronize_gradients` / ``zero.update`` like any gradient
    list."""
    leaves = [p.detach().requires_grad_() for p in params]

    def grads_of(*mb):
        loss = loss_fn(leaves, *mb)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    if n_accum <= 1:
        return grads_of(*batch)
    for x in batch:
        if x.shape[0] % n_accum:
            raise ValueError(f"batch leading axis {x.shape[0]} not divisible "
                             f"by n_accum={n_accum}")
    mbs = [x.reshape(n_accum, x.shape[0] // n_accum, *x.shape[1:])
           for x in batch]
    loss_sum, g_sum = 0.0, [torch.zeros_like(p) for p in leaves]
    for i in range(n_accum):
        loss, grads = grads_of(*(mb[i] for mb in mbs))
        loss_sum = loss_sum + loss
        g_sum = [a + b for a, b in zip(g_sum, grads)]
    inv = 1.0 / n_accum
    return loss_sum * inv, [g * inv for g in g_sum]


def data_parallel_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       loss_fn: Callable[..., torch.Tensor], *,
                       sync_parameters: bool = True) -> Callable:
    """Build one synchronous data-parallel training step.

    ``loss_fn(model, *batch)`` computes this rank's loss on its local batch
    shard.  The returned ``step(*batch)`` zeroes the gradients, runs the
    forward and backward, synchronizes the gradients
    (:func:`synchronize_gradients`), applies ``optimizer`` and returns the
    loss averaged over ranks (``allreduce_in_axis(loss, op="mean")``, as
    the JAX recipe does), detached.  With ``sync_parameters`` the
    parameters are broadcast from rank 0 once, here, so every rank starts
    from the same weights."""
    if sync_parameters:
        synchronize_parameters(model)

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        synchronize_gradients(model)
        optimizer.step()
        return collectives.allreduce_in_axis(loss.detach(), op="mean")

    return step


def data_parallel_step_rank_major(model: torch.nn.Module,
                                  optimizer: torch.optim.Optimizer,
                                  loss_fn: Callable[..., torch.Tensor],
                                  n: int, *,
                                  backend: Optional[str] = None) -> Callable:
    """:func:`data_parallel_step` for ``n`` ranks on one device (the JAX
    package's eager mode): ``step(*batch)`` splits each batch tensor's
    leading axis in n, runs rank r's forward and backward on slice r from
    the same weights, stacks the ranks' gradients [n, ...], syncs them
    with :func:`synchronize_gradients_rank_major` (``backend="pallas"``:
    the ring kernels), applies ``optimizer`` to the synced gradients and
    returns the mean of the ranks' losses, detached."""
    params = list(model.parameters())

    def step(*batch):
        parts = [b.reshape(n, -1, *b.shape[1:]) for b in batch]
        stacks = [p.new_empty((n, *p.shape)) for p in params]
        losses = []
        for r in range(n):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, *(b[r] for b in parts))
            loss.backward()
            losses.append(loss.detach())
            for st, p in zip(stacks, params):
                st[r].copy_(p.grad)
        synchronize_gradients_rank_major(stacks, backend=backend)
        for st, p in zip(stacks, params):
            p.grad = st[0]
        optimizer.step()
        return torch.stack(losses).mean()

    return step
