"""Data-parallel parameter and gradient synchronization.

The PyTorch counterpart of ``torchmpi_tpu/parallel/gradsync.py``
(``synchronize_parameters`` :51, ``synchronize_gradients`` :243,
``data_parallel_step`` :852), in the reference's training-loop shape:
broadcast the parameters once, then each step computes local gradients,
allreduces them, and applies the optimizer.  The JAX package returns new
pytrees; the port works on an ``nn.Module`` (or a list of parameters) and
updates parameters and their ``.grad`` in place, as PyTorch training code
does, so no second copy of a model's state exists.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Union

import torch

from .. import collectives, fusion, runtime

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


def synchronize_gradients(params: Params, *, op: Optional[str] = None,
                          backend: Optional[str] = None) -> Params:
    """Allreduce the ``.grad`` of every parameter across the world, in
    place (reference: ``mpinn.synchronizeGradients``).

    ``op`` defaults to mean when ``Config.gradsync_average`` (the reference
    summed, then divided by ``mpi.size()``).  The gradients ride the fused
    collectives (``Config.fuse_max_bytes``): dtype-grouped buckets, one
    allreduce each.  Parameters without a gradient are skipped."""
    if op is None:
        op = "mean" if runtime.effective_config().gradsync_average else "sum"
    grads = [p.grad for p in _param_list(params) if p.grad is not None]
    fusion.fused_("allreduce", grads, backend=backend, op=op)
    return params


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
