"""Reusable training-step recipes.

The counterpart of ``torchmpi_tpu/recipes.py``: ``make_bn_dp_train_step``
(:24), the canonical data-parallel SGD step for a model with BatchNorm,
and ``replicate_bn_state`` (:287).  No training loop, only the library's
own pieces composed: local forward and backward with each rank's own
batch statistics (local BN, as JAX's ``shard_map`` gives, not sync-BN),
the gradient sync (``synchronize_gradients``) or a ZeRO update, the new
running statistics averaged on the same collective route as the
gradients, and the loss averaged for logging.

The step is functional, as in JAX: ``step(params, opt_state, batch_stats,
images, labels) -> (params, opt_state, batch_stats, loss)``, where
``params`` is the list of the model's parameters in ``named_parameters()``
order (for ``zero=3`` the flat shard), ``batch_stats`` the running
statistics in ``layers.batch_stats`` order, ``opt_state`` ``[tx.init(p)
for p in params]`` (``zero=0``) or ``zero.init`` / ``zero.init_rank_major``
(ZeRO), and ``tx`` an ``optim`` transformation.  The model runs through
``torch.func.functional_call`` on these tensors in training mode; the
loss is the mean softmax cross-entropy of the logits against integer
labels.  Every call returns new tensors.

Two forms, as ``parallel/zero.py`` has:

- :func:`make_bn_dp_train_step`: the process world, one rank per process
  (NCCL or gloo), each process passing its own local batch;
- :func:`make_bn_dp_train_step_rank_major`: n ranks' batches on one device
  (the JAX package's eager mode).  ``images`` is the global batch, rank r
  taking the r-th of n equal slices, as JAX's ``shard_map`` splits it; one
  module runs the ranks one after another from the same parameters and
  statistics; the gradients are stacked [n, ...] and synced by
  ``fusion.fused_allreduce_rank_major_`` / ``zero.*_rank_major``, and the
  ranks' new statistics, stacked [n, C], are averaged on the same route.

Not ported yet, and refused by name: ``overlap="auto"`` or
``Config.gradsync_overlap`` (ROADMAP queue A, item 3 b), ``n_buckets``
other than None or 1 (item 3 c), and a ``Config.analysis`` or
``Config.obs`` other than "off" (items 11 and 10).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import collectives, fusion, optim, runtime
from .models import layers
from .parallel import gradsync
from .parallel import zero as pzero

Tensors = Sequence[torch.Tensor]


def _refuse_unported(n_buckets: Optional[int], overlap: Optional[str]):
    cfg = runtime.effective_config()
    if overlap is None:
        overlap = cfg.gradsync_overlap
    if overlap not in ("off", "auto"):
        raise ValueError(f"overlap must be off|auto, got {overlap!r}")
    if overlap == "auto":
        raise NotImplementedError(
            "overlap='auto': the backprop-overlapped gradient sync is not "
            "ported yet (ROADMAP queue A, item 3 b)")
    if n_buckets not in (None, 1):
        raise NotImplementedError(
            f"n_buckets={n_buckets}: the bucketed gradient allreduce "
            "(Config.gradsync_buckets) is not ported yet (ROADMAP queue A, "
            "item 3 c)")
    if cfg.analysis != "off":
        raise NotImplementedError(
            f"Config.analysis={cfg.analysis!r}: the static collective "
            "analysis is not ported yet (ROADMAP queue A, item 11)")
    if cfg.obs != "off":
        raise NotImplementedError(
            f"Config.obs={cfg.obs!r}: the telemetry layer is not ported yet "
            "(ROADMAP queue A, item 10)")


def _check_zero(zero, params_template):
    zero = int(zero)
    if zero not in (0, 1, 3):
        raise ValueError(f"zero must be 0, 1, or 3, got {zero}")
    if zero == 3 and params_template is None:
        raise ValueError(
            "zero=3 stores params as a flat shard; pass params_template (the "
            "full parameter list, or tensors of its shapes and dtypes on the "
            "meta device) so the step can map shards back to the model")
    return zero


def _local_step(model: torch.nn.Module, remat: bool) -> Callable:
    """``(params, batch_stats, images, labels) -> (loss, grads,
    new_batch_stats)`` of one rank: the forward in training mode through
    ``functional_call`` (rematerialized in the backward with ``remat``),
    the mean cross-entropy, its gradients with respect to ``params``."""
    names = [n for n, _ in model.named_parameters()]
    stat_names = layers.batch_stats_names(model)

    def run(params, batch_stats, images, labels):
        leaves = [p.detach().requires_grad_() for p in params]
        tensors = dict(zip(names, leaves, strict=True))
        tensors.update(zip(stat_names, batch_stats, strict=True))

        def forward(x):
            return torch.func.functional_call(model, tensors, (x,),
                                              {"train": True})

        logits = (checkpoint(forward, images, use_reentrant=False)
                  if remat else forward(images))
        loss = F.cross_entropy(logits.float(), labels.long())
        # Contiguous for the fused collectives: a channels-last input gives
        # channels-last conv weight gradients.
        grads = [g.contiguous() for g in torch.autograd.grad(loss, leaves)]
        # Read after the backward: a rematerialized forward wrote the same
        # values again, from the same starting statistics.
        return loss.detach(), grads, layers.new_batch_stats(model)

    return run


def _tx_update(tx: optim.GradientTransformation, grads: Tensors,
               opt_state: Sequence, params: Tensors):
    """``tx`` over a list of tensors (optax over a pytree): per tensor."""
    out = [tx.update(g, s, p) for g, s, p in zip(grads, opt_state, params,
                                                  strict=True)]
    return ([optim.apply_updates(p, u) for p, (u, _) in zip(params, out)],
            [s for _, s in out])


def make_bn_dp_train_step(model: torch.nn.Module,
                          tx: optim.GradientTransformation, *,
                          backend: Optional[str] = None,
                          n_buckets: Optional[int] = None,
                          remat: bool = False, zero: int = 0,
                          params_template: Optional[Tensors] = None,
                          overlap: Optional[str] = None) -> Callable:
    """The data-parallel step of this process's rank (JAX :24): local
    gradients on this rank's batch, synced across the world
    (:func:`gradsync.synchronize_gradient_tensors`, or ``zero.update`` /
    ``zero.update3`` for ``zero=1`` / ``3``), the new running statistics
    averaged with the fused allreduce (op "mean", ``backend``), the loss
    averaged.  ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``)."""
    _refuse_unported(n_buckets, overlap)
    zero = _check_zero(zero, params_template)
    spec3 = (pzero.flat_spec(list(params_template)) if zero == 3 else None)
    local = _local_step(model, remat)

    def step(params, opt_state, batch_stats, images, labels):
        full = (pzero.gather_params(params, spec3, backend=backend)
                if zero == 3 else list(params))
        loss, grads, new_stats = local(full, batch_stats, images, labels)
        if zero == 3:
            params, opt_state = pzero.update3(params, grads, opt_state, tx,
                                              spec=spec3, backend=backend)
        elif zero == 1:
            params, opt_state = pzero.update(full, grads, opt_state, tx,
                                             backend=backend)
        else:
            gradsync.synchronize_gradient_tensors(grads, backend=backend)
            params, opt_state = _tx_update(tx, grads, opt_state, full)
        fusion.fused_("allreduce", new_stats, backend=backend, op="mean")
        loss = collectives.allreduce_in_axis(loss, op="mean")
        return params, opt_state, new_stats, loss

    return step


def make_bn_dp_train_step_rank_major(model: torch.nn.Module,
                                     tx: optim.GradientTransformation,
                                     n: int, *,
                                     backend: Optional[str] = None,
                                     n_buckets: Optional[int] = None,
                                     remat: bool = False, zero: int = 0,
                                     params_template: Optional[Tensors] = None,
                                     overlap: Optional[str] = None
                                     ) -> Callable:
    """:func:`make_bn_dp_train_step` for ``n`` ranks on one device: the
    global batch split in n, each rank's gradients and new statistics
    stacked rank-major, the gradients synced by
    :func:`gradsync.synchronize_gradients_rank_major` (``zero=0``) or
    ``zero.update_rank_major`` / ``update3_rank_major``, the statistics by
    ``fusion.fused_allreduce_rank_major_`` (op "mean", ``backend``), the
    loss the mean of the ranks'.  ``opt_state`` is ``[tx.init(p) for p in
    params]`` (one state serves every rank) or
    ``zero.init_rank_major(params, tx, n)``; for ``zero=3`` ``params`` is
    the [n, shard] stack of ``zero.shard_params_rank_major``."""
    _refuse_unported(n_buckets, overlap)
    zero = _check_zero(zero, params_template)
    spec3 = (pzero.flat_spec(list(params_template), n_shards=n)
             if zero == 3 else None)
    local = _local_step(model, remat)

    def step(params, opt_state, batch_stats, images, labels):
        if images.shape[0] % n or labels.shape[0] != images.shape[0]:
            raise ValueError(f"a global batch of {images.shape[0]} images "
                             f"and {labels.shape[0]} labels does not split "
                             f"over {n} ranks")
        full = (pzero.gather_params_rank_major(params, spec3,
                                               backend=backend)
                if zero == 3 else list(params))
        xs = images.reshape(n, -1, *images.shape[1:])
        ys = labels.reshape(n, -1)
        if zero:
            spec = spec3 if zero == 3 else pzero.flat_spec(full, n_shards=n)
            flats, stacks = fusion.rank_major_buffers(spec, n,
                                                      device=images.device)
        else:
            stacks = [p.new_empty((n, *p.shape)) for p in full]
        stat_stacks = [s.new_empty((n, *s.shape)) for s in batch_stats]
        losses = []
        for r in range(n):
            loss, grads, new_stats = local(full, batch_stats, xs[r], ys[r])
            losses.append(loss)
            for st, g in zip(stacks, grads, strict=True):
                st[r].copy_(g)
            for st, s in zip(stat_stacks, new_stats, strict=True):
                st[r].copy_(s)
            del grads, new_stats
        if zero == 3:
            params, opt_state = pzero.update3_rank_major(
                params, flats, opt_state, tx, spec=spec3, backend=backend)
        elif zero == 1:
            params, opt_state = pzero.update_rank_major(
                full, flats, opt_state, tx, backend=backend)
        else:
            gradsync.synchronize_gradients_rank_major(stacks,
                                                      backend=backend)
            params, opt_state = _tx_update(tx, [st[0] for st in stacks],
                                           opt_state, full)
        fusion.fused_allreduce_rank_major_(stat_stacks, backend=backend,
                                           op="mean")
        return (params, opt_state, [st[0] for st in stat_stacks],
                torch.stack(losses).mean())

    return step


def bn_state(model: torch.nn.Module) -> Tuple[List[torch.Tensor],
                                                List[torch.Tensor]]:
    """Detached copies of the model's parameters (``named_parameters()``
    order) and running statistics (``layers.batch_stats`` order): the
    step's ``params`` and ``batch_stats``."""
    return ([p.detach().clone() for p in model.parameters()],
            [s.detach().clone() for s in layers.batch_stats(model)])


@torch.no_grad()
def load_bn_state(model: torch.nn.Module, params: Tensors,
                  batch_stats: Tensors) -> torch.nn.Module:
    """Copy a step's ``params`` and ``batch_stats`` into the model (for
    evaluation with ``model(x, train=False)``, or export)."""
    for p, v in zip(model.parameters(), params, strict=True):
        p.copy_(v)
    for s, v in zip(layers.batch_stats(model), batch_stats, strict=True):
        s.copy_(v)
    return model


def replicate_bn_state(params: Tensors, opt_state: Sequence,
                       batch_stats: Tensors, *,
                       backend: Optional[str] = None):
    """Broadcast (params, opt_state, batch_stats) from rank 0, in place:
    the synchronizeParameters step of the recipe (JAX :287).  Returns the
    three."""
    state_tensors = [t for s in opt_state for t in s if torch.is_tensor(t)]
    for tensors in (params, state_tensors, batch_stats):
        gradsync.synchronize_parameters(list(tensors), backend=backend)
    return params, opt_state, batch_stats
