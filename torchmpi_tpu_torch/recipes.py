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

``overlap="auto"`` (default ``Config.gradsync_overlap``) takes the
gradients through the backprop-overlapped sync
(``gradsync.make_overlapped_grad_fn``, its rank-major form for the
rank-major step): each bucket's allreduce fires from the backward, the
gradients come back reduced, and ZeRO runs ``presynced=True``.
``n_buckets`` (default ``Config.gradsync_buckets``) buckets the replicated
sync (JAX :35, :78-83, :117-140); with overlap or ZeRO it does not apply.
Not ported yet, and refused by name: a ``Config.analysis`` or
``Config.obs`` other than "off" (ROADMAP queue A, items 11 and 10).

FSDP (JAX :188-281): :func:`fsdp_specs` names each parameter's shard dim,
and :func:`make_fsdp_train_step` / :func:`make_fsdp_train_step_rank_major`
keep the parameters and the optimizer state sharded per parameter.  JAX's
compiler inserts the gathers and the gradient reduce-scatters; here the
step issues them: every sharded leaf gathered at the top of the step
(once, not layer by layer: ROADMAP queue C note 15), the gradients
reduce-scattered as one tree in the tile-interleaved layout of
``fusion``, ``tx`` applied to the shards.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import _tree, collectives, fusion, optim, runtime
from .models import layers
from .parallel import gradsync
from .parallel import zero as pzero

Tensors = Sequence[torch.Tensor]


def _overlap_on(overlap: Optional[str]) -> bool:
    """Whether the step overlaps its sync (``overlap``, default
    ``Config.gradsync_overlap``); refuses the layers not ported yet."""
    cfg = runtime.effective_config()
    if overlap is None:
        overlap = cfg.gradsync_overlap
    if overlap not in ("off", "auto"):
        raise ValueError(f"overlap must be off|auto, got {overlap!r}")
    _refuse_unported(cfg)
    return overlap == "auto"


def _refuse_unported(cfg) -> None:
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


def _loss_of(model: torch.nn.Module, remat: bool) -> Callable:
    """``(leaves, batch_stats, images, labels) -> (loss, new_batch_stats)``
    of one rank: the forward in training mode through ``functional_call``
    on the parameter ``leaves`` (rematerialized in the backward with
    ``remat``), the mean cross-entropy.  The new statistics are the
    forward's; a rematerialized forward writes the same values again,
    from the same starting statistics."""
    names = [n for n, _ in model.named_parameters()]
    stat_names = layers.batch_stats_names(model)

    def loss_fn(leaves, batch_stats, images, labels):
        tensors = dict(zip(names, leaves, strict=True))
        tensors.update(zip(stat_names, batch_stats, strict=True))

        def forward(x):
            return torch.func.functional_call(model, tensors, (x,),
                                              {"train": True})

        logits = (checkpoint(forward, images, use_reentrant=False)
                  if remat else forward(images))
        loss = F.cross_entropy(logits.float(), labels.long())
        return loss, layers.new_batch_stats(model)

    return loss_fn


def _local_step(loss_fn: Callable) -> Callable:
    """``(params, batch_stats, images, labels) -> (loss, grads,
    new_batch_stats)`` of one rank: ``loss_fn`` (:func:`_loss_of`) and its
    gradients with respect to ``params``."""

    def run(params, batch_stats, images, labels):
        leaves = [p.detach().requires_grad_() for p in params]
        loss, new_stats = loss_fn(leaves, batch_stats, images, labels)
        # Contiguous for the fused collectives: a channels-last input gives
        # channels-last conv weight gradients.
        grads = [g.contiguous() for g in torch.autograd.grad(loss, leaves)]
        return loss.detach(), grads, new_stats

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
    (:func:`gradsync.synchronize_gradient_tensors` with ``n_buckets``, or
    ``zero.update`` / ``zero.update3`` for ``zero=1`` / ``3``), the new
    running statistics averaged with the fused allreduce (op "mean",
    ``backend``), the loss averaged.  ``overlap="auto"`` takes the
    gradients through ``gradsync.make_overlapped_grad_fn`` (already
    synced; ZeRO ``presynced``).  ``remat`` recomputes the forward in the
    backward (``torch.utils.checkpoint``)."""
    overlap_on = _overlap_on(overlap)
    zero = _check_zero(zero, params_template)
    spec3 = (pzero.flat_spec(list(params_template)) if zero == 3 else None)
    loss_fn = _loss_of(model, remat)
    local = _local_step(loss_fn)

    def step(params, opt_state, batch_stats, images, labels):
        full = (pzero.gather_params(params, spec3, backend=backend)
                if zero == 3 else list(params))
        if overlap_on:
            vag = gradsync.make_overlapped_grad_fn(
                lambda leaves, x, y: loss_fn(leaves, batch_stats, x, y),
                full, backend=backend, has_aux=True)
            (loss, new_stats), grads = vag(full, images, labels)
        else:
            loss, grads, new_stats = local(full, batch_stats, images, labels)
        if zero == 3:
            params, opt_state = pzero.update3(
                params, grads, opt_state, tx, spec=spec3, backend=backend,
                presynced=overlap_on)
        elif zero == 1:
            params, opt_state = pzero.update(full, grads, opt_state, tx,
                                             backend=backend,
                                             presynced=overlap_on)
        else:
            if not overlap_on:
                gradsync.synchronize_gradient_tensors(
                    grads, backend=backend, n_buckets=n_buckets)
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
    the [n, shard] stack of ``zero.shard_params_rank_major``.
    ``overlap="auto"`` runs the ranks through
    ``gradsync.make_overlapped_grad_fn_rank_major``: the last rank's
    backward fires each bucket's allreduce on a side stream, and ZeRO
    takes the synced stacks ``presynced``."""
    overlap_on = _overlap_on(overlap)
    zero = _check_zero(zero, params_template)
    spec3 = (pzero.flat_spec(list(params_template), n_shards=n)
             if zero == 3 else None)
    loss_fn = _loss_of(model, remat)
    local = _local_step(loss_fn)

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
        if overlap_on:
            vag = gradsync.make_overlapped_grad_fn_rank_major(
                lambda leaves, x, y: loss_fn(leaves, batch_stats, x, y),
                full, n, backend=backend, has_aux=True)
            outs, stacks = vag(full, images, labels, stacks=stacks)
        else:
            outs = []
            for r in range(n):
                loss, grads, new_stats = local(full, batch_stats, xs[r],
                                               ys[r])
                outs.append((loss, new_stats))
                for st, g in zip(stacks, grads, strict=True):
                    st[r].copy_(g)
                del grads
        for r, (loss, new_stats) in enumerate(outs):
            losses.append(loss)
            for st, s in zip(stat_stacks, new_stats, strict=True):
                st[r].copy_(s)
        if zero == 3:
            params, opt_state = pzero.update3_rank_major(
                params, flats, opt_state, tx, spec=spec3, backend=backend,
                presynced=overlap_on)
        elif zero == 1:
            params, opt_state = pzero.update_rank_major(
                full, flats, opt_state, tx, backend=backend,
                presynced=overlap_on)
        else:
            if not overlap_on:
                gradsync.synchronize_gradients_rank_major(
                    stacks, backend=backend, n_buckets=n_buckets)
            params, opt_state = _tx_update(tx, [st[0] for st in stacks],
                                           opt_state, full)
        fusion.fused_allreduce_rank_major_(stat_stacks, backend=backend,
                                           op="mean")
        return (params, opt_state, [st[0] for st in stat_stacks],
                torch.stack(losses).mean())

    return step


# ---------------------------------------------------------------------------
# FSDP: parameters and optimizer state sharded per parameter (JAX :188-281)
# ---------------------------------------------------------------------------


def fsdp_specs(params, n: int):
    """Per leaf of ``params`` (any tree of tensors, or of anything with a
    ``shape``), the dim FSDP shards over ``n`` ranks: the largest dim that is
    at least ``n`` and divisible by ``n``, the first of equal ones; None (the
    leaf is replicated) where there is none.  JAX :188, which takes a mesh
    where this takes ``n`` and returns a ``PartitionSpec`` where this
    returns the dim."""

    def leaf_dim(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] >= n and shape[i] % n == 0:
                return i
        return None

    return _tree.map(leaf_dim, params)


def _apply_of(model: torch.nn.Module, remat: bool) -> Callable:
    """``apply_fn(params, *args, **kwargs)``: the model called functionally
    on ``params``, the list of its full parameters in ``named_parameters()``
    order; with ``remat`` the forward is recomputed in the backward
    (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``)."""
    names = [n for n, _ in model.named_parameters()]

    def apply_fn(params, *args, **kwargs):
        tensors = dict(zip(names, params, strict=True))

        def forward(*a):
            return torch.func.functional_call(model, tensors, a, kwargs)

        return (checkpoint(forward, *args, use_reentrant=False) if remat
                else forward(*args))

    return apply_fn


def _classifier_loss(apply_fn: Callable, params, images, labels):
    """The default FSDP objective: the mean softmax cross-entropy of the
    logits against integer labels (JAX :251-255)."""
    return F.cross_entropy(apply_fn(params, images).float(), labels.long())


def _donated(old, new):
    """``new``'s values written into ``old``'s tensors (a tensor, or a state
    tuple whose other fields are taken from ``new``): the memory that
    JAX's buffer donation reuses."""
    if isinstance(old, torch.Tensor):
        return old.copy_(new)
    return type(old)(*(o.copy_(v) if isinstance(o, torch.Tensor) else v
                       for o, v in zip(old, new, strict=True)))


def _fsdp_step(model, tx, dims, n: int, lead: int, *, gather, local_grads,
               reduce_scatter, allreduce_mean, loss_fn, remat, donate):
    """The FSDP step shared by both forms (``lead`` rank axes in front of
    a shard: 1 rank-major, 0 in the process world): gather every sharded
    leaf, the ranks' gradients (``local_grads``, in the tile layout), the
    gradient reduce-scatter (sum, then / n: the mean over ranks, as XLA's
    reduce-scatter of the global mean's gradient gives it), the replicated
    leaves' allreduce (mean), then ``tx`` on the shards (in place under
    ``donate``)."""
    apply_fn = _apply_of(model, remat)
    loss_fn = loss_fn or _classifier_loss
    sharded = [i for i, d in enumerate(dims) if d is not None]
    replicated = [i for i, d in enumerate(dims) if d is None]

    def step(params, opt_state, xb, yb):
        full = [gather(p, d) for p, d in zip(params, dims)]
        loss, tiles = local_grads(
            lambda leaves, x, y: loss_fn(apply_fn, leaves, x, y), full, xb,
            yb)
        del full
        grads: List = [None] * len(dims)
        for i, t in zip(sharded, reduce_scatter([tiles[i] for i in sharded])):
            grads[i] = t.movedim(lead, dims[i] + lead).contiguous().div_(n)
        for i, g in zip(replicated,
                        allreduce_mean([tiles[i] for i in replicated])):
            grads[i] = g
        del tiles
        new_params, new_state = [], []
        for p, s, g in zip(params, opt_state, grads, strict=True):
            u, ns = tx.update(g, s, p)
            np_ = optim.apply_updates(p, u)
            if donate:
                np_, ns = p.copy_(np_), _donated(s, ns)
            new_params.append(np_)
            new_state.append(ns)
        return new_params, new_state, loss

    return step


def _tile_view(t: torch.Tensor, d: Optional[int], lead: int) -> torch.Tensor:
    """``t`` with its shard dim ``d`` (counted after ``lead`` leading dims)
    moved to position ``lead``, contiguous: the tile layout a reduce-scatter
    or all-gather splits on its first dim.  A copy where d is not 0 (or
    ``t`` is not contiguous)."""
    return t.movedim(lead + d, lead).contiguous()


def make_fsdp_train_step_rank_major(model: torch.nn.Module,
                                    tx: optim.GradientTransformation,
                                    params: Tensors, n: int, *,
                                    backend: Optional[str] = None,
                                    remat: bool = False, donate: bool = True,
                                    loss_fn: Optional[Callable] = None):
    """FSDP of ``n`` ranks on one device (JAX :214): returns ``(step,
    params, opt_state)``, the parameters and optimizer state already
    sharded per leaf (:func:`fsdp_specs`).  ``params`` is the model's full
    parameter list (``named_parameters()`` order); a sharded leaf becomes
    the stack [n, *shard_shape] of the ranks' shards (rank r's is chunk r
    along the leaf's dim), a replicated leaf one tensor that every rank
    shares; ``opt_state`` is ``tx.init`` of each.

    ``step(params, opt_state, xb, yb) -> (params, opt_state, loss)``: each
    sharded leaf gathered by ``allgather_rank_major`` (its dim moved to the
    front and back; one copy of the ranks' identical results kept), rank r
    taking the r-th of n equal slices of the global batch through the model
    (``torch.func.functional_call``), the gradients stacked rank-major and
    reduce-scattered as one tree (``fusion.fused_reduce_scatter_rank_major``:
    one launch per bucket) and averaged, the replicated leaves' gradients
    averaged by ``fusion.fused_allreduce_rank_major_``, ``tx`` applied to the
    shards; the loss is the mean of the ranks'.  ``loss_fn(apply_fn, params,
    xb, yb)`` replaces the default mean cross-entropy of the logits
    against integer labels; ``apply_fn(params, *args, **kwargs)`` calls the
    model on a list of full tensors.  ``donate`` (default) updates the
    shard and state tensors in place; False returns new ones.  The global
    batch must split in n equal slices: the mean of the ranks' means is the
    global mean only then.  ``step.dims`` holds the shard dims (for
    :func:`fsdp_unshard_rank_major`) and ``step.layout_copy_bytes`` the
    bytes a step copies only to move a dim other than 0 to the front."""
    _refuse_unported(runtime.effective_config())
    params = [p.detach() for p in params]
    dims = fsdp_specs(params, n)
    shards = [p.clone() if d is None else torch.stack(p.chunk(n, d))
              for p, d in zip(params, dims)]
    opt_state = [tx.init(s) for s in shards]

    def gather(p, d):
        if d is None:
            return p
        out = collectives.allgather_rank_major(_tile_view(p, d, 1),
                                               backend=backend)
        # Every rank's gathered leaf is the same: keep one, free the rest.
        full = out[0].reshape(-1, *out.shape[3:])
        return full.movedim(0, d).clone(memory_format=torch.contiguous_format)

    def local_grads(objective, full, xb, yb):
        if xb.shape[0] % n or yb.shape[0] != xb.shape[0]:
            raise ValueError(f"a global batch of {xb.shape[0]} inputs and "
                             f"{yb.shape[0]} labels does not split over "
                             f"{n} ranks")
        # Slices keep the batch's memory format (a channels-last batch
        # stays channels-last), so each rank runs as a process would.
        xs, ys = xb.chunk(n), yb.chunk(n)
        # Each leaf's gradient stack in the tile layout: its shard dim in
        # front, so that the reduce-scatter splits it.
        tiles = [p.new_empty((n, *_moved(p.shape, d))) for p, d in
                 zip(full, dims)]
        losses = []
        for r in range(n):
            leaves = [p.detach().requires_grad_() for p in full]
            loss = objective(leaves, xs[r], ys[r])
            for t, g, d in zip(tiles, torch.autograd.grad(loss, leaves),
                               dims):
                t[r].copy_(g if not d else g.movedim(d, 0))
            losses.append(loss.detach())
        return torch.stack(losses).mean(), tiles

    def allreduce_mean(stacks):
        fusion.fused_allreduce_rank_major_(stacks, backend=backend,
                                           op="mean")
        return [st[0] for st in stacks]

    step = _fsdp_step(
        model, tx, dims, n, 1, gather=gather, local_grads=local_grads,
        reduce_scatter=lambda ts: fusion.fused_reduce_scatter_rank_major(
            ts, backend=backend, op="sum"),
        allreduce_mean=allreduce_mean, loss_fn=loss_fn, remat=remat,
        donate=donate)
    step.dims = dims
    step.layout_copy_bytes = _copy_bytes(params, dims, 1)
    return step, shards, opt_state


def make_fsdp_train_step(model: torch.nn.Module,
                         tx: optim.GradientTransformation, params: Tensors,
                         *, backend: Optional[str] = None,
                         remat: bool = False, donate: bool = True,
                         loss_fn: Optional[Callable] = None):
    """FSDP across the process world (JAX :214), this process one rank: as
    :func:`make_fsdp_train_step_rank_major`, but each process holds its own
    shard of every sharded leaf (chunk ``rank()`` along its dim) and passes
    its own slice of the global batch.  Each sharded leaf is gathered by
    ``allgather_in_axis``, the gradients of the sharded leaves go through
    one ``reduce_scatter_in_axis`` of a tree (fused in the
    tile-interleaved layout), those of the replicated leaves through one
    ``allreduce_in_axis`` (mean), and the loss is averaged."""
    _refuse_unported(runtime.effective_config())
    n, rank = runtime.size(), runtime.rank()
    params = [p.detach() for p in params]
    dims = fsdp_specs(params, n)
    shards = [(p if d is None else p.chunk(n, d)[rank]).clone(
        memory_format=torch.contiguous_format) for p, d in zip(params, dims)]
    opt_state = [tx.init(s) for s in shards]

    def local_grads(objective, full, xb, yb):
        leaves = [p.detach().requires_grad_() for p in full]
        loss = objective(leaves, xb, yb)
        tiles = [g if d is None else _tile_view(g, d, 0)
                 for g, d in zip(torch.autograd.grad(loss, leaves), dims)]
        return collectives.allreduce_in_axis(loss.detach(), op="mean"), tiles

    step = _fsdp_step(
        model, tx, dims, n, 0,
        gather=lambda p, d: p if d is None else _gather_world(p, d, backend),
        local_grads=local_grads,
        reduce_scatter=lambda ts: collectives.reduce_scatter_in_axis(
            ts, backend=backend),
        allreduce_mean=lambda gs: collectives.allreduce_in_axis(
            gs, op="mean", backend=backend),
        loss_fn=loss_fn, remat=remat, donate=donate)
    step.dims = dims
    step.layout_copy_bytes = _copy_bytes(params, dims, n)
    return step, shards, opt_state


def _gather_world(p: torch.Tensor, d: int, backend: Optional[str]):
    """The full leaf from every process's shard ``p`` (sharded on ``d``):
    the process-world all-gather of its tile layout, moved back."""
    out = collectives.allgather_in_axis(_tile_view(p, d, 0), backend=backend)
    return out.reshape(-1, *out.shape[2:]).movedim(0, d).contiguous()


def _moved(shape, d: Optional[int]) -> Tuple[int, ...]:
    """``shape`` with dim ``d`` moved to the front (unchanged for None)."""
    shape = tuple(shape)
    if not d:
        return shape
    return (shape[d],) + shape[:d] + shape[d + 1:]


def _copy_bytes(params: Tensors, dims, k: int) -> int:
    """Bytes a step copies only because a leaf is sharded on a dim other
    than 0: its shards moved to the tile layout, the gathered leaf moved
    back, its gradient shards moved back.  A shard copy moves 1/k of the
    leaf: k = 1 rank-major, where it moves every rank's shard, n in the
    process world."""
    return sum(p.numel() * p.element_size() * (k + 2) // k
               for p, d in zip(params, dims) if d)


def fsdp_unshard_rank_major(params: Tensors, dims) -> List[torch.Tensor]:
    """The full parameters from rank-major FSDP ``params`` (``dims`` =
    ``step.dims``): the shards concatenated along each leaf's dim.  JAX
    reads its sharded global arrays directly; this is the port's form."""
    return [p.clone() if d is None else torch.cat(p.unbind(0), d)
            for p, d in zip(params, dims)]


def fsdp_unshard(params: Tensors, dims, *,
                 backend: Optional[str] = None) -> List[torch.Tensor]:
    """The full parameters from this process's FSDP ``params`` (``dims`` =
    ``step.dims``), gathered from every rank: a collective, every process
    calls it."""
    return [p.clone() if d is None else _gather_world(p, d, backend)
            for p, d in zip(params, dims)]


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
