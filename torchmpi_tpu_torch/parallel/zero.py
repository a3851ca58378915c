"""ZeRO-1 / ZeRO-3 data parallelism: optimizer state (and parameters)
sharded over the ranks.

The PyTorch counterpart of ``torchmpi_tpu/parallel/zero.py``.  The DP
step's allreduce splits into a reduce-scatter of the gradients, the
optimizer on each rank's 1/n shard of the flat parameters, and an
all-gather of the updated shards: the same update as replicated DP, with
the optimizer state held once across the ranks instead of n times.  ZeRO-3
keeps the parameters sharded between steps too and all-gathers them at the
top of each step.  The shard layout is :class:`fusion.FusedSpec`'s, and
the legs go through the selector-routed collectives, so ``backend="pallas"``
runs them on the ring kernels.

Two forms:

- across processes, each rank holding its own tensors (``init``,
  ``update``, ``flat_spec``, ``shard_params``, ``gather_params``,
  ``update3``, ``unshard_params``), over ``collectives.reduce_scatter_in_axis``
  / ``allgather_in_axis``;
- rank-major, the n ranks' buffers on one device (the JAX package's eager
  mode, where the ring kernels run): ``*_rank_major``.  The parameters
  (ZeRO-1) are one replicated list, the gradients are the group flats
  [n, g.padded] of :func:`fusion.group_flats` or
  :func:`fusion.rank_major_buffers`, and shards and optimizer state are
  [n, shard] stacks.

The numerics are the JAX package's: one reduce-scatter per dtype group in
the group's own dtype (``compress="bf16"`` narrows it), each rank's group
shards promoted to the spec's dtype and concatenated group-major, ``op``
"mean" as the sum then ``/ n``.  Parameters and gradients are lists of
tensors; the optimizer is an ``optim`` ``(init, update)`` pair.  Like the
JAX functions, every entry returns new tensors and records no autograd
graph.

``presynced=True`` is the backprop-overlap mode (JAX :210-241,
:472-482): the gradients arrive already reduced
(``gradsync.make_overlapped_grad_fn``, ``op`` and ``compress`` applied
there), so the reduce-scatter leg becomes a local slice of this rank's
shard.  Not ported yet, and refused by name: the error-feedback DCN leg
(``dcn_residuals`` / ``dcn_compress``, ROADMAP queue A 4).  The JAX package's
guard, telemetry and static-analysis hooks and its planner cache belong to
modules the port does not have yet (queue A 5, 10, 11).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .. import collectives, fusion, optim, runtime
from ..config import wire_compress

Tensors = Sequence[torch.Tensor]


def _world(axis_names) -> int:
    collectives._world_axes("zero", axis_names)
    return runtime.size()


def _refuse_unported(dcn_residuals, dcn_compress) -> None:
    if dcn_residuals is not None or dcn_compress is not None:
        raise NotImplementedError(
            "zero dcn_residuals / dcn_compress: the error-feedback DCN leg "
            "is not ported yet (ROADMAP queue A, item 4)")


def _resolve(op: Optional[str], compress: Optional[str]):
    """``op`` and ``compress`` with the Config's defaults (mean when
    ``gradsync_average``; ``gradsync_compress``), validated before any
    communication."""
    cfg = runtime.effective_config()
    if op is None:
        op = "mean" if cfg.gradsync_average else "sum"
    if op not in ("mean", "sum"):
        raise ValueError(f"zero update op must be mean|sum, got {op!r}")
    if compress is None:
        compress = cfg.gradsync_compress
    return op, wire_compress(compress, site="zero update")


def flat_spec(params: Tensors, axis_names=None, *,
              n_shards: Optional[int] = None) -> fusion.FusedSpec:
    """The flatten / shard layout of ``params`` over ``n_shards`` ranks
    (default: the world's size), the one object the shard functions need."""
    if n_shards is None:
        n_shards = _world(axis_names)
    return fusion.FusedSpec(list(params), n_shards, max_bytes=0)


def _reduce_scatter_grads(flats: Sequence[torch.Tensor],
                          spec: fusion.FusedSpec, *, op: str,
                          compress: Optional[str],
                          reduce_scatter: Callable) -> torch.Tensor:
    """ZeRO's gradient leg: one ``reduce_scatter`` per dtype group flat
    (padded), in the group's own dtype or narrowed to bf16, each shard
    promoted to ``spec.dtype``, concatenated group-major (the
    :func:`fusion.local_shard` linearization) and divided by n for a
    mean."""
    parts = []
    for g, flat in zip(spec.groups, flats, strict=True):
        if flat.shape[-1] != g.padded:
            raise ValueError(f"group flat of {flat.shape[-1]} elements, the "
                             f"spec's {g.dtype} group pads to {g.padded}")
        if compress == "bf16":
            flat = flat.to(torch.bfloat16)
        parts.append(reduce_scatter(flat).to(spec.dtype))
    g_shard = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    if op == "mean":
        g_shard = g_shard / spec.n_shards
    return g_shard


# ---------------------------------------------------------------------------
# Across processes
# ---------------------------------------------------------------------------


@torch.no_grad()
def init(params: Tensors, tx: optim.GradientTransformation,
         axis_names=None):
    """The optimizer state of this rank's flat parameter shard (ZeRO-1 and
    ZeRO-3 alike)."""
    return tx.init(shard_params(params, axis_names))


@torch.no_grad()
def shard_params(params: Tensors, axis_names=None) -> torch.Tensor:
    """This rank's flat ZeRO-3 shard [shard] of the replicated ``params``."""
    spec = flat_spec(params, axis_names)
    return fusion.local_shard(params, spec, runtime.rank())


def _process_shard_grads(grads: Tensors, spec, op, compress, backend):
    return _reduce_scatter_grads(
        [fusion.group_flat(grads, g, pad=True) for g in spec.groups], spec,
        op=op, compress=compress,
        reduce_scatter=lambda f: collectives.reduce_scatter_in_axis(
            f, backend=backend))


@torch.no_grad()
def update(params: Tensors, grads: Tensors, opt_state,
           tx: optim.GradientTransformation, axis_names=None, *,
           op: Optional[str] = None, backend: Optional[str] = None,
           compress: Optional[str] = None, presynced: bool = False,
           dcn_residuals=None, dcn_compress: Optional[str] = None):
    """One ZeRO-1 step on this rank: reduce-scatter the gradients, ``tx``
    on the local parameter / state shard, all-gather the updated shards.
    Returns ``(new_params, new_opt_state)``, the same update as
    allreduce-then-``tx`` replicated DP.  ``op`` defaults to mean when
    ``Config.gradsync_average``; ``compress="bf16"`` (default
    ``Config.gradsync_compress``) narrows the gradient reduce-scatter, the
    parameter all-gather stays full precision.  ``presynced=True``: the
    ``grads`` are already reduced across the world, and this rank slices
    its shard of them instead of reduce-scattering."""
    _refuse_unported(dcn_residuals, dcn_compress)
    op, compress = _resolve(op, compress)
    spec = flat_spec(params, axis_names)
    g_shard = (fusion.local_shard(grads, spec, runtime.rank()) if presynced
               else _process_shard_grads(grads, spec, op, compress, backend))
    p_shard = fusion.local_shard(params, spec, runtime.rank())
    updates, new_state = tx.update(g_shard, opt_state, p_shard)
    p_shard = optim.apply_updates(p_shard, updates)
    return gather_params(p_shard, spec, backend=backend), new_state


@torch.no_grad()
def gather_params(p_shard: torch.Tensor, spec: fusion.FusedSpec,
                  axis_names=None, *,
                  backend: Optional[str] = None) -> List[torch.Tensor]:
    """All-gather the flat ZeRO-3 shards into the full parameter list."""
    flat = collectives.allgather_in_axis(p_shard, axis_names,
                                         backend=backend).reshape(-1)
    return fusion.unflatten_shards(flat, spec)


@torch.no_grad()
def update3(p_shard: torch.Tensor, grads: Tensors, opt_state,
            tx: optim.GradientTransformation, axis_names=None, *,
            spec: fusion.FusedSpec, op: Optional[str] = None,
            backend: Optional[str] = None, compress: Optional[str] = None,
            presynced: bool = False, dcn_residuals=None,
            dcn_compress: Optional[str] = None):
    """One ZeRO-3 step on this rank: as :func:`update` without the
    all-gather (``presynced`` likewise).  Returns ``(new_p_shard,
    new_opt_state)``; the parameters stay sharded until the next
    :func:`gather_params`."""
    _refuse_unported(dcn_residuals, dcn_compress)
    op, compress = _resolve(op, compress)
    g_shard = (fusion.local_shard(grads, spec, runtime.rank()) if presynced
               else _process_shard_grads(grads, spec, op, compress, backend))
    updates, new_state = tx.update(g_shard, opt_state, p_shard)
    return optim.apply_updates(p_shard, updates), new_state


@torch.no_grad()
def unshard_params(p_shard: torch.Tensor, params_template: Tensors,
                   axis_names=None, *,
                   backend: Optional[str] = None) -> List[torch.Tensor]:
    """The full parameter list from the ZeRO-3 shards (checkpoint export,
    evaluation)."""
    return gather_params(p_shard, flat_spec(params_template, axis_names),
                         axis_names, backend=backend)


# ---------------------------------------------------------------------------
# Rank-major: the n ranks' buffers on one device
# ---------------------------------------------------------------------------


@torch.no_grad()
def shard_params_rank_major(params: Tensors, n: int) -> torch.Tensor:
    """Every rank's flat ZeRO-3 shard of the replicated ``params``:
    [n, shard]."""
    return fusion.local_shards(params, flat_spec(params, n_shards=n))


@torch.no_grad()
def init_rank_major(params: Tensors, tx: optim.GradientTransformation,
                    n: int):
    """The optimizer state of every rank's shard, over the [n, shard]
    stack."""
    return tx.init(shard_params_rank_major(params, n))


def _presynced_shards(grad_flats: Sequence[torch.Tensor],
                      spec: fusion.FusedSpec) -> torch.Tensor:
    """Every rank's shard [n, spec.shard] of already-reduced group flats
    [n, g.padded]: rank r's slice r of each group, promoted to
    ``spec.dtype`` and concatenated group-major (a local slice, no
    communication)."""
    n = spec.n_shards
    rows = torch.arange(n, device=grad_flats[0].device)
    parts = []
    for g, flat in zip(spec.groups, grad_flats, strict=True):
        if flat.shape[-1] != g.padded:
            raise ValueError(f"group flat of {flat.shape[-1]} elements, the "
                             f"spec's {g.dtype} group pads to {g.padded}")
        parts.append(flat.view(n, n, g.shard)[rows, rows].to(spec.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _rank_major_shard_grads(grad_flats, spec, op, compress, backend,
                            presynced=False):
    if presynced:
        return _presynced_shards(grad_flats, spec)
    return _reduce_scatter_grads(
        grad_flats, spec, op=op, compress=compress,
        reduce_scatter=lambda f: collectives.reduce_scatter_rank_major(
            f, backend=backend))


@torch.no_grad()
def update_rank_major(params: Tensors, grad_flats: Sequence[torch.Tensor],
                      opt_state, tx: optim.GradientTransformation, *,
                      op: Optional[str] = None,
                      backend: Optional[str] = None,
                      compress: Optional[str] = None,
                      presynced: bool = False):
    """:func:`update` for n ranks on one device: ``params`` the replicated
    list, ``grad_flats`` the n ranks' gradients as group flats
    [n, g.padded], ``opt_state`` over the [n, shard] stack.  Returns
    ``(new_params, new_opt_state)``; the new parameters are rank 0's slice
    of the all-gather (every rank's is the same).  ``presynced=True``:
    every rank's row already holds the reduced gradients, and rank r
    slices its shard r of them."""
    op, compress = _resolve(op, compress)
    spec = flat_spec(params, n_shards=grad_flats[0].shape[0])
    g_shard = _rank_major_shard_grads(grad_flats, spec, op, compress, backend,
                                      presynced)
    p_shard = fusion.local_shards(params, spec)
    updates, new_state = tx.update(g_shard, opt_state, p_shard)
    p_shard = optim.apply_updates(p_shard, updates)
    return gather_params_rank_major(p_shard, spec, backend=backend), new_state


@torch.no_grad()
def gather_params_rank_major(p_shards: torch.Tensor, spec: fusion.FusedSpec,
                             *, backend: Optional[str] = None
                             ) -> List[torch.Tensor]:
    """All-gather the [n, shard] shards; the parameter list from rank 0's
    slice of the result."""
    gathered = collectives.allgather_rank_major(p_shards, backend=backend)
    return fusion.unflatten_shards(gathered[0], spec)


@torch.no_grad()
def update3_rank_major(p_shards: torch.Tensor,
                       grad_flats: Sequence[torch.Tensor], opt_state,
                       tx: optim.GradientTransformation, *,
                       spec: fusion.FusedSpec, op: Optional[str] = None,
                       backend: Optional[str] = None,
                       compress: Optional[str] = None,
                       presynced: bool = False):
    """:func:`update3` for n ranks on one device: ``p_shards`` [n, shard]
    (``presynced`` as in :func:`update_rank_major`).  Returns
    ``(new_p_shards, new_opt_state)``."""
    op, compress = _resolve(op, compress)
    g_shard = _rank_major_shard_grads(grad_flats, spec, op, compress, backend,
                                      presynced)
    updates, new_state = tx.update(g_shard, opt_state, p_shards)
    return optim.apply_updates(p_shards, updates), new_state


@torch.no_grad()
def unshard_params_rank_major(p_shards: torch.Tensor,
                              params_template: Tensors
                              ) -> List[torch.Tensor]:
    """The full parameter list from [n, shard] shards, with no
    communication."""
    spec = flat_spec(params_template, n_shards=p_shards.shape[0])
    return fusion.unflatten_shards(p_shards, spec)
