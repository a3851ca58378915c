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
shard.

``dcn_residuals`` (state from :func:`init_dcn_residuals`) takes the
error-feedback dcn leg (JAX :165-300): per dtype group,
``compress.ef_group_reduce_scatter``, the reduce-scatter over ici in the
group's dtype, the shard plus its residual quantized by ``dcn_compress``
(default ``Config.dcn_compress``) across dcn, each rank landing on its
dcn-major shard; the entries then return the new residuals as a third
value.  ``backend=`` still routes the parameter all-gather; ``compress=``
raises.  On a flat world the leg is the plain reduce-scatter (warned
once) and the residuals come back unchanged; with ``presynced`` they pass
through.  ``flat_spec`` / ``shard_params`` and the process-world entries
take ``axis_names`` ("dcn", "ici" or both); ``flat_spec`` is planned
(``planner.flat_spec_for``).  The JAX package's guard, telemetry and
static-analysis hooks belong to modules the port does not have yet (queue
A 10, 11).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import collectives, fusion, optim, planner, runtime
from ..config import wire_compress

Tensors = Sequence[torch.Tensor]


def _axis(axis_names) -> Tuple[int, int]:
    """(ranks, this process's index) of the axes ZeRO shards over: the
    world, or one of its axes."""
    axis = collectives._world_axes("zero", axis_names)
    if axis is None:
        return runtime.size(), runtime.rank()
    return (runtime.grid()[0 if axis == "dcn" else 1],
            runtime.axis_index(axis))


def _resolve(op: Optional[str], compress: Optional[str], dcn_residuals=None,
             dcn_compress=None, backend=None):
    """``op``, ``compress`` and the EF codec with the Config's defaults
    (mean when ``gradsync_average``; ``gradsync_compress``;
    ``dcn_compress`` when ``dcn_residuals`` are given), validated before
    any communication."""
    cfg = runtime.effective_config()
    if op is None:
        op = "mean" if cfg.gradsync_average else "sum"
    if op not in ("mean", "sum"):
        raise ValueError(f"zero update op must be mean|sum, got {op!r}")
    explicit = compress is not None
    if compress is None:
        compress = cfg.gradsync_compress
    compress = wire_compress(compress, site="zero update")
    codec = None
    if dcn_residuals is not None:
        from .. import compress as _codec

        codec = _codec.resolve_ef(
            dcn_compress, cfg, site="zero update", backend=backend,
            explicit_compress=explicit, compress=compress,
            allow_backend=True)
    return op, compress, codec


def flat_spec(params: Tensors, axis_names=None, *,
              n_shards: Optional[int] = None) -> fusion.FusedSpec:
    """The flatten / shard layout of ``params`` over ``n_shards`` ranks
    (default: the ranks of ``axis_names``, the world's by default), the one
    object the shard functions need; planned once per (shapes, dtypes,
    n_shards) (``planner.flat_spec_for``, JAX :89-94)."""
    if n_shards is None:
        n_shards = _axis(axis_names)[0]
    return planner.flat_spec_for(params, n_shards)


def init_dcn_residuals(params: Tensors, axis_names=None, *,
                       n: Optional[int] = None,
                       device=None) -> List[torch.Tensor]:
    """Zeroed error-feedback state of the ZeRO gradient leg (JAX :165):
    one float32 accumulator per dtype group, the group's ici-scattered
    intermediate long (``padded / n_ici``): [len] for this process's rank,
    [n, len] for a rank-major stack of ``n`` ranks."""
    from .. import compress as _codec

    _codec.ef_axes(axis_names)
    params = list(params)
    n_shards = n if n is not None else runtime.size()
    spec = flat_spec(params, n_shards=n_shards)
    n_ici = runtime.grid(n)[1]
    return _codec.init_residuals(
        _codec.expected_shards([g.padded for g in spec.groups], n_ici), n,
        device=device if device is not None else params[0].device)


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
        _check_flat(g, flat)
        if compress == "bf16":
            flat = flat.to(torch.bfloat16)
        parts.append(reduce_scatter(flat).to(spec.dtype))
    return _joined(parts, spec, op)


def _check_flat(g, flat: torch.Tensor) -> None:
    if flat.shape[-1] != g.padded:
        raise ValueError(f"group flat of {flat.shape[-1]} elements, the "
                         f"spec's {g.dtype} group pads to {g.padded}")


def _joined(parts, spec: fusion.FusedSpec, op: str) -> torch.Tensor:
    g_shard = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    if op == "mean":
        g_shard = g_shard / spec.n_shards
    return g_shard


def _ef_grads(flats: Sequence[torch.Tensor], spec: fusion.FusedSpec, *,
              op: str, codec: str, dcn_residuals, n: Optional[int]):
    """The error-feedback gradient leg (JAX :322-360): per dtype group
    flat, ``compress.ef_group_reduce_scatter`` (its rank-major form for a
    stack of ``n``), the shards promoted and joined as
    :func:`_reduce_scatter_grads` joins them.  Returns ``(g_shard,
    new_residuals)``."""
    from .. import compress as _codec

    n_ici = runtime.grid(n)[1]
    res_list = _codec.check_residuals(
        dcn_residuals, _codec.expected_shards(
            [g.padded for g in spec.groups], n_ici),
        site="zero update", layout="the dtype-group bucket layout", n=n,
        init_hint="zero.init_dcn_residuals(params, ...) from the SAME "
                  "params/axes")
    leg = (_codec.ef_group_reduce_scatter if n is None
           else _codec.ef_group_reduce_scatter_rank_major)
    min_bytes = runtime.effective_config().dcn_compress_min_bytes
    parts, new_res = [], []
    for g, flat, r in zip(spec.groups, flats, res_list, strict=True):
        _check_flat(g, flat)
        shard, nr = leg(flat, codec, r, min_bytes=min_bytes)
        parts.append(shard.to(spec.dtype))
        new_res.append(nr)
    return _joined(parts, spec, op), new_res


def _grad_leg(flats, spec, *, op, compress, codec, dcn_residuals, presynced,
              local, reduce_scatter, n: Optional[int]):
    """The gradient leg of every entry: ``local()`` (presynced), the EF leg
    on a two-level grid, or the reduce-scatter (warned once where residuals
    meet a flat grid).  Returns ``(g_shard, new_residuals)``."""
    if presynced:
        return local(), dcn_residuals
    if codec is not None:
        if runtime.grid(n)[0] > 1:
            return _ef_grads(flats, spec, op=op, codec=codec,
                             dcn_residuals=dcn_residuals, n=n)
        from .. import selector

        selector._note_fallback("reduce_scatter", "dcn-" + codec,
                                "flat world (n_dcn <= 1)",
                                target="the plain reduce_scatter leg")
    return (_reduce_scatter_grads(flats, spec, op=op, compress=compress,
                                  reduce_scatter=reduce_scatter),
            dcn_residuals)


def _out(result: tuple, dcn_residuals, new_res) -> tuple:
    return result if dcn_residuals is None else result + (new_res,)


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
    """This rank's flat ZeRO-3 shard [shard] of the replicated ``params``
    (over the world, or over one of its axes)."""
    n, index = _axis(axis_names)
    return fusion.local_shard(params, flat_spec(params, n_shards=n), index)


def _process_grad_leg(grads: Tensors, spec, axis_names, *, op, compress,
                      codec, backend, presynced, dcn_residuals):
    n, index = _axis(axis_names)
    if codec is not None:
        from .. import compress as _codec

        _codec.ef_axes(axis_names)
        if collectives._world_axes("zero", axis_names) is not None:
            raise ValueError("zero dcn_residuals: error feedback needs "
                             "both axes, (dcn, ici)")
    flats = [fusion.group_flat(grads, g, pad=True) for g in spec.groups]
    return _grad_leg(
        flats, spec, op=op, compress=compress, codec=codec,
        dcn_residuals=dcn_residuals, presynced=presynced, n=None,
        local=lambda: fusion.local_shard(grads, spec, index),
        reduce_scatter=lambda f: collectives.reduce_scatter_in_axis(
            f, axis_names, backend=backend))


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
    its shard of them instead of reduce-scattering.  ``dcn_residuals``:
    the error-feedback leg, and ``(new_params, new_opt_state,
    new_residuals)``."""
    op, compress, codec = _resolve(op, compress, dcn_residuals, dcn_compress,
                                   backend)
    n, index = _axis(axis_names)
    spec = flat_spec(params, n_shards=n)
    g_shard, new_res = _process_grad_leg(
        grads, spec, axis_names, op=op, compress=compress, codec=codec,
        backend=backend, presynced=presynced, dcn_residuals=dcn_residuals)
    p_shard = fusion.local_shard(params, spec, index)
    updates, new_state = tx.update(g_shard, opt_state, p_shard)
    p_shard = optim.apply_updates(p_shard, updates)
    return _out((gather_params(p_shard, spec, axis_names, backend=backend),
                 new_state), dcn_residuals, new_res)


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
    all-gather (``presynced`` and ``dcn_residuals`` likewise).  Returns
    ``(new_p_shard, new_opt_state)``; the parameters stay sharded until
    the next :func:`gather_params`."""
    op, compress, codec = _resolve(op, compress, dcn_residuals, dcn_compress,
                                   backend)
    g_shard, new_res = _process_grad_leg(
        grads, spec, axis_names, op=op, compress=compress, codec=codec,
        backend=backend, presynced=presynced, dcn_residuals=dcn_residuals)
    updates, new_state = tx.update(g_shard, opt_state, p_shard)
    return _out((optim.apply_updates(p_shard, updates), new_state),
                dcn_residuals, new_res)


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
        _check_flat(g, flat)
        parts.append(flat.view(n, n, g.shard)[rows, rows].to(spec.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _rank_major_shard_grads(grad_flats, spec, op, compress, backend,
                            presynced=False) -> torch.Tensor:
    """Every rank's gradient shard [n, spec.shard] without error feedback
    (the leg :func:`update_rank_major` runs)."""
    return _rank_major_grad_leg(
        grad_flats, spec, op=op, compress=compress, codec=None,
        backend=backend, presynced=presynced, dcn_residuals=None)[0]


def _rank_major_grad_leg(grad_flats, spec, *, op, compress, codec, backend,
                         presynced, dcn_residuals):
    return _grad_leg(
        grad_flats, spec, op=op, compress=compress, codec=codec,
        dcn_residuals=dcn_residuals, presynced=presynced, n=spec.n_shards,
        local=lambda: _presynced_shards(grad_flats, spec),
        reduce_scatter=lambda f: collectives.reduce_scatter_rank_major(
            f, backend=backend))


@torch.no_grad()
def update_rank_major(params: Tensors, grad_flats: Sequence[torch.Tensor],
                      opt_state, tx: optim.GradientTransformation, *,
                      op: Optional[str] = None,
                      backend: Optional[str] = None,
                      compress: Optional[str] = None,
                      presynced: bool = False, dcn_residuals=None,
                      dcn_compress: Optional[str] = None):
    """:func:`update` for n ranks on one device: ``params`` the replicated
    list, ``grad_flats`` the n ranks' gradients as group flats
    [n, g.padded], ``opt_state`` over the [n, shard] stack.  Returns
    ``(new_params, new_opt_state)``; the new parameters are rank 0's slice
    of the all-gather (every rank's is the same).  ``presynced=True``:
    every rank's row already holds the reduced gradients, and rank r
    slices its shard r of them.  ``dcn_residuals`` ([n, len] state of
    :func:`init_dcn_residuals` with ``n``): the error-feedback leg on the
    grid of n, and the new residuals as a third value."""
    op, compress, codec = _resolve(op, compress, dcn_residuals, dcn_compress,
                                   backend)
    spec = flat_spec(params, n_shards=grad_flats[0].shape[0])
    g_shard, new_res = _rank_major_grad_leg(
        grad_flats, spec, op=op, compress=compress, codec=codec,
        backend=backend, presynced=presynced, dcn_residuals=dcn_residuals)
    p_shard = fusion.local_shards(params, spec)
    updates, new_state = tx.update(g_shard, opt_state, p_shard)
    p_shard = optim.apply_updates(p_shard, updates)
    return _out((gather_params_rank_major(p_shard, spec, backend=backend),
                 new_state), dcn_residuals, new_res)


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
                       presynced: bool = False, dcn_residuals=None,
                       dcn_compress: Optional[str] = None):
    """:func:`update3` for n ranks on one device: ``p_shards`` [n, shard]
    (``presynced`` and ``dcn_residuals`` as in :func:`update_rank_major`).
    Returns ``(new_p_shards, new_opt_state)``."""
    op, compress, codec = _resolve(op, compress, dcn_residuals, dcn_compress,
                                   backend)
    g_shard, new_res = _rank_major_grad_leg(
        grad_flats, spec, op=op, compress=compress, codec=codec,
        backend=backend, presynced=presynced, dcn_residuals=dcn_residuals)
    updates, new_state = tx.update(g_shard, opt_state, p_shards)
    return _out((optim.apply_updates(p_shards, updates), new_state),
                dcn_residuals, new_res)


@torch.no_grad()
def unshard_params_rank_major(p_shards: torch.Tensor,
                              params_template: Tensors
                              ) -> List[torch.Tensor]:
    """The full parameter list from [n, shard] shards, with no
    communication."""
    spec = flat_spec(params_template, n_shards=p_shards.shape[0])
    return fusion.unflatten_shards(p_shards, spec)
