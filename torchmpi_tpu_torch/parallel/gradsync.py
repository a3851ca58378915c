"""Data-parallel parameter and gradient synchronization.

The PyTorch counterpart of ``torchmpi_tpu/parallel/gradsync.py``
(``synchronize_parameters`` :51, ``synchronize_gradients`` :243 with the
bucketed allreduce :204, ``overlap_bucket_bytes`` :410,
``assign_overlap_buckets`` :428, ``make_overlapped_grad_fn`` :616,
``accumulate_gradients`` :803, ``data_parallel_step`` :852), in the
reference's training-loop shape: broadcast the parameters once, then each
step computes local gradients, allreduces them, and applies the
optimizer.  The JAX package returns new pytrees; the port works on an
``nn.Module`` (or a list of parameters) and updates parameters and their
``.grad`` in place, as PyTorch training code does, so no second copy of a
model's state exists.

The overlapped sync is the reference's async per-layer hooks in DDP's
form: a tensor hook on every parameter leaf, each reverse-parameter-order
bucket's allreduce launched from the backward as the bucket's last
gradient arrives, in firing order (:func:`make_overlapped_grad_fn`; its
rank-major form launches on a side stream,
:func:`make_overlapped_grad_fn_rank_major`).

The error-feedback dcn leg (JAX :119-200, :243-360, :454-625): with
``residuals`` (state from :func:`init_dcn_residuals`, or
:func:`init_overlap_dcn_residuals` for the overlapped form) each bucket
runs the two-level allreduce of ``compress.ef_bucket_allreduce``, its dcn
shard quantized by ``dcn_compress`` (default ``Config.dcn_compress``)
after the residual is added back, and the new quantization error comes
back as the next step's state.  On a flat world (one dcn member) there is
no dcn leg: the call warns once, runs the plain sync and hands the
residuals back unchanged.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from .. import _tree, collectives, fusion, planner, runtime, selector
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


def resynchronize_parameters_in_axis(params, axis_names, *, root: int = 0,
                                     backend: Optional[str] = None):
    """The in-axis broadcast of a tree of parameters from ``root`` of
    ``axis_names`` (JAX :82): for state that may have diverged across the
    ranks of an axis (asynchronous PS training, debugging).  Returns the
    broadcast tree; the inputs are not modified."""
    return collectives.broadcast_in_axis(params, axis_names, root=root,
                                         backend=backend)


def resynchronize_parameters_in_axis_rank_major(stacks, axis_names, *,
                                                root: int = 0,
                                                backend: Optional[str] = None):
    """:func:`resynchronize_parameters_in_axis` on a tree of rank-major
    stacks [n, ...]: every rank's slice that of member ``root`` of its
    group of ``axis_names``."""
    return _tree.map(lambda x: collectives.broadcast_rank_major(
        x, root=root, backend=backend, axis_names=axis_names), stacks)


def _resolve(op: Optional[str], compress: Optional[str], site: str):
    """``op`` and ``compress`` with the Config's defaults (mean when
    ``gradsync_average``; ``gradsync_compress``)."""
    cfg = runtime.effective_config()
    if op is None:
        op = "mean" if cfg.gradsync_average else "sum"
    if compress is None:
        compress = cfg.gradsync_compress
    return op, wire_compress(compress, site=site)


def init_dcn_residuals(params_template: Params, axis_names=None, *,
                       n: Optional[int] = None,
                       n_buckets: Optional[int] = None,
                       device=None) -> List[torch.Tensor]:
    """Zeroed error-feedback state for :func:`synchronize_gradients` with
    a quantized dcn leg (JAX :119): one float32 accumulator per gradient
    bucket (``FusedSpec(n_buckets=)``, default ``Config.gradsync_buckets``),
    the bucket's ici-scattered extent long: [shard] for this process's
    rank, [n, shard] for a rank-major stack of ``n`` ranks (the template is
    one rank's parameters).  Thread it through the steps like optimizer
    state."""
    from .. import compress as _codec

    _codec.ef_axes(axis_names)
    template = _param_list(params_template)
    if n_buckets is None:
        n_buckets = runtime.effective_config().gradsync_buckets
    spec = fusion.FusedSpec(template, n_buckets=max(1, n_buckets))
    return _codec.init_residuals(
        _codec.expected_shards([hi - lo for g in spec.groups
                                for lo, hi in g.bounds], runtime.grid(n)[1]),
        n, device=device if device is not None else template[0].device)


def _dcn_ef_allreduce_(grads: List[torch.Tensor], *, op: str, n_buckets: int,
                       codec: str, residuals, n: Optional[int]):
    """The error-feedback two-level sync, in place (JAX :159): per dtype
    group bucket (``FusedSpec(n_buckets=)``), ``compress.ef_bucket_allreduce``
    (its rank-major form for stacks of ``n``).  Returns the new residuals
    in the old ones' shapes."""
    from .. import compress

    rank_major = n is not None
    spec = fusion.FusedSpec([t[0] for t in grads] if rank_major else grads,
                            n_buckets=max(1, n_buckets))
    shard_lens = compress.expected_shards(
        [hi - lo for g in spec.groups for lo, hi in g.bounds],
        runtime.grid(n)[1])
    res_list = compress.check_residuals(
        residuals, shard_lens, site="synchronize_gradients",
        layout="the gradient bucket layout", n=n,
        init_hint="gradsync.init_dcn_residuals(params, ...) using the "
                  "SAME n_buckets/tree")
    reduce = (compress.ef_bucket_allreduce_rank_major if rank_major
              else compress.ef_bucket_allreduce)
    min_bytes = runtime.effective_config().dcn_compress_min_bytes
    new_res, k = [], 0
    for g in spec.groups:
        for lo, hi in g.bounds:
            buf = fusion.gather_bucket(grads, g, lo, hi,
                                       rank_major=rank_major)
            red, nr = reduce(buf, codec, res_list[k], op=op,
                             min_bytes=min_bytes)
            fusion.scatter_bucket(red.to(buf.dtype), grads, g, lo,
                                  rank_major=rank_major)
            new_res.append(nr)
            k += 1
    return new_res


def _ef_route(residuals, dcn_compress, *, site: str, backend, compress,
              barrier, n: Optional[int], op_name: str = "allreduce"):
    """The codec of an EF call, or None where the world is flat (the
    degradation warned once, JAX :320-345); raises on the knobs the fixed
    two-level schedule does not take (explicit ``backend`` / ``compress``
    / ``barrier=True``)."""
    from .. import compress as _codec
    from .. import selector as _sel
    from ..config import wire_compress

    if barrier:
        raise ValueError(
            f"{site}: barrier= does not combine with error-feedback "
            f"residuals — the EF schedule orders its own collectives")
    codec = _codec.resolve_ef(dcn_compress, runtime.effective_config(),
                              site=site, backend=backend,
                              explicit_compress=compress is not None,
                              compress=wire_compress(compress, site=site))
    if runtime.grid(n)[0] <= 1:
        _sel._note_fallback(op_name, "dcn-" + codec,
                            "flat world (n_dcn <= 1)",
                            target="the plain sync path")
        return None
    return codec


def _obs_gradsync(n_buckets: int, op: str, compress) -> None:
    """With obs on, one sync round (JAX :347-370, :733-737):
    ``tm_gradsync_rounds_total{op, compressed}`` and
    ``tm_gradsync_buckets_total``, here the round's buckets as launched.
    Every call counts (JAX counts traces; ROADMAP queue C note 31)."""
    if runtime.effective_config().obs == "off":
        return
    from .. import obs

    obs.record_gradsync(n_buckets, op, compress)


def _numeric_guard() -> bool:
    """``Config.guard`` "numeric" | "full": one string compare a sync
    (``guard.py`` is never imported while it is off)."""
    return runtime.effective_config().guard in ("numeric", "full")


def _guarded(grads: List[torch.Tensor], rank_major: bool, residuals=None,
             new_res=None):
    """The numeric tripwire on a synced round (JAX :355-366, :383-391):
    one verdict over every gradient (a row's with ``rank_major``), the
    round zeroed in place when it trips; with ``residuals`` the new
    error-feedback residuals revert to the pre-step ones under the same
    verdict, and come back."""
    from .. import guard

    if residuals is None:
        guard.check_tree(grads, site="gradsync", rows=rank_major)
        return None
    _, reverted = guard.check_tree(grads, site="gradsync", rows=rank_major,
                                   aux=list(zip(new_res, residuals)))
    return reverted


def _sync_(grads: List[torch.Tensor], *, backend: Optional[str],
           op: Optional[str], compress: Optional[str],
           n_buckets: Optional[int], barrier: Optional[bool], residuals,
           dcn_compress, rank_major: bool):
    """The fused allreduce of ``grads`` (``fusion.fused_`` across
    processes, ``fusion.fused_allreduce_rank_major_`` on stacks) in place,
    with the Config's defaults for ``op``, ``compress`` and ``n_buckets``:
    ``n_buckets`` <= 1 rides the fused buckets (``fuse_max_bytes``), more
    the count-driven ``FusedSpec(n_buckets=)`` (JAX :204-240, :294).  With
    ``residuals``, the error-feedback sync (or, on a flat world, the plain
    one), returning the new residuals."""
    if residuals is not None:
        n = grads[0].shape[0] if rank_major and grads else None
        codec = _ef_route(residuals, dcn_compress,
                          site="synchronize_gradients", backend=backend,
                          compress=compress, barrier=barrier, n=n)
        if codec is None:
            _sync_(grads, backend=backend, op=op, compress=compress,
                   n_buckets=n_buckets, barrier=None, residuals=None,
                   dcn_compress=None, rank_major=rank_major)
            return residuals
        op, _ = _resolve(op, None, "synchronize_gradients")
        if n_buckets is None:
            n_buckets = runtime.effective_config().gradsync_buckets
        _obs_gradsync(max(1, n_buckets), op, f"dcn-{codec}")
        new_res = _dcn_ef_allreduce_(grads, op=op, n_buckets=n_buckets,
                                     codec=codec, residuals=residuals, n=n)
        if _numeric_guard():
            return _guarded(grads, rank_major, residuals, new_res)
        return new_res
    op, compress = _resolve(op, compress, "synchronize_gradients")
    if n_buckets is None:
        n_buckets = runtime.effective_config().gradsync_buckets
    wire = ([g.to(torch.bfloat16) for g in grads] if compress == "bf16"
            else grads)
    if planner.enabled() and wire:
        # The bucket layout and each bucket's route, bound once per
        # gradient structure (JAX :230-234).
        launches = planner.plan_gradsync(
            wire, n_buckets=n_buckets, backend=backend,
            barrier=bool(barrier), rank_major=rank_major,
            op=op).replay(wire)
        _obs_gradsync(launches, op, compress)
        if compress == "bf16":
            for g, w in zip(grads, wire):
                g.copy_(w)
        if _numeric_guard():
            _guarded(grads, rank_major)
        return None
    spec = None
    if n_buckets > 1 and wire:
        spec = fusion.FusedSpec([t[0] for t in wire] if rank_major else wire,
                                n_buckets=n_buckets)
    if rank_major:
        launches = fusion.fused_allreduce_rank_major_(
            wire, spec=spec, backend=backend, op=op)
    else:
        launches = fusion.fused_("allreduce", wire, spec=spec,
                                 backend=backend, op=op)
    _obs_gradsync(launches, op, compress)
    if compress == "bf16":
        for g, w in zip(grads, wire):
            g.copy_(w)
    if _numeric_guard() and grads:
        _guarded(grads, rank_major)
    return None


def synchronize_gradients(params: Params, *, op: Optional[str] = None,
                          backend: Optional[str] = None,
                          compress: Optional[str] = None,
                          n_buckets: Optional[int] = None,
                          barrier: Optional[bool] = None, residuals=None,
                          dcn_compress: Optional[str] = None):
    """Allreduce the ``.grad`` of every parameter across the world, in
    place (reference: ``mpinn.synchronizeGradients``).

    ``op`` defaults to mean when ``Config.gradsync_average`` (the reference
    summed, then divided by ``mpi.size()``).  With ``n_buckets`` <= 1
    (default ``Config.gradsync_buckets``) the gradients ride the fused
    collectives (``Config.fuse_max_bytes``): dtype-grouped buckets, one
    allreduce each; a larger ``n_buckets`` cuts about that many buckets,
    spread over the dtype groups by byte share, each reduced in its own
    dtype (JAX :204-240).  Parameters without a gradient are skipped.

    ``barrier`` (default ``Config.gradsync_barrier``) is accepted: the JAX
    package chains its buckets through optimization barriers so that XLA's
    all-reduce combiner keeps them distinct and issues them in order; here
    each bucket is already its own launch, issued in order, so both values
    give the same bits.

    ``compress="bf16"`` (default ``Config.gradsync_compress``) reduces in
    bfloat16, as the JAX package does (:296-299, :372-382): every gradient
    is cast to bf16, the bf16 copies sync as their own dtype group, and the
    result is cast back into ``.grad`` in the gradient's dtype.

    ``residuals`` (state from :func:`init_dcn_residuals`) takes the
    error-feedback dcn path (JAX :243-360): one ``FusedSpec(n_buckets=)``
    bucket at a time, reduce-scatter over ici, the shard plus its residual
    quantized by ``dcn_compress`` (default ``Config.dcn_compress``, which
    must not be off) across dcn, all-gather over ici; returns ``(params,
    new_residuals)``.  Its schedule is fixed: an explicit ``backend=``,
    ``compress=`` or ``barrier=True`` raises.  On a flat world it warns
    once, runs the plain sync and returns the residuals unchanged.
    Without ``residuals`` it returns ``params``."""
    new_res = synchronize_gradient_tensors(
        [p.grad for p in _param_list(params) if p.grad is not None],
        op=op, backend=backend, compress=compress, n_buckets=n_buckets,
        barrier=barrier, residuals=residuals, dcn_compress=dcn_compress)
    return params if residuals is None else (params, new_res)


def synchronize_gradient_tensors(grads: Sequence[torch.Tensor], *,
                                 op: Optional[str] = None,
                                 backend: Optional[str] = None,
                                 compress: Optional[str] = None,
                                 n_buckets: Optional[int] = None,
                                 barrier: Optional[bool] = None,
                                 residuals=None,
                                 dcn_compress: Optional[str] = None):
    """:func:`synchronize_gradients` on the gradient tensors themselves
    (the JAX function's pytree of gradients), in place; with ``residuals``
    returns the new residuals."""
    return _sync_(list(grads), backend=backend, op=op, compress=compress,
                  n_buckets=n_buckets, barrier=barrier, residuals=residuals,
                  dcn_compress=dcn_compress, rank_major=False)


def synchronize_gradients_rank_major(stacks: Sequence[torch.Tensor], *,
                                     op: Optional[str] = None,
                                     backend: Optional[str] = None,
                                     compress: Optional[str] = None,
                                     n_buckets: Optional[int] = None,
                                     barrier: Optional[bool] = None,
                                     residuals=None,
                                     dcn_compress: Optional[str] = None):
    """:func:`synchronize_gradients` for n ranks on one device, in place:
    ``stacks[i][r]`` is rank r's gradient i ([n, ...] each), synced by
    ``fusion.fused_allreduce_rank_major_`` (``backend="pallas"``: one ring
    launch per bucket, one per node on a two-level grid), the same
    defaults, buckets and compression.  With ``residuals`` ([n, shard]
    buffers of :func:`init_dcn_residuals` with ``n``) the error-feedback
    path on the grid of n; returns ``(stacks, new_residuals)``."""
    stacks = list(stacks)
    new_res = _sync_(stacks, backend=backend, op=op, compress=compress,
                     n_buckets=n_buckets, barrier=barrier,
                     residuals=residuals, dcn_compress=dcn_compress,
                     rank_major=True)
    return None if residuals is None else (stacks, new_res)


# ---------------------------------------------------------------------------
# Backprop-overlapped gradient sync (JAX :388-800)
# ---------------------------------------------------------------------------


def overlap_bucket_bytes(n: Optional[int] = None, device=None) -> int:
    """Byte bound of one overlap bucket (JAX :410):
    ``Config.gradsync_overlap_bytes`` when positive, else the tuning
    plan's bound (``tuning.plan_bucket_bytes``): the largest measured
    allreduce size bucket of the grid (a rank-major stack of ``n`` on
    ``device``, else the process world) not above ``fuse_max_bytes`` when
    a plan is active, else ``fuse_max_bytes`` rounded down to a plan
    bucket edge, so every fired bucket keys to a plan entry."""
    cfg = runtime.effective_config()
    if cfg.gradsync_overlap_bytes > 0:
        return int(cfg.gradsync_overlap_bytes)
    from .. import tuning

    return tuning.plan_bucket_bytes("allreduce", selector.grid_of(n, device),
                                    cfg.fuse_max_bytes or 32 * 1024 * 1024)


def assign_overlap_buckets(leaves: Sequence[torch.Tensor],
                           max_bytes: int) -> List[List[int]]:
    """Reverse-parameter-order buckets (JAX :428): walk the leaves LAST to
    FIRST, the order their gradients arrive in the backward, starting a
    new bucket when the byte bound fills or the dtype changes (a bucket
    stays one dtype).  Returns the buckets' leaf indices in FIRING order:
    bucket 0, the deepest layers, launches first."""
    max_bytes = max(1, int(max_bytes))
    buckets: List[List[int]] = []
    acc, cur_dt = 0, None
    for i in range(len(leaves) - 1, -1, -1):
        leaf = leaves[i]
        b = leaf.numel() * leaf.element_size()
        if not buckets or leaf.dtype != cur_dt or acc + b > max_bytes:
            buckets.append([])
            acc, cur_dt = 0, leaf.dtype
        buckets[-1].append(i)
        acc += b
    return buckets


class _Schedule:
    """One backward's bucket bookkeeping: bucket k fires once its last
    gradient arrived and bucket k - 1 fired (JAX's token chain, :738-757),
    so launches keep the firing order whatever order the hooks run in."""

    def __init__(self, firing: Sequence[Sequence[int]],
                 fire: Callable[[int], None]):
        self.bucket_of = {i: k for k, b in enumerate(firing) for i in b}
        self.left = [len(b) for b in firing]
        self.next = 0
        self.fire = fire

    def arrived(self, i: int) -> None:
        self.left[self.bucket_of[i]] -= 1
        while self.next < len(self.left) and self.left[self.next] == 0:
            self.fire(self.next)
            self.next += 1

    def flush(self) -> None:
        """Fire every bucket left (one with a leaf that got no gradient),
        in firing order."""
        while self.next < len(self.left):
            self.fire(self.next)
            self.next += 1


def _backward_with_hooks(loss_fn: Callable, leaves: List[torch.Tensor],
                         batch: Sequence, has_aux: bool, firing,
                         on_grad: Callable[[int, torch.Tensor], None],
                         fire: Callable[[int], None]):
    """``loss_fn(leaves, *batch)`` and its backward with a hook on every
    leaf: ``on_grad(i, grad)`` as leaf i's gradient arrives, then the
    schedule's firing; the buckets left fire after the backward.  Returns
    the detached output (``(loss, aux)`` with ``has_aux``)."""
    sched = _Schedule(firing, fire)

    def hook_for(i):
        def hook(grad):
            on_grad(i, grad)
            sched.arrived(i)
        return hook

    handles = [leaf.register_hook(hook_for(i))
               for i, leaf in enumerate(leaves)]
    try:
        out = loss_fn(leaves, *batch)
        loss = out[0] if has_aux else out
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    sched.flush()
    if has_aux:
        return loss.detach(), out[1]
    return loss.detach()


def _overlap_setup(params_template, op, compress, max_bytes, site, *,
                   n: Optional[int], backend: Optional[str],
                   codec: Optional[str]):
    """``op``, ``compress``, the template, and the schedule: the firing
    buckets, their ``bucket_group``s, and a function that gives each
    bucket's implementation for this call (the plan's,
    ``planner.plan_overlap``, JAX :716-719, looked up per call so that a
    re-registered route is seen; None per bucket with the planner off or
    under error feedback)."""
    op, compress = _resolve(op, compress, site)
    template = list(params_template)
    if not template:
        raise ValueError(f"{site}: empty parameter list")
    if max_bytes is None:
        max_bytes = overlap_bucket_bytes(n, template[0].device)

    def plan():
        return planner.plan_overlap(template, n=n, op=op, backend=backend,
                                    compress=compress, max_bytes=max_bytes,
                                    dcn_codec=codec)

    if not planner.enabled():
        firing = assign_overlap_buckets(template, max_bytes)
        groups = [fusion.bucket_group(template, b) for b in firing]
        return (op, compress, template, firing, groups,
                lambda: [None] * len(firing))
    first = plan()
    return (op, compress, template, first.extra["firing"],
            first.extra["groups"],
            lambda: plan().impls if planner.enabled()
            else [None] * len(first.impls))


def init_overlap_dcn_residuals(params_template: Sequence[torch.Tensor],
                               axis_names=None, *,
                               max_bytes: Optional[int] = None,
                               n: Optional[int] = None,
                               device=None) -> List[torch.Tensor]:
    """Zeroed error-feedback state for :func:`make_overlapped_grad_fn`
    (``residuals=True``) and its rank-major form (JAX :536): one float32
    accumulator per firing-order overlap bucket
    (:func:`assign_overlap_buckets`), shaped as :func:`init_dcn_residuals`
    shapes them."""
    from .. import compress as _codec

    _codec.ef_axes(axis_names)
    template = list(params_template)
    if max_bytes is None:
        max_bytes = overlap_bucket_bytes(n, template[0].device)
    firing = assign_overlap_buckets(template, max_bytes)
    return _codec.init_residuals(
        _codec.expected_shards([sum(template[i].numel() for i in b)
                                for b in firing], runtime.grid(n)[1]),
        n, device=device if device is not None else template[0].device)


def _ef_vag(vag: Callable, codec: Optional[str], template, firing, n,
            site: str) -> Callable:
    """The EF calling convention around ``vag(params, res_list, *batch,
    **kw)``: ``(params, residual_state, *batch) -> (out, (grads,
    new_residuals))``; the state checked against the firing buckets (or
    handed back unchanged where ``codec`` is None, the flat world)."""
    from .. import compress as _codec

    want = _codec.expected_shards([sum(template[i].numel() for i in b)
                                   for b in firing], runtime.grid(n)[1])

    def wrapped(params, residual_state, *batch, **kw):
        if codec is None:
            out, grads = vag(params, None, *batch, **kw)
            return out, (grads, residual_state)
        res_list = _codec.check_residuals(
            residual_state, want, site=site, n=n,
            layout="the overlap bucket layout",
            init_hint="gradsync.init_overlap_dcn_residuals(template, "
                      "...) using the SAME template/max_bytes")
        new_res = list(res_list)
        out, grads = vag(params, new_res, *batch, **kw)
        return out, (grads, new_res)

    return wrapped


def _obs_overlap(stage: str, bucket: int, total: int) -> None:
    """With obs on, one overlap schedule event (JAX :481-497): ``grads``
    as bucket ``bucket``'s last gradient arrived, ``launch`` as its
    allreduce is issued.  Their interleaving in the flight ring is the
    overlap invariant: bucket k's launch before bucket k + 1's grads."""
    if runtime.effective_config().obs == "off":
        return
    from .. import obs

    obs.record_overlap(stage, bucket, total)


def _observed_step(step: Callable) -> Callable:
    """With obs on at build, one ``tm_step_builds_total`` and ``step``
    wrapped to append a ``step`` flight event before each call, the
    window edge ``tool attribute`` budgets against (JAX :915-927).  With
    obs off, ``step`` itself."""
    if runtime.effective_config().obs == "off":
        return step
    from .. import obs

    obs.record_step_build("data_parallel_step")
    counter = [0]

    def observed_step(*batch):
        obs.record_step("data_parallel_step", counter[0])
        counter[0] += 1
        return step(*batch)

    return observed_step


def _check_params(params, template, site) -> List[torch.Tensor]:
    params = list(params)
    if len(params) != len(template):
        raise ValueError(f"{site}: {len(params)} parameters, the template "
                         f"had {len(template)}")
    return params


def make_overlapped_grad_fn(loss_fn: Callable,
                            params_template: Sequence[torch.Tensor],
                            axis_names=None, *, op: Optional[str] = None,
                            backend: Optional[str] = None,
                            compress: Optional[str] = None,
                            has_aux: bool = False,
                            max_bytes: Optional[int] = None,
                            residuals: bool = False,
                            dcn_compress: Optional[str] = None) -> Callable:
    """A ``value_and_grad`` whose gradients come back ALREADY allreduced
    across the world, each bucket's allreduce launched from the backward
    as its gradients arrive (JAX :616; the reference's async per-layer
    hooks, DDP's overlap)::

        vag = gradsync.make_overlapped_grad_fn(loss_fn, params)
        loss, grads = vag(params, *batch)     # grads are synced

    ``vag(params, *batch)`` takes gradients of ``loss_fn(leaves, *batch)``
    with respect to detached leaves of ``params`` by ``torch.autograd.grad``
    (``has_aux``: ``loss_fn`` returns ``(loss, aux)`` and ``vag``
    ``((loss, aux), grads)``, as ``jax.value_and_grad``).  A tensor hook on
    every leaf copies its gradient contiguous; once a bucket's last one is
    in and the bucket before it fired, the bucket is gathered flat and its
    allreduce issued as ``torch.distributed`` ``async_op=True`` work
    (``collectives.async_in_axis``), so NCCL runs it while the rest of the
    backward computes.  Buckets are :func:`assign_overlap_buckets`' of
    ``params_template``, bounded by ``max_bytes`` (default
    :func:`overlap_bucket_bytes`).  A leaf that gets no gradient counts as
    zeros; its bucket fires after the backward.  ``op`` / ``compress``
    default as :func:`synchronize_gradients`, whose results these equal
    elementwise: bitwise where the sum over ranks does not depend on the
    bucket layout (gloo with 2 ranks).

    ``residuals=True`` (JAX :680-800) makes each bucket's sync the
    error-feedback two-level allreduce (``compress.ef_bucket_allreduce``,
    run as the bucket fires) and ``vag(params, residual_state, *batch) ->
    (out, (grads, new_residuals))``, the state from
    :func:`init_overlap_dcn_residuals`; an explicit ``backend=`` /
    ``compress=`` raises.  On a flat world it warns once and runs the plain
    schedule, the residuals handed back unchanged."""
    collectives._world_axes("make_overlapped_grad_fn", axis_names)
    site = "make_overlapped_grad_fn"
    codec = (_ef_route(True, dcn_compress, site=site, backend=backend,
                       compress=compress, barrier=None, n=None)
             if residuals else None)
    op, compress, template, firing, groups, impls_now = _overlap_setup(
        params_template, op, None if residuals else compress, max_bytes,
        site, n=None, backend=backend, codec=codec)

    def vag(params, res_list, *batch):
        params = _check_params(params, template, site)
        impls = impls_now()
        guard_on = _numeric_guard()
        leaves = [p.detach().requires_grad_() for p in params]
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        pending = []

        def on_grad(i, grad):
            grads[i] = grad.contiguous()

        def fire(k):
            for i in firing[k]:
                if grads[i] is None:
                    grads[i] = torch.zeros_like(
                        leaves[i], memory_format=torch.contiguous_format)
            _obs_overlap("grads", k, len(firing))
            g = groups[k]
            flat = fusion.gather_bucket(grads, g, 0, g.total)
            _obs_overlap("launch", k, len(firing))
            if codec is not None:
                from .. import compress as _codec

                old = res_list[k]
                red, res_list[k] = _codec.ef_bucket_allreduce(
                    flat, codec, old, op=op,
                    min_bytes=runtime.effective_config()
                    .dcn_compress_min_bytes)
                if guard_on:
                    # The bucket's verdict reverts its residual too
                    # (JAX :535-545).
                    from .. import guard

                    red, (res_list[k],) = guard.check_flat(
                        red.to(flat.dtype), site="overlap", bucket=k,
                        aux=[(res_list[k], old)])
                pending.append((g, flat.dtype, red))
                return
            wire = flat.to(torch.bfloat16) if compress == "bf16" else flat
            pending.append((g, flat.dtype, collectives._async_world(
                "allreduce", wire, backend=backend, impl=impls[k], op=op)))

        _obs_gradsync(len(firing), op,
                      f"dcn-{codec}" if codec else compress)
        out = _backward_with_hooks(loss_fn, leaves, batch, has_aux, firing,
                                   on_grad, fire)
        synced: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for k, (g, dtype, got) in enumerate(pending):
            red = (got if isinstance(got, torch.Tensor)
                   else got.wait()).to(dtype)
            if guard_on and codec is None:
                from .. import guard

                red = guard.check_flat(red, site="overlap", bucket=k)
            off = 0
            for i, shape, size in zip(g.indices, g.shapes, g.sizes):
                synced[i] = red[off:off + size].view(shape)
                off += size
        return out, synced

    if residuals:
        return _ef_vag(vag, codec, template, firing, None, site)
    return lambda params, *batch: vag(params, None, *batch)


def make_overlapped_grad_fn_rank_major(loss_fn: Callable,
                                       params_template: Sequence[
                                           torch.Tensor],
                                       n: int, *, op: Optional[str] = None,
                                       backend: Optional[str] = None,
                                       compress: Optional[str] = None,
                                       has_aux: bool = False,
                                       max_bytes: Optional[int] = None,
                                       residuals: bool = False,
                                       dcn_compress: Optional[str] = None
                                       ) -> Callable:
    """:func:`make_overlapped_grad_fn` for ``n`` ranks on one device.

    ``vag(params, *batch, stacks=None) -> (outs, stacks)``: each batch
    tensor's leading axis splits in n, rank r runs ``loss_fn(leaves,
    *slice_r)`` from the same ``params``, and ``stacks[i]`` [n, *shape]
    (zeros made here unless given, e.g. ``fusion.rank_major_buffers``'
    views) ends with every rank's slice the synced gradient i; ``outs`` is
    the ranks' detached outputs (``(loss, aux)`` with ``has_aux``).

    Ranks 0 .. n-2 only fill their slice.  During rank n-1's backward a
    tensor hook copies each gradient into its slice, and each bucket whose
    last gradient arrived (in firing order) is gathered [n, bucket]
    (``fusion.gather_bucket``), reduced by the selector's rank-major
    allreduce (``backend="pallas"``: a ring kernel, which launches on the
    current stream) and scattered back, all on a side stream
    (``collectives.side_stream``) ordered after the compute stream, so the
    sync runs under the rest of the backward.  Every stack the side
    stream touches is recorded on it (``record_stream``), and the compute
    stream waits for the side stream before this returns: no host
    synchronization anywhere.  On CPU tensors the buckets run inline.  The
    stock route is bitwise equal to :func:`synchronize_gradients_rank_major`
    (the rank-axis left fold is elementwise); the ring folds an element in
    an order set by its ring chunk, so under ``"pallas"`` it is bitwise
    equal to the plain ring on these buckets.

    ``residuals=True``: each bucket runs
    ``compress.ef_bucket_allreduce_rank_major`` on the grid of n, and
    ``vag(params, residual_state, *batch, stacks=None) -> (outs, (stacks,
    new_residuals))`` with [n, shard] state from
    :func:`init_overlap_dcn_residuals` (``n=n``); flat grids as in
    :func:`make_overlapped_grad_fn`."""
    site = "make_overlapped_grad_fn_rank_major"
    codec = (_ef_route(True, dcn_compress, site=site, backend=backend,
                       compress=compress, barrier=None, n=n)
             if residuals else None)
    op, compress, template, firing, groups, impls_now = _overlap_setup(
        params_template, op, None if residuals else compress, max_bytes,
        site, n=n, backend=backend, codec=codec)

    def vag(params, res_list, *batch,
            stacks: Optional[List[torch.Tensor]] = None):
        params = _check_params(params, template, site)
        impls = impls_now()
        guard_on = _numeric_guard()
        if stacks is None:
            stacks = [p.new_zeros((n, *p.shape)) for p in params]
        parts = [b.reshape(n, -1, *b.shape[1:]) for b in batch]
        outs = []
        for r in range(n - 1):
            leaves = [p.detach().requires_grad_() for p in params]
            out = loss_fn(leaves, *(b[r] for b in parts))
            loss = out[0] if has_aux else out
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for st, g in zip(stacks, grads):
                st[r].zero_() if g is None else st[r].copy_(g)
            del grads
            outs.append((loss.detach(), out[1]) if has_aux
                        else loss.detach())
        dev = stacks[0].device
        side = collectives.side_stream(dev) if dev.type == "cuda" else None
        got = [False] * len(params)

        def on_grad(i, grad):
            stacks[i][n - 1].copy_(grad)
            got[i] = True

        def reduce_bucket(k, g):
            buf = fusion.gather_bucket(stacks, g, 0, g.total,
                                       rank_major=True)
            aux = None
            if codec is not None:
                from .. import compress as _codec

                old = res_list[k]
                red, res_list[k] = _codec.ef_bucket_allreduce_rank_major(
                    buf, codec, old, op=op,
                    min_bytes=runtime.effective_config()
                    .dcn_compress_min_bytes)
                aux = [(res_list[k], old)]
            else:
                wire = buf.to(torch.bfloat16) if compress == "bf16" else buf
                red = fusion.run_bucket("allreduce_rank_major", wire,
                                        {"op": op}, impl=impls[k],
                                        backend=backend)
            red = red.to(buf.dtype)
            if guard_on:
                # Each rank's copy of the bucket checked on its own row
                # (JAX :535-545), on this stream.
                from .. import guard

                got_ = guard.check_flat(red, site="overlap", bucket=k,
                                        rows=True, aux=aux)
                if aux is not None:
                    red, (res_list[k],) = got_
                else:
                    red = got_
            if codec is not None and side is not None:
                res_list[k].record_stream(side)
            fusion.scatter_bucket(red, stacks, g, 0, rank_major=True)

        def fire(k):
            g = groups[k]
            for i in g.indices:
                if not got[i]:
                    stacks[i][n - 1].zero_()
            _obs_overlap("grads", k, len(firing))
            _obs_overlap("launch", k, len(firing))
            if side is None:
                reduce_bucket(k, g)
                return
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                reduce_bucket(k, g)
            for i in g.indices:
                stacks[i].record_stream(side)

        leaves = [p.detach().requires_grad_() for p in params]
        _obs_gradsync(len(firing), op,
                      f"dcn-{codec}" if codec else compress)
        outs.append(_backward_with_hooks(
            loss_fn, leaves, tuple(b[n - 1] for b in parts), has_aux,
            firing, on_grad, fire))
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        return outs, stacks

    if residuals:
        return _ef_vag(vag, codec, template, firing, n, site)

    def plain(params, *batch, stacks: Optional[List[torch.Tensor]] = None):
        return vag(params, None, *batch, stacks=stacks)

    return plain


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


def _guard_boundary() -> None:
    """The numeric guard's step boundary: ``guard.raise_pending`` (the
    ``raise`` policy's deferred error; under ``skip_step`` nothing is
    read, no host sync).  One string compare while the guard is off."""
    if _numeric_guard():
        from .. import guard

        guard.raise_pending()


def analysis_checked(step: Callable, label: str,
                     sources: Sequence[Callable]) -> Callable:
    """``step`` under ``Config.analysis`` (JAX :903-912): with "warn" or
    "error" at build time, each new batch signature's first call is
    checked (``analysis.wrap_step``: the static pass over ``sources``,
    then the call under the recorder); "off" (the default) returns
    ``step`` itself and never imports the analysis."""
    mode = runtime.effective_config().analysis
    if mode == "off":
        return step
    from .. import analysis

    return analysis.wrap_step(step, label=label, mode=mode,
                              sources=[step, *sources])


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
    from the same weights.  Under ``Config.analysis`` each new batch
    signature is checked once (:func:`analysis_checked`)."""
    if sync_parameters:
        synchronize_parameters(model)

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        synchronize_gradients(model)
        optimizer.step()
        _guard_boundary()
        return collectives.allreduce_in_axis(loss.detach(), op="mean")

    return _observed_step(analysis_checked(step, "data_parallel_step",
                                           [loss_fn]))


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
    returns the mean of the ranks' losses, detached.  Under
    ``Config.analysis`` each new batch signature is checked once
    (:func:`analysis_checked`)."""
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
        _guard_boundary()
        return torch.stack(losses).mean()

    return _observed_step(analysis_checked(
        step, "data_parallel_step_rank_major", [loss_fn]))
