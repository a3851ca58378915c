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
:func:`make_overlapped_grad_fn_rank_major`).  The error-feedback DCN leg
(``residuals`` / ``dcn_compress``) waits for the two-level collectives
(ROADMAP queue A, item 4) and raises by that name.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from .. import collectives, fusion, runtime, selector
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


def _refuse_ef(residuals, dcn_compress, site: str) -> None:
    if residuals or dcn_compress is not None:
        raise NotImplementedError(
            f"{site}: residuals / dcn_compress, the error-feedback DCN leg, "
            "waits for the two-level collectives (ROADMAP queue A, item 4)")


def _resolve(op: Optional[str], compress: Optional[str], site: str):
    """``op`` and ``compress`` with the Config's defaults (mean when
    ``gradsync_average``; ``gradsync_compress``)."""
    cfg = runtime.effective_config()
    if op is None:
        op = "mean" if cfg.gradsync_average else "sum"
    if compress is None:
        compress = cfg.gradsync_compress
    return op, wire_compress(compress, site=site)


def _sync_(grads: List[torch.Tensor], fused_allreduce_: Callable, *,
           op: Optional[str], compress: Optional[str],
           n_buckets: Optional[int], barrier: Optional[bool], residuals,
           dcn_compress, rank_major: bool) -> None:
    """``fused_allreduce_(tensors, op, spec)`` on ``grads`` in place, with
    the Config's defaults for ``op``, ``compress`` and ``n_buckets``:
    ``n_buckets`` <= 1 rides the fused buckets (``fuse_max_bytes``), more
    the count-driven ``FusedSpec(n_buckets=)`` (JAX :204-240, :294)."""
    _refuse_ef(residuals, dcn_compress, "synchronize_gradients")
    op, compress = _resolve(op, compress, "synchronize_gradients")
    if n_buckets is None:
        n_buckets = runtime.effective_config().gradsync_buckets
    wire = ([g.to(torch.bfloat16) for g in grads] if compress == "bf16"
            else grads)
    spec = None
    if n_buckets > 1 and wire:
        spec = fusion.FusedSpec([t[0] for t in wire] if rank_major else wire,
                                n_buckets=n_buckets)
    fused_allreduce_(wire, op, spec)
    if compress == "bf16":
        for g, w in zip(grads, wire):
            g.copy_(w)


def synchronize_gradients(params: Params, *, op: Optional[str] = None,
                          backend: Optional[str] = None,
                          compress: Optional[str] = None,
                          n_buckets: Optional[int] = None,
                          barrier: Optional[bool] = None, residuals=None,
                          dcn_compress: Optional[str] = None) -> Params:
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
    ``residuals`` / ``dcn_compress`` raise (ROADMAP queue A, item 4)."""
    synchronize_gradient_tensors(
        [p.grad for p in _param_list(params) if p.grad is not None],
        op=op, backend=backend, compress=compress, n_buckets=n_buckets,
        barrier=barrier, residuals=residuals, dcn_compress=dcn_compress)
    return params


def synchronize_gradient_tensors(grads: Sequence[torch.Tensor], *,
                                 op: Optional[str] = None,
                                 backend: Optional[str] = None,
                                 compress: Optional[str] = None,
                                 n_buckets: Optional[int] = None,
                                 barrier: Optional[bool] = None,
                                 residuals=None,
                                 dcn_compress: Optional[str] = None) -> None:
    """:func:`synchronize_gradients` on the gradient tensors themselves
    (the JAX function's pytree of gradients), in place."""
    _sync_(list(grads), lambda ts, op, spec: fusion.fused_(
        "allreduce", ts, spec=spec, backend=backend, op=op), op=op,
        compress=compress, n_buckets=n_buckets, barrier=barrier,
        residuals=residuals, dcn_compress=dcn_compress, rank_major=False)


def synchronize_gradients_rank_major(stacks: Sequence[torch.Tensor], *,
                                     op: Optional[str] = None,
                                     backend: Optional[str] = None,
                                     compress: Optional[str] = None,
                                     n_buckets: Optional[int] = None,
                                     barrier: Optional[bool] = None,
                                     residuals=None,
                                     dcn_compress: Optional[str] = None
                                     ) -> None:
    """:func:`synchronize_gradients` for n ranks on one device, in place:
    ``stacks[i][r]`` is rank r's gradient i ([n, ...] each), synced by
    ``fusion.fused_allreduce_rank_major_`` (``backend="pallas"``: one ring
    launch per bucket), the same defaults, buckets and compression."""
    _sync_(list(stacks), lambda ts, op, spec:
           fusion.fused_allreduce_rank_major_(ts, spec=spec, backend=backend,
                                              op=op), op=op,
           compress=compress, n_buckets=n_buckets, barrier=barrier,
           residuals=residuals, dcn_compress=dcn_compress, rank_major=True)


# ---------------------------------------------------------------------------
# Backprop-overlapped gradient sync (JAX :388-800)
# ---------------------------------------------------------------------------


def _plan_bucket_edge(nbytes: int) -> int:
    """``nbytes`` rounded down to a power of two: the tuning plan's log2
    size bucket edge (the JAX package's ``tuning/fingerprint.py`` :23-30,
    ``size_bucket`` then ``bucket_bytes``)."""
    return 1 << max(0, max(1, int(nbytes)).bit_length() - 1)


def overlap_bucket_bytes() -> int:
    """Byte bound of one overlap bucket: ``Config.gradsync_overlap_bytes``
    when positive, else ``fuse_max_bytes`` rounded down to a power of two
    (JAX :410 with no tuning plan active, ``tuning/autoselect.py``
    :310-328; the plan-sized bound waits for the tuning plans, ROADMAP
    queue A, item 5)."""
    cfg = runtime.effective_config()
    if cfg.gradsync_overlap_bytes > 0:
        return int(cfg.gradsync_overlap_bytes)
    return _plan_bucket_edge(cfg.fuse_max_bytes or 32 * 1024 * 1024)


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


def _overlap_setup(params_template, op, compress, max_bytes, residuals,
                   dcn_compress, site):
    _refuse_ef(residuals, dcn_compress, site)
    op, compress = _resolve(op, compress, site)
    template = list(params_template)
    if not template:
        raise ValueError(f"{site}: empty parameter list")
    if max_bytes is None:
        max_bytes = overlap_bucket_bytes()
    firing = assign_overlap_buckets(template, max_bytes)
    groups = [fusion.bucket_group(template, b) for b in firing]
    return op, compress, template, firing, groups


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
    bucket layout (gloo with 2 ranks).  ``residuals`` / ``dcn_compress``
    raise (ROADMAP queue A, item 4)."""
    collectives._world_axes("make_overlapped_grad_fn", axis_names)
    op, compress, template, firing, groups = _overlap_setup(
        params_template, op, compress, max_bytes, residuals, dcn_compress,
        "make_overlapped_grad_fn")

    def vag(params, *batch):
        params = _check_params(params, template, "make_overlapped_grad_fn")
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
            g = groups[k]
            flat = fusion.gather_bucket(grads, g, 0, g.total)
            wire = flat.to(torch.bfloat16) if compress == "bf16" else flat
            pending.append((g, flat.dtype, collectives.async_in_axis
                            .allreduce(wire, op=op, backend=backend)))

        out = _backward_with_hooks(loss_fn, leaves, batch, has_aux, firing,
                                   on_grad, fire)
        synced: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for g, dtype, handle in pending:
            red = handle.wait().to(dtype)
            off = 0
            for i, shape, size in zip(g.indices, g.shapes, g.sizes):
                synced[i] = red[off:off + size].view(shape)
                off += size
        return out, synced

    return vag


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
    equal to the plain ring on these buckets."""
    op, compress, template, firing, groups = _overlap_setup(
        params_template, op, compress, max_bytes, residuals, dcn_compress,
        "make_overlapped_grad_fn_rank_major")

    def vag(params, *batch, stacks: Optional[List[torch.Tensor]] = None):
        params = _check_params(params, template,
                               "make_overlapped_grad_fn_rank_major")
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

        def reduce_bucket(g):
            buf = fusion.gather_bucket(stacks, g, 0, g.total,
                                       rank_major=True)
            wire = buf.to(torch.bfloat16) if compress == "bf16" else buf
            impl = selector.select("allreduce_rank_major", backend,
                                   nbytes=g.total * wire.element_size())
            red = impl(wire, op=op).to(buf.dtype)
            fusion.scatter_bucket(red, stacks, g, 0, rank_major=True)

        def fire(k):
            g = groups[k]
            for i in g.indices:
                if not got[i]:
                    stacks[i][n - 1].zero_()
            if side is None:
                reduce_bucket(g)
                return
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                reduce_bucket(g)
            for i in g.indices:
                stacks[i].record_stream(side)

        leaves = [p.detach().requires_grad_() for p in params]
        outs.append(_backward_with_hooks(
            loss_fn, leaves, tuple(b[n - 1] for b in parts), has_aux,
            firing, on_grad, fire))
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        return outs, stacks

    return vag


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
