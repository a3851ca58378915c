"""Two-level collectives: ici (intra-node) and dcn (inter-node).

The PyTorch counterpart of ``torchmpi_tpu/parallel/hierarchical.py``, the
reference's hierarchical algorithms (intra-node reduce, inter-node
allreduce, intra-node broadcast, chunk-pipelined).  The allreduce runs

    reduce-scatter over ici  ->  allreduce over dcn (1 / n_ici of the data)
    ->  all-gather over ici

so each rank sends only ``1 / n_ici`` of the tensor over the slow dcn
links.  It is chunk-pipelined (``Config.dcn_chunk_bytes``): when a rank's
ici-scattered shard exceeds the bound, the tensor splits into up to
``_MAX_CHUNKS`` chunks, and across processes chunk i's dcn leg is issued
asynchronously on the dcn group while chunk i + 1's ici reduce-scatter
runs.  The reduction is elementwise and every element is folded in the
same order, so the result is bitwise the same chunked or not.  The dcn leg
can run on a quantized wire (``Config.dcn_compress``, ``compress.py``);
with "off" the codec module is never imported.  ``max`` / ``min`` nest the
two reductions.

The other verbs move their data over the subgroups, node leaders first
(the rank that shares the root's ici index): ``hier_broadcast`` over dcn
among the leaders, then over ici; ``hier_reduce`` over ici to the leaders,
then over dcn to the root; ``hier_allgather`` over ici, then dcn;
``hier_gather`` over ici to the leaders, then over dcn to the root (each
tensor crosses dcn at most once); ``hier_scatter`` over dcn from the root
to the leaders (each node its block), then over ici.  JAX builds the last
two from ``collectives._chain_gather`` / ``_chain_scatter``.

Each verb has two forms: across processes (``hier_<verb>(x, ...)``, this
rank's tensor, on ``runtime.group("ici")`` / ``runtime.group("dcn")``), and
rank-major (the n ranks' tensors stacked on one device in global rank
order ``d * n_ici + i`` on ``n_dcn`` nodes, which the selector passes).
On one device the data movement has no levels, so the rank-major
broadcast, allgather, gather and scatter are the stock closed forms
(``collectives.py`` registers them); ``hier_allreduce_rank_major`` and
``hier_reduce_rank_major`` are here, since their fold order and mean
differ from the stock ones.  Each leg runs inside a
``torch.profiler.record_function`` range (``hier/ici_reduce_scatter``,
``hier/dcn_allreduce``, ``hier/ici_all_gather``), so a profile attributes
the device time by leg.
The verbs register with the selector as backend ``"hierarchical"``; on a
flat world the selector falls back to ``"xla"`` with a warning.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import collectives, fusion, runtime, selector

# Chunk-count ceiling of the pipelined allreduce (JAX :58): past a handful
# of chunks in flight the overlap is saturated.
_MAX_CHUNKS = 16
_OPS = ("sum", "mean", "max", "min")


def _dcn_codec(x: torch.Tensor, op: str, n_ici: int) -> Optional[str]:
    """The dcn wire codec of this allreduce (JAX :73-126):
    ``Config.dcn_compress`` when the payload is floating point, the op is a
    sum or mean, and the dcn leg (the ici-scattered shard, ``1 / n_ici`` of
    the tensor) clears ``dcn_compress_min_bytes``.  "off" is one string
    compare and never imports the codec module."""
    cfg = runtime.effective_config()
    if cfg.dcn_compress == "off":
        return None
    nbytes = x.numel() * x.element_size()
    shard_nbytes = -(-nbytes // max(1, n_ici))
    if op not in ("sum", "mean") or not x.is_floating_point():
        # Quantizing a max / min (or an integer sum) would change what it
        # computes: the leg runs uncompressed, with the C2 evidence under
        # an analysis check (JAX :96-114): the bytes of the leg that
        # crosses dcn (the whole tensor for max / min).
        if fusion._trace_listener is not None:
            from .. import compress

            compress.note_skipped(
                op, cfg.dcn_compress,
                shard_nbytes if op in ("sum", "mean") else nbytes,
                incompatible=True)
        return None
    if shard_nbytes < cfg.dcn_compress_min_bytes:
        if fusion._trace_listener is not None:
            from .. import compress

            compress.note_skipped(op, cfg.dcn_compress, shard_nbytes)
        return None
    from .. import compress

    return compress.resolve_dcn(cfg)


def chunk_count(nelems: int, itemsize: int, n_ici: int,
                codec: Optional[str] = None) -> int:
    """Chunks of the pipelined allreduce of ``nelems`` elements a rank (JAX
    :160-177): each chunk's ici-scattered shard at most about
    ``dcn_chunk_bytes``, at most ``_MAX_CHUNKS``; with a codec, no more
    than keep every chunk's dcn leg at ``dcn_compress_min_bytes`` or
    above."""
    cfg = runtime.effective_config()
    shard_bytes = (nelems * itemsize) // max(1, n_ici)
    k = 1
    if cfg.dcn_chunk_bytes > 0 and shard_bytes > cfg.dcn_chunk_bytes:
        k = min(_MAX_CHUNKS, -(-shard_bytes // cfg.dcn_chunk_bytes))
    if codec is not None and k > 1 and cfg.dcn_compress_min_bytes > 0:
        k = max(1, min(k, shard_bytes // cfg.dcn_compress_min_bytes))
    return k


def _note_dcn(codec: Optional[str], c: int, itemsize: int) -> None:
    """With obs on, one chunk's dcn leg of ``c`` elements a rank: its
    wire and payload bytes (JAX :191-201); under an analysis check a
    compressed leg's C2 record too (``compress.note_leg``).  An
    uncompressed leg does not import the codec module."""
    obs_on = runtime.effective_config().obs != "off"
    if codec is not None and (obs_on or fusion._trace_listener is not None):
        from .. import compress

        compress.note_leg("allreduce", codec, c * itemsize,
                          compress.wire_nbytes_of(c, codec))
    elif codec is None and obs_on:
        from .. import obs

        obs.record_dcn("allreduce", "none", c * itemsize, c * itemsize)


def _check_op(op: str) -> None:
    if op not in _OPS:
        raise KeyError(f"hierarchical allreduce does not support op {op!r}")


def _padded(flat: torch.Tensor, total: int) -> torch.Tensor:
    """``flat`` [..., L] zero-padded on the right to [..., total]."""
    if flat.shape[-1] == total:
        return flat
    out = flat.new_zeros(*flat.shape[:-1], total)
    out[..., :flat.shape[-1]] = flat
    return out


def _fold(xs: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` of ``xs`` in its dtype, a left fold in index
    order (the stock route's order, ``collectives._fold_ranks``)."""
    return collectives._fold_ranks(xs.movedim(dim, 0))


def _extreme(xs: torch.Tensor, dim: int, op: str) -> torch.Tensor:
    return xs.amax(dim) if op == "max" else xs.amin(dim)


# ---------------------------------------------------------------------------
# Rank-major: the n ranks' tensors stacked on one device
# ---------------------------------------------------------------------------


def hier_allreduce_rank_major(xs: torch.Tensor, *, op: str = "sum",
                              n_dcn: int) -> torch.Tensor:
    """Every slice the sum (or mean, max, min) over the n ranks of ``xs``
    [n, ...] on ``n_dcn`` nodes: per chunk, each node's ici ranks folded
    into their shards (the reduce-scatter), the shards folded over dcn (or
    the codec's decoded sum), the result copied to every rank (the
    all-gather)."""
    _check_op(op)
    n = xs.shape[0]
    n_ici = n // n_dcn
    # Before the max / min branch: its codec choice (none) leaves the C2
    # evidence under an analysis check (JAX :96-114).
    codec = _dcn_codec(xs[0], op, n_ici)
    if op in ("max", "min"):
        v = xs.reshape(n_dcn, n_ici, *xs.shape[1:])
        red = _extreme(_extreme(v, 1, op), 0, op)
        return red.expand(xs.shape).clone()
    flat = xs.reshape(n, -1)
    L = flat.shape[1]
    k = chunk_count(L, xs.element_size(), n_ici, codec)
    P = -(-L // (n_ici * k)) * (n_ici * k)
    c = P // (n_ici * k)
    x = _padded(flat, P).reshape(n_dcn, n_ici, k, n_ici, c)
    out = xs.new_empty(n, P)
    for j in range(k):
        with record_function("hier/ici_reduce_scatter"):
            shards = _fold(x[:, :, j], 1)          # [n_dcn, tile, c]
        with record_function("hier/dcn_allreduce"):
            _note_dcn(codec, c, xs.element_size())
            if codec is not None:
                from .. import compress

                tot, _ = compress.dcn_allreduce_rank_major(shards, codec)
            else:
                tot = _fold(shards, 0)             # [tile, c]
        with record_function("hier/ici_all_gather"):
            out[:, j * n_ici * c:(j + 1) * n_ici * c] = tot.reshape(1, -1)
    out = out[:, :L].reshape(xs.shape)
    return out / n if op == "mean" else out


def hier_reduce_rank_major(xs: torch.Tensor, *, root: int = 0,
                           op: str = "sum", n_dcn: int) -> torch.Tensor:
    """Slice ``root`` the reduction over the ranks on ``n_dcn`` nodes,
    inner (ici) first then outer (dcn); a mean is the mean over ici, then
    over dcn (JAX :228); the other slices unchanged (float32 for an
    integer mean)."""
    _check_op(op)
    n_ici = xs.shape[0] // n_dcn
    v = xs.reshape(n_dcn, n_ici, *xs.shape[1:])
    if op in ("max", "min"):
        total = _extreme(_extreme(v, 1, op), 0, op)
    else:
        inner = _fold(v, 1)
        if op == "mean":
            inner = inner / n_ici
        total = _fold(inner, 0)
        if op == "mean":
            total = total / n_dcn
    out = xs.to(total.dtype, copy=True)
    out[root] = total
    return out


# ---------------------------------------------------------------------------
# Across processes: this rank's tensor, on the ici and dcn subgroups
# ---------------------------------------------------------------------------


def _coords():
    n_dcn, n_ici = runtime.grid()
    return n_dcn, n_ici, runtime.axis_index("dcn"), runtime.axis_index("ici")


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def hier_allreduce(x: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """The sum (or mean, max, min) of every rank's ``x``: per chunk, the
    reduce-scatter over this node's ici group, the shard's allreduce over
    the dcn group (issued asynchronously, waited for after the next
    chunk's reduce-scatter), the all-gather over ici."""
    _check_op(op)
    gi, gd = runtime.group("ici"), runtime.group("dcn")
    n_dcn, n_ici = runtime.grid()
    codec = _dcn_codec(x, op, n_ici)
    if op in ("max", "min"):
        buf = x.clone()
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=gi)
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=gd)
        return buf
    flat = x.reshape(-1)
    L = flat.shape[0]
    k = chunk_count(L, x.element_size(), n_ici, codec)
    P = -(-L // (n_ici * k)) * (n_ici * k)
    c = P // (n_ici * k)
    chunks = _padded(flat, P).reshape(k, n_ici * c)
    out = x.new_empty(P)
    pending = None

    def finish(j, shard, work):
        if work is not None:
            work.wait()
        with record_function("hier/ici_all_gather"):
            collectives._all_gather_single(
                out[j * n_ici * c:(j + 1) * n_ici * c], shard, group=gi)

    for j in range(k):
        shard = x.new_empty(c)
        with record_function("hier/ici_reduce_scatter"):
            collectives._reduce_scatter_single(shard, chunks[j].contiguous(),
                                               group=gi)
        if pending is not None:
            finish(*pending)
        with record_function("hier/dcn_allreduce"):
            _note_dcn(codec, c, x.element_size())
            if codec is not None:
                from .. import compress

                shard, _ = compress.dcn_allreduce(shard, codec, group=gd)
                work = None
            else:
                work = dist.all_reduce(shard, group=gd, async_op=True)
        pending = (j, shard, work)
    finish(*pending)
    out = out[:L].reshape(x.shape)
    return out / (n_dcn * n_ici) if op == "mean" else out


def hier_broadcast(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank: over dcn among the ranks that
    share the root's ici index, then over each node's ici group."""
    _, n_ici, d, i = _coords()
    buf = x.clone()
    if i == root % n_ici:
        dist.broadcast(buf, src=root, group=runtime.group("dcn"))
    dist.broadcast(buf, src=d * n_ici + root % n_ici,
                   group=runtime.group("ici"))
    return buf


def hier_reduce(x: torch.Tensor, *, root: int = 0,
                op: str = "sum") -> torch.Tensor:
    """Rank ``root`` gets the reduction of every rank's ``x`` (over ici to
    the node leaders, then over dcn; a mean over ici, then over dcn); the
    other ranks keep their own (float32 for an integer mean)."""
    _check_op(op)
    n_dcn, n_ici, d, i = _coords()
    ri = root % n_ici
    buf = x.clone() if op != "mean" or x.is_floating_point() else x.float()
    dist.reduce(buf, dst=d * n_ici + ri, op=_REDUCE_OPS[op],
                group=runtime.group("ici"))
    if i == ri:
        if op == "mean":
            buf = buf / n_ici
        dist.reduce(buf, dst=root, op=_REDUCE_OPS[op],
                    group=runtime.group("dcn"))
    if runtime.rank() == root:
        return buf / n_dcn if op == "mean" else buf
    return x.float() if op == "mean" and not x.is_floating_point() \
        else x.clone()


def hier_allgather(x: torch.Tensor) -> torch.Tensor:
    """The stack [n, ...] of every rank's ``x``: the all-gather over ici,
    then of the node stacks over dcn (global rank order, dcn-major)."""
    n_dcn, n_ici = runtime.grid()
    inner = x.new_empty(n_ici * x.numel())
    collectives._all_gather_single(inner, x.contiguous().view(-1),
                                   group=runtime.group("ici"))
    both = x.new_empty(n_dcn * inner.numel())
    collectives._all_gather_single(both, inner, group=runtime.group("dcn"))
    return both.view((n_dcn * n_ici,) + tuple(x.shape))


def hier_gather(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Rank ``root`` gets the stack [n, ...] of every rank's ``x``, the
    others zeros: each node's ici gather to its leader (the rank sharing
    the root's ici index), then the leaders' dcn gather to the root."""
    n_dcn, n_ici, d, i = _coords()
    ri = root % n_ici
    local = collectives._stock_gather(x, root=ri, group=runtime.group("ici"))
    if i != ri:
        return x.new_zeros((n_dcn * n_ici,) + tuple(x.shape))
    both = collectives._stock_gather(local, root=root // n_ici,
                                     group=runtime.group("dcn"))
    return both.reshape((n_dcn * n_ici,) + tuple(x.shape))


def hier_scatter(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Rank i gets tile i of rank ``root``'s ``x`` [k, ...]: the root
    scatters each node its block over dcn to the leaders, each leader its
    block's tiles over ici."""
    n_dcn, n_ici, d, i = _coords()
    n = n_dcn * n_ici
    collectives._check_tiles(x, n, "scatter")
    ri = root % n_ici
    if i == ri:
        block = collectives._stock_scatter(x, root=root // n_ici,
                                           group=runtime.group("dcn"))
    else:
        block = x[:x.shape[0] // n_dcn]   # the shape; the data is unused
    return collectives._stock_scatter(block, root=ri,
                                      group=runtime.group("ici"))


for _verb in ("allreduce", "broadcast", "reduce", "allgather", "gather",
              "scatter"):
    selector.register(_verb, "hierarchical", globals()[f"hier_{_verb}"])
for _verb in ("allreduce", "reduce"):
    selector.register(f"{_verb}_rank_major", "hierarchical",
                      globals()[f"hier_{_verb}_rank_major"])
