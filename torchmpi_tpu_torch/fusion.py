"""Fused collectives over lists of tensors: dtype-grouped buckets.

The PyTorch counterpart of ``torchmpi_tpu/fusion.py``.  Tensors group by
dtype (never promoted, so bf16 stays bf16 on the wire), each group is laid
out flat in tensor order and split into element ranges ("buckets") bounded
by ``Config.fuse_max_bytes``, and ONE collective runs per bucket:
O(dtypes x buckets) launches instead of one per tensor, the coalescing of
PyTorch DDP's gradient buckets.  The bucket bounds are the JAX package's
(``FusedSpec``: ``np.linspace`` over the group), so both packages cut a
parameter list at the same elements.

A bucket is gathered into its own buffer, reduced in place there and
scattered back, so the extra memory is one bucket, not the whole group.
Fusion never changes results: every element sees the same reduction as a
per-tensor launch would give it.

:func:`fused_allreduce_rank_major_` is the same over rank-major stacks
(``stacks[i][r]`` = rank r's tensor i): the buckets are cut from one rank's
tensors and gathered as [n, bucket] for one rank-major allreduce each, what
the JAX package's ``synchronize_gradients`` -> ``fusion.fuse_tree`` does per
bucket on its n-device mesh.

The in-axis verbs take trees (dicts, lists, tuples of tensors; JAX
``collectives._in_axis`` :376-386): :func:`maybe_fuse` runs allreduce,
reduce and broadcast fused over a tree's tensors, and
:func:`maybe_fuse_reduce_scatter` the reduce-scatter in the JAX package's
tile-interleaved layout (:func:`fused_reduce_scatter`); each returns None
where the JAX package goes per tensor.  :func:`fused_reduce_scatter_rank_major`
is the same reduce-scatter over rank-major stacks, the FSDP recipe's
gradient reduce-scatter.

``FusedSpec(tensors, n_shards)`` is also ZeRO's shard layout (the JAX
package's, ``fusion.py`` :169-177): each dtype group is laid out flat and
zero-padded to a multiple of ``n_shards``, shard i of the list is every
group's extent i, promoted to one dtype and concatenated group-major
(:func:`local_shard`), which is exactly what one reduce-scatter per group
in its own dtype hands rank i.  :func:`group_flat`, :func:`flatten_tree`,
:func:`unflatten_tree`, :func:`local_shard` and :func:`unflatten_shards` are
the JAX functions on tensor lists; :func:`local_shards`,
:func:`group_flats` and :func:`rank_major_buffers` are their rank-major
forms.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _tree, runtime, selector


class DtypeGroup:
    """One dtype's slice of a :class:`FusedSpec`: which tensors (positions
    in the input list), their shapes and element counts, the bucket bounds,
    and the shard layout (``padded`` elements, ``shard`` per rank)."""

    __slots__ = ("dtype", "indices", "shapes", "sizes", "total", "bounds",
                 "padded", "shard", "leaf_buckets")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.indices: List[int] = []
        self.shapes: List[torch.Size] = []
        self.sizes: List[int] = []
        self.total = 0
        self.bounds: List[Tuple[int, int]] = []
        self.leaf_buckets: List[List[int]] = []

    @property
    def nbytes(self) -> int:
        return self.total * torch.empty((), dtype=self.dtype).element_size()


def _proportional_buckets(groups: Sequence[DtypeGroup], k: int) -> List[int]:
    """About ``k`` buckets spread over the groups by their byte share, at
    least one each (a one-group list gets exactly ``k``): JAX :121."""
    tot = sum(g.nbytes for g in groups) or 1
    return [max(1, min(max(1, g.total), round(k * g.nbytes / tot)))
            for g in groups]


class FusedSpec:
    """Static fusion layout of a list of tensors (group-major, first-seen
    dtype order, element buckets), and its shard layout over ``n_shards``
    ranks: each group padded to ``padded``, a multiple of ``n_shards``, of
    which each rank owns ``shard``; the promoted view (``dtype``,
    ``padded``, ``shard``) is the groups' concatenation.  The buckets are
    byte-bounded (``max_bytes``, default ``Config.fuse_max_bytes``) or,
    with ``n_buckets``, count-driven: about that many, spread over the
    groups by byte share (``Config.gradsync_buckets``, JAX :146-190)."""

    def __init__(self, tensors: Sequence[torch.Tensor], n_shards: int = 1, *,
                 max_bytes: Optional[int] = None,
                 n_buckets: Optional[int] = None):
        if max_bytes is None:
            max_bytes = runtime.effective_config().fuse_max_bytes
        self.n_tensors = len(tensors)
        self.n_shards = int(n_shards)
        self.dtypes = [t.dtype for t in tensors]
        self.dtype = (functools.reduce(torch.promote_types, self.dtypes)
                      if tensors else torch.float32)
        by_dtype = {}
        self.groups: List[DtypeGroup] = []
        for i, t in enumerate(tensors):
            g = by_dtype.get(t.dtype)
            if g is None:
                g = by_dtype[t.dtype] = DtypeGroup(t.dtype)
                self.groups.append(g)
            g.indices.append(i)
            g.shapes.append(t.shape)
            g.sizes.append(t.numel())
            g.total += t.numel()
        n = self.n_shards
        for g in self.groups:
            g.padded = max(n, -(-g.total // n) * n)
            g.shard = g.padded // n
        self.padded = sum(g.padded for g in self.groups) or n
        self.shard = self.padded // n
        if n_buckets is not None:
            ks = _proportional_buckets(self.groups, max(1, int(n_buckets)))
        elif max_bytes and max_bytes > 0:
            ks = [max(1, min(max(1, g.total), -(-g.nbytes // max_bytes)))
                  for g in self.groups]
        else:
            ks = [1] * len(self.groups)
        for g, k in zip(self.groups, ks):
            edges = np.linspace(0, g.total, k + 1).astype(int)
            g.bounds = [(int(edges[i]), int(edges[i + 1]))
                        for i in range(k) if edges[i] < edges[i + 1]]
            if not g.bounds:
                g.bounds = [(0, g.total)]
        # Whole-tensor buckets for the tile-interleaved reduce-scatter, where
        # a bound inside a tensor would break its tiles: first fit in tensor
        # order against the same byte bound (JAX :191-204).
        limit = max_bytes if max_bytes and max_bytes > 0 else 0
        for g in self.groups:
            itemsize = torch.empty((), dtype=g.dtype).element_size()
            buckets, acc = [[]], 0
            for pos, size in enumerate(g.sizes):
                b = size * itemsize
                if buckets[-1] and limit and acc + b > limit:
                    buckets.append([])
                    acc = 0
                buckets[-1].append(pos)
                acc += b
            g.leaf_buckets = buckets

    @property
    def n_launches(self) -> int:
        """Collectives one fused call issues for this list."""
        return sum(len(g.bounds) for g in self.groups)

    @property
    def n_reduce_scatter_launches(self) -> int:
        """Collectives one fused tile-interleaved reduce-scatter issues."""
        return sum(len(g.leaf_buckets) for g in self.groups)


def bucket_group(tensors: Sequence[torch.Tensor],
                 indices: Sequence[int]) -> DtypeGroup:
    """One bucket of tensors of one dtype (positions ``indices`` in
    ``tensors``, flat in that order) as a one-bucket :class:`DtypeGroup`,
    for :func:`gather_bucket` / :func:`scatter_bucket`: an overlap bucket
    of ``gradsync.assign_overlap_buckets``."""
    g = DtypeGroup(tensors[indices[0]].dtype)
    for i in indices:
        t = tensors[i]
        if t.dtype != g.dtype:
            raise TypeError(f"a bucket mixes {g.dtype} and {t.dtype}")
        g.indices.append(i)
        g.shapes.append(t.shape)
        g.sizes.append(t.numel())
        g.total += t.numel()
    g.bounds = [(0, g.total)]
    return g


def _pieces(g: DtypeGroup, lo: int, hi: int):
    """(position in g, start, stop) of each tensor range inside the group
    element range [lo, hi)."""
    off = 0
    for pos, size in enumerate(g.sizes):
        a, b = max(lo, off), min(hi, off + size)
        if a < b:
            yield pos, a - off, b - off
        off += size
        if off >= hi:
            break


def _flat(t: torch.Tensor, rank_major: bool) -> torch.Tensor:
    return t.view(t.shape[0], -1) if rank_major else t.view(-1)


def gather_bucket(tensors: Sequence[torch.Tensor], g: DtypeGroup, lo: int,
                  hi: int, *, rank_major: bool = False) -> torch.Tensor:
    """The group's elements [lo, hi) as one new flat tensor ([n, hi - lo]
    for rank-major stacks).  A rank-major bucket is a view whose rows start
    16 bytes apart (the row stride rounded up), so that every rank's row is
    as aligned as the allocation and a kernel can read all of them in
    16-byte vectors."""
    parts = [_flat(tensors[g.indices[pos]], rank_major)[..., a:b]
             for pos, a, b in _pieces(g, lo, hi)]
    if not rank_major:
        return torch.cat(parts, -1) if len(parts) > 1 else parts[0].clone()
    n, m = parts[0].shape[0], hi - lo
    per16 = max(1, 16 // parts[0].element_size())
    buf = parts[0].new_empty(n, -(-m // per16) * per16)[:, :m]
    off = 0
    for p in parts:
        buf[:, off:off + p.shape[1]].copy_(p)
        off += p.shape[1]
    return buf


def scatter_bucket(flat: torch.Tensor, tensors: Sequence[torch.Tensor],
                   g: DtypeGroup, lo: int, *,
                   rank_major: bool = False) -> None:
    """Write ``flat`` (the group's elements from ``lo``) back, in place."""
    off = 0
    for pos, a, b in _pieces(g, lo, lo + flat.shape[-1]):
        _flat(tensors[g.indices[pos]], rank_major)[..., a:b].copy_(
            flat[..., off:off + b - a])
        off += b - a


def run_bucket(op: str, buf: torch.Tensor, params: dict, *,
               impl: Optional[Callable] = None,
               backend: Optional[str] = None, axis: Optional[str] = None,
               owned: bool = False):
    """Selector op ``op`` on one bucket, the one runner of every fused
    path and of the planner's measurements: ``buf`` is a rank-major
    [n, ...] stack for a ``*_rank_major`` op, else this rank's buffer over
    the process world (or ``axis``'s subgroup; ``owned``: the in-place
    verbs may write it).  ``impl`` is a plan's; None takes the selector's
    for ``backend`` on one rank's bytes."""
    from . import collectives

    rank_major = op.endswith("_rank_major")
    if impl is None:
        one = buf[0] if rank_major else buf
        impl = selector.select(
            op, backend, nbytes=one.numel() * one.element_size(),
            ranks=buf.shape[0] if rank_major else None,
            n_dcn=None if axis is None else 1, dtype=buf.dtype,
            device=buf.device, axes=None if axis is None else (axis,))
    if rank_major:
        return impl(buf, **params)
    return collectives._world_run(op, impl, buf, params, axis=axis,
                                  owned=owned)


def run_buckets(op: str, tensors: Sequence[torch.Tensor], spec: FusedSpec,
                params: dict, *, impls: Optional[Sequence] = None,
                backend: Optional[str] = None) -> int:
    """``op`` over ``tensors`` (rank-major stacks for a ``*_rank_major``
    op) in place, one :func:`run_bucket` per bucket of ``spec``
    (``impls[k]``, a plan's in bucket order, else the selector's for
    ``backend``): gathered, run and scattered back.  Returns the number of
    launches."""
    rank_major = op.endswith("_rank_major")
    k = -1
    for g in spec.groups:
        for lo, hi in g.bounds:
            k += 1
            if lo == hi:  # a group of empty tensors
                continue
            buf = gather_bucket(tensors, g, lo, hi, rank_major=rank_major)
            out = run_bucket(op, buf, params, backend=backend, owned=True,
                             impl=None if impls is None else impls[k])
            scatter_bucket(out, tensors, g, lo, rank_major=rank_major)
    return spec.n_launches


def _planned(tensors, *, rank_major: bool, backend: Optional[str],
             verb: str, **params) -> Optional[int]:
    """The fused call through its plan (``planner.plan_gradsync``: the
    layout and each bucket's implementation bound once), or None with
    the planner off."""
    from . import planner

    if not planner.enabled():
        return None
    return planner.plan_gradsync(tensors, n_buckets=1, backend=backend,
                                 rank_major=rank_major, verb=verb,
                                 **params).replay(tensors)


def fused_(op_name: str, tensors: Sequence[torch.Tensor], *,
           spec: Optional[FusedSpec] = None, backend: Optional[str] = None,
           impls: Optional[Sequence] = None, **params) -> int:
    """Run collective ``op_name`` ("allreduce" or "broadcast") over ``tensors``
    in place, one launch per bucket (:func:`run_buckets`; ``impls`` a
    plan's).  Without ``spec`` and ``impls`` the call goes through its
    plan.  Tensors must be contiguous.  Returns the number of launches."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("fused collectives need contiguous tensors")
    if spec is None and impls is None and tensors:
        got = _planned(tensors, rank_major=False, backend=backend,
                       verb=op_name, **params)
        if got is not None:
            return got
    return run_buckets(op_name, tensors, spec or FusedSpec(tensors), params,
                       impls=impls, backend=backend)


def fused_allreduce_rank_major_(stacks: Sequence[torch.Tensor], *,
                                spec: Optional[FusedSpec] = None,
                                backend: Optional[str] = None,
                                op: str = "sum",
                                impls: Optional[Sequence] = None) -> int:
    """Allreduce rank-major stacks ([n, ...] each, ``stacks[i][r]`` = rank
    r's tensor i, all on one device) over the rank axis, in place, one
    rank-major allreduce per bucket (``collectives.allreduce_rank_major``'s
    routes; ``backend="pallas"`` is one ring launch per bucket; ``impls``
    a plan's per bucket).  The buckets are ``FusedSpec``'s over one rank's
    tensors; without ``spec`` and ``impls`` the call goes through its plan.
    Stacks must be contiguous; a mean needs floating stacks (its result is
    written back in their dtype).  Returns the number of launches."""
    if not stacks:
        return 0
    n = stacks[0].shape[0]
    for t in stacks:
        if not t.is_contiguous() or t.dim() < 1 or t.shape[0] != n:
            raise ValueError(f"fused rank-major collectives need contiguous "
                             f"[{n}, ...] stacks, got {tuple(t.shape)}")
        if op == "mean" and not t.dtype.is_floating_point:
            raise TypeError(f"a mean of {t.dtype} stacks is not written back "
                            f"in place")
    if spec is None and impls is None:
        got = _planned(stacks, rank_major=True, backend=backend,
                       verb="allreduce", op=op)
        if got is not None:
            return got
    return run_buckets("allreduce_rank_major", stacks,
                       spec or FusedSpec([t[0] for t in stacks]),
                       {"op": op}, impls=impls, backend=backend)


# ---------------------------------------------------------------------------
# In-axis verbs over trees (the JAX package's :99, :244-414)
# ---------------------------------------------------------------------------

# The in-axis verbs whose result is elementwise and keeps each tensor's
# shape: a concatenation's result is the concatenation of the tensors'
# results.  reduce_scatter has the tile-interleaved layout below; the other
# verbs change shapes and go per tensor.
ELEMENTWISE_OPS = ("allreduce", "reduce", "broadcast")


def _all_tensors(leaves) -> bool:
    return all(isinstance(t, torch.Tensor) for t in leaves)


def elementwise_spec(op_name: str, leaves: Sequence) -> Optional[FusedSpec]:
    """The fused layout of in-axis ``op_name`` over ``leaves``, or None for
    the per-tensor path (JAX ``maybe_fuse`` :317): fusion off
    (``Config.fuse_max_bytes`` 0), not an elementwise verb, fewer than two
    leaves, a leaf that is not a tensor, or buckets that would not cut the
    launches."""
    max_bytes = runtime.effective_config().fuse_max_bytes
    if max_bytes <= 0 or op_name not in ELEMENTWISE_OPS:
        return None
    if len(leaves) < 2 or not _all_tensors(leaves):
        return None
    spec = FusedSpec(leaves, max_bytes=max_bytes)
    return spec if spec.n_launches < spec.n_tensors else None


def fuse_tree(op_name: str, tree, *, spec: Optional[FusedSpec] = None,
              backend: Optional[str] = None, axis: Optional[str] = None,
              impls: Optional[Sequence] = None, **params):
    """Process-world ``op_name`` over every tensor of ``tree`` (over the
    world, or over ``axis``'s subgroup), one selector-routed launch per
    (dtype group x bucket; ``impls`` a plan's, bucket order), out of place
    (JAX :244).  Each group is copied into one buffer, on which the verbs'
    in-place implementations work; the result tensors are views of the
    reduced buffers, in the dtype the verb gives (float32 for an integer
    mean, as per tensor)."""
    leaves, treedef = _tree.flatten(tree)
    if spec is None:
        spec = FusedSpec(leaves)
    out: List = [None] * spec.n_tensors
    k = 0
    for g in spec.groups:
        flat = group_flat(leaves, g)
        parts = []
        for lo, hi in g.bounds:
            parts.append(run_bucket(
                op_name, flat[lo:hi], params, backend=backend, axis=axis,
                owned=True, impl=None if impls is None else impls[k]))
            k += 1
        gout = parts[0] if len(parts) == 1 else torch.cat(parts)
        off = 0
        for i, shape, size in zip(g.indices, g.shapes, g.sizes):
            out[i] = gout[off:off + size].reshape(shape)
            off += size
    return _tree.unflatten(treedef, out)


def maybe_fuse(op_name: str, tree, *, backend: Optional[str] = None,
               axis: Optional[str] = None, **params):
    """``tree``'s fused in-axis ``op_name`` (:func:`fuse_tree`), or None for
    the per-tensor path (:func:`elementwise_spec`)."""
    spec = elementwise_spec(op_name, _tree.leaves(tree))
    if spec is None:
        return None
    return fuse_tree(op_name, tree, spec=spec, backend=backend, axis=axis,
                     **params)


def reduce_scatter_spec(leaves: Sequence, n: int) -> Optional[FusedSpec]:
    """The fused tile-interleaved layout of a reduce-scatter of ``leaves``
    over ``n`` ranks, or None for the per-tensor path (JAX
    ``maybe_fuse_reduce_scatter`` :341): fusion off, fewer than two leaves,
    a leaf that is not a tensor, a leading dim that ``n`` does not divide,
    or buckets that would not cut the launches."""
    max_bytes = runtime.effective_config().fuse_max_bytes
    if max_bytes <= 0 or len(leaves) < 2 or not _all_tensors(leaves):
        return None
    if n <= 0 or any(t.dim() < 1 or t.shape[0] % n for t in leaves):
        return None
    spec = FusedSpec(leaves, max_bytes=max_bytes)
    return (spec if spec.n_reduce_scatter_launches < spec.n_tensors
            else None)


def _tile_shapes(g: DtypeGroup, bucket: Sequence[int], n: int):
    """(position in the tree, tile elements, tile shape) of each tensor of
    a reduce-scatter bucket."""
    for pos in bucket:
        shape = g.shapes[pos]
        yield (g.indices[pos], g.sizes[pos] // n,
               (shape[0] // n,) + tuple(shape[1:]))


def tile_bucket(leaves: Sequence[torch.Tensor], g: DtypeGroup,
                bucket: Sequence[int], n: int) -> torch.Tensor:
    """One reduce-scatter bucket in the tile-interleaved layout: each
    tensor viewed as its n tiles (``reshape(n, -1)``), concatenated along
    the tile axis, flat."""
    tiles = [leaves[g.indices[pos]].reshape(n, -1) for pos in bucket]
    return (tiles[0] if len(tiles) == 1 else torch.cat(tiles, 1)).reshape(-1)


def fused_reduce_scatter(tree, *, spec: FusedSpec, n: int,
                         backend: Optional[str] = None, op: str = "sum",
                         axis: Optional[str] = None,
                         impls: Optional[Sequence] = None):
    """The process-world reduce-scatter of every tensor of ``tree`` over
    ``n`` ranks, one launch per whole-tensor bucket (``impls`` a plan's,
    bucket order), in the tile-interleaved layout (JAX :379): each tensor
    viewed as its n tiles and a bucket concatenated along the tile axis
    (:func:`tile_bucket`), so that rank i's extent is ``[tensor0 tile i |
    tensor1 tile i | ...]``, bit for bit the per-tensor results.  ``axis``
    runs it over that axis's subgroup, of ``n`` ranks."""
    leaves, treedef = _tree.flatten(tree)
    out: List = [None] * spec.n_tensors
    k = 0
    for g in spec.groups:
        for bucket in g.leaf_buckets:
            shard = run_bucket("reduce_scatter",
                               tile_bucket(leaves, g, bucket, n), {"op": op},
                               backend=backend, axis=axis,
                               impl=None if impls is None else impls[k])
            k += 1
            off = 0
            for i, ts, shape in _tile_shapes(g, bucket, n):
                out[i] = shard[off:off + ts].reshape(shape)
                off += ts
    return _tree.unflatten(treedef, out)


def maybe_fuse_reduce_scatter(tree, *, backend: Optional[str] = None,
                              op: str = "sum", axis: Optional[str] = None):
    """``tree``'s fused process-world reduce-scatter
    (:func:`fused_reduce_scatter`), or None for the per-tensor path
    (:func:`reduce_scatter_spec` over the ranks of the world or of
    ``axis``)."""
    n = (runtime.size() if axis is None
         else runtime.grid()[0 if axis == "dcn" else 1])
    spec = reduce_scatter_spec(_tree.leaves(tree), n)
    if spec is None:
        return None
    return fused_reduce_scatter(tree, spec=spec, n=n, backend=backend, op=op,
                                axis=axis)


def fused_reduce_scatter_rank_major(stacks: Sequence[torch.Tensor], *,
                                    backend: Optional[str] = None,
                                    op: str = "sum") -> List[torch.Tensor]:
    """The rank-major reduce-scatter of every stack (``stacks[i]`` [n, k,
    ...] = the n ranks' tensor i, k divisible by n): slice r of result i
    [n, k / n, ...] is rank r's tile of the sum over ranks.  Fused as
    :func:`fused_reduce_scatter` lays a bucket out, with the rank axis in
    front: each stack viewed as [n, n, -1] (rank, tile, tile elements) and a
    bucket concatenated along the last axis, one ``reduce_scatter_rank_major``
    launch per bucket (``backend="pallas"``: one ring launch); per stack
    where :func:`reduce_scatter_spec` says so."""
    if not stacks:
        return []
    n = stacks[0].shape[0]

    def run(t: torch.Tensor):
        return run_bucket("reduce_scatter_rank_major", t, {"op": op},
                          backend=backend)

    spec = reduce_scatter_spec([t[0] for t in stacks], n)
    if spec is None:
        return [run(t) for t in stacks]
    out: List = [None] * spec.n_tensors
    for g in spec.groups:
        for bucket in g.leaf_buckets:
            tiles = [stacks[g.indices[pos]].reshape(n, n, -1)
                     for pos in bucket]
            buf = (tiles[0] if len(tiles) == 1
                   else torch.cat(tiles, 2)).reshape(n, -1)
            shard = run(buf).reshape(n, -1)
            off = 0
            for i, ts, shape in _tile_shapes(g, bucket, n):
                out[i] = shard[:, off:off + ts].reshape(n, *shape)
                off += ts
    return out


# ---------------------------------------------------------------------------
# ZeRO shard layout (the JAX package's :218, :419-476, on tensor lists)
# ---------------------------------------------------------------------------


def group_flat(tensors: Sequence[torch.Tensor], g: DtypeGroup, *,
               pad: bool = False, rank_major: bool = False) -> torch.Tensor:
    """``g``'s tensors concatenated flat in their own dtype, optionally
    zero-padded to ``g.padded`` (:218); rank-major stacks [n, ...] give
    [n, total or padded]."""
    parts = [tensors[i].reshape(tensors[i].shape[0], -1) if rank_major
             else tensors[i].reshape(-1) for i in g.indices]
    if pad and g.padded > g.total:
        parts.append(parts[0].new_zeros(*parts[0].shape[:-1],
                                        g.padded - g.total))
    return torch.cat(parts, -1) if len(parts) > 1 else parts[0].clone()


def group_flats(stacks: Sequence[torch.Tensor],
                spec: FusedSpec) -> List[torch.Tensor]:
    """The padded group flats [n, g.padded] of rank-major stacks, one per
    dtype group: ZeRO's rank-major gradient input."""
    return [group_flat(stacks, g, pad=True, rank_major=True)
            for g in spec.groups]


def rank_major_buffers(spec: FusedSpec, n: int, *, device="cuda"):
    """Zeroed group flats [n, g.padded] (one per dtype group) and, for each
    tensor of the spec, its [n, *shape] view into them: a rank writes its
    gradients through the views and the flats are ZeRO's rank-major
    gradient input with no copy (the padding stays zero).  On the card
    unless ``device`` says otherwise."""
    flats = [torch.zeros(n, g.padded, dtype=g.dtype, device=device)
             for g in spec.groups]
    views: List[Optional[torch.Tensor]] = [None] * spec.n_tensors
    for g, flat in zip(spec.groups, flats):
        off = 0
        for i, shape, size in zip(g.indices, g.shapes, g.sizes):
            views[i] = flat[:, off:off + size].view(n, *shape)
            off += size
    return flats, views


def flatten_tree(tensors: Sequence[torch.Tensor],
                 spec: FusedSpec) -> torch.Tensor:
    """Every tensor in one flat vector promoted to ``spec.dtype``,
    group-major, each group zero-padded to ``g.padded`` (:419)."""
    parts = [group_flat(tensors, g, pad=True).to(spec.dtype)
             for g in spec.groups]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _unpack(gf: torch.Tensor, g: DtypeGroup, spec: FusedSpec,
            out: List) -> None:
    off = 0
    for i, shape, size in zip(g.indices, g.shapes, g.sizes):
        out[i] = gf[off:off + size].reshape(shape).to(spec.dtypes[i])
        off += size


def unflatten_tree(flat: torch.Tensor, spec: FusedSpec) -> List[torch.Tensor]:
    """Inverse of :func:`flatten_tree`: each tensor sliced out, reshaped and
    cast back to its dtype, padding dropped (:430)."""
    out: List = [None] * spec.n_tensors
    off = 0
    for g in spec.groups:
        _unpack(flat[off:off + g.padded], g, spec, out)
        off += g.padded
    return out


def local_shard(tensors: Sequence[torch.Tensor], spec: FusedSpec,
                index: int) -> torch.Tensor:
    """Rank ``index``'s flat promoted shard [spec.shard]: every group's
    extent ``index``, concatenated in group order (:446) -- the ZeRO shard
    linearization."""
    return local_shards(tensors, spec)[index]


def local_shards(tensors: Sequence[torch.Tensor],
                 spec: FusedSpec) -> torch.Tensor:
    """Every rank's :func:`local_shard` of the same tensors, stacked
    rank-major: [n_shards, spec.shard]."""
    parts = [group_flat(tensors, g, pad=True).to(spec.dtype).view(
        spec.n_shards, g.shard) for g in spec.groups]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def unflatten_shards(flat: torch.Tensor,
                     spec: FusedSpec) -> List[torch.Tensor]:
    """The tensors from the rank-order concatenation of every rank's
    :func:`local_shard` (``flat``, ``spec.n_shards * spec.shard``
    elements): each group's extents regrouped into its padded flat, then
    unflattened (:460)."""
    rows = flat.reshape(spec.n_shards, spec.shard)
    out: List = [None] * spec.n_tensors
    col = 0
    for g in spec.groups:
        _unpack(rows[:, col:col + g.shard].reshape(-1), g, spec, out)
        col += g.shard
    return out
