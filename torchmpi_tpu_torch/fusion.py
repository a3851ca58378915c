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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import runtime, selector


class DtypeGroup:
    """One dtype's slice of a :class:`FusedSpec`: which tensors (positions
    in the input list), their shapes and element counts, the bucket bounds,
    and the shard layout (``padded`` elements, ``shard`` per rank)."""

    __slots__ = ("dtype", "indices", "shapes", "sizes", "total", "bounds",
                 "padded", "shard")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.indices: List[int] = []
        self.shapes: List[torch.Size] = []
        self.sizes: List[int] = []
        self.total = 0
        self.bounds: List[Tuple[int, int]] = []

    @property
    def nbytes(self) -> int:
        return self.total * torch.empty((), dtype=self.dtype).element_size()


class FusedSpec:
    """Static fusion layout of a list of tensors (group-major, first-seen
    dtype order, byte-bounded element buckets), and its shard layout over
    ``n_shards`` ranks: each group padded to ``padded``, a multiple of
    ``n_shards``, of which each rank owns ``shard``; the promoted view
    (``dtype``, ``padded``, ``shard``) is the groups' concatenation."""

    def __init__(self, tensors: Sequence[torch.Tensor], n_shards: int = 1, *,
                 max_bytes: Optional[int] = None):
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
        for g in self.groups:
            k = 1
            if max_bytes and max_bytes > 0:
                k = max(1, min(max(1, g.total), -(-g.nbytes // max_bytes)))
            edges = np.linspace(0, g.total, k + 1).astype(int)
            g.bounds = [(int(edges[i]), int(edges[i + 1]))
                        for i in range(k) if edges[i] < edges[i + 1]]
            if not g.bounds:
                g.bounds = [(0, g.total)]

    @property
    def n_launches(self) -> int:
        """Collectives one fused call issues for this list."""
        return sum(len(g.bounds) for g in self.groups)


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
    for rank-major stacks)."""
    parts = [_flat(tensors[g.indices[pos]], rank_major)[..., a:b]
             for pos, a, b in _pieces(g, lo, hi)]
    return torch.cat(parts, -1) if len(parts) > 1 else parts[0].clone()


def scatter_bucket(flat: torch.Tensor, tensors: Sequence[torch.Tensor],
                   g: DtypeGroup, lo: int, *,
                   rank_major: bool = False) -> None:
    """Write ``flat`` (the group's elements from ``lo``) back, in place."""
    off = 0
    for pos, a, b in _pieces(g, lo, lo + flat.shape[-1]):
        _flat(tensors[g.indices[pos]], rank_major)[..., a:b].copy_(
            flat[..., off:off + b - a])
        off += b - a


def fused_(op_name: str, tensors: Sequence[torch.Tensor], *,
           spec: Optional[FusedSpec] = None, backend: Optional[str] = None,
           **params) -> int:
    """Run collective ``op_name`` ("allreduce" or "broadcast") over ``tensors``
    in place, one launch per bucket; each bucket's implementation is the
    selector's for its bytes.  Tensors must be contiguous.  Returns the
    number of launches."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("fused collectives need contiguous tensors")
    if spec is None:
        spec = FusedSpec(tensors)
    for g in spec.groups:
        for lo, hi in g.bounds:
            if lo == hi:  # a group of empty tensors
                continue
            buf = gather_bucket(tensors, g, lo, hi)
            impl = selector.select(op_name, backend,
                                   nbytes=buf.numel() * buf.element_size())
            scatter_bucket(impl(buf, **params), tensors, g, lo)
    return spec.n_launches


def fused_allreduce_rank_major_(stacks: Sequence[torch.Tensor], *,
                                spec: Optional[FusedSpec] = None,
                                backend: Optional[str] = None,
                                op: str = "sum") -> int:
    """Allreduce rank-major stacks ([n, ...] each, ``stacks[i][r]`` = rank
    r's tensor i, all on one device) over the rank axis, in place, one
    rank-major allreduce per bucket (``collectives.allreduce_rank_major``'s
    routes; ``backend="pallas"`` is one ring launch per bucket).  The
    buckets are ``FusedSpec``'s over one rank's tensors.  Stacks must be
    contiguous; a mean needs floating stacks (its result is written back in
    their dtype).  Returns the number of launches."""
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
    if spec is None:
        spec = FusedSpec([t[0] for t in stacks])
    for g in spec.groups:
        for lo, hi in g.bounds:
            if lo == hi:
                continue
            buf = gather_bucket(stacks, g, lo, hi, rank_major=True)
            impl = selector.select(
                "allreduce_rank_major", backend,
                nbytes=(hi - lo) * buf.element_size())
            scatter_bucket(impl(buf, op=op), stacks, g, lo, rank_major=True)
    return spec.n_launches


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
