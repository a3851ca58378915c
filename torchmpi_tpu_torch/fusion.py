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
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import runtime, selector


class DtypeGroup:
    """One dtype's slice of a :class:`FusedSpec`: which tensors (positions
    in the input list), their element counts, and the bucket bounds."""

    __slots__ = ("dtype", "indices", "sizes", "total", "bounds")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.indices: List[int] = []
        self.sizes: List[int] = []
        self.total = 0
        self.bounds: List[Tuple[int, int]] = []

    @property
    def nbytes(self) -> int:
        return self.total * torch.empty((), dtype=self.dtype).element_size()


class FusedSpec:
    """Static fusion layout of a list of tensors (group-major, first-seen
    dtype order, byte-bounded element buckets)."""

    def __init__(self, tensors: Sequence[torch.Tensor], *,
                 max_bytes: Optional[int] = None):
        if max_bytes is None:
            max_bytes = runtime.effective_config().fuse_max_bytes
        self.n_tensors = len(tensors)
        by_dtype = {}
        self.groups: List[DtypeGroup] = []
        for i, t in enumerate(tensors):
            g = by_dtype.get(t.dtype)
            if g is None:
                g = by_dtype[t.dtype] = DtypeGroup(t.dtype)
                self.groups.append(g)
            g.indices.append(i)
            g.sizes.append(t.numel())
            g.total += t.numel()
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
