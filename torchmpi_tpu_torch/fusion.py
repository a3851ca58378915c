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


def gather_bucket(tensors: Sequence[torch.Tensor], g: DtypeGroup, lo: int,
                  hi: int) -> torch.Tensor:
    """The group's elements [lo, hi) as one new flat tensor."""
    parts = [tensors[g.indices[pos]].reshape(-1)[a:b]
             for pos, a, b in _pieces(g, lo, hi)]
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def scatter_bucket(flat: torch.Tensor, tensors: Sequence[torch.Tensor],
                   g: DtypeGroup, lo: int) -> None:
    """Write ``flat`` (the group's elements from ``lo``) back, in place."""
    off = 0
    for pos, a, b in _pieces(g, lo, lo + flat.numel()):
        tensors[g.indices[pos]].view(-1)[a:b].copy_(flat[off:off + b - a])
        off += b - a


def fused_(op_name: str, tensors: Sequence[torch.Tensor], *,
           spec: Optional[FusedSpec] = None, backend: Optional[str] = None,
           **params) -> int:
    """Run collective ``op_name`` ("allreduce" or "broadcast") over ``tensors``
    in place, one launch per bucket.  Tensors must be contiguous.  Returns
    the number of launches."""
    impl = selector.select(op_name, backend)
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
            scatter_bucket(impl(buf, **params), tensors, g, lo)
    return spec.n_launches
