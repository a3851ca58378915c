"""Tree <-> flat float32 vector (the parameter server's wire format).

The port's counterpart of ``torchmpi_tpu/utils/tree.py`` (``flatten_f32``
:40, ``unflatten_f32`` :61), with its dtype contract: the wire and shard
format is float32 (the server's update rules do float32 arithmetic).
Leaves may be float32, bfloat16 or float16: each embeds in float32
exactly, so a send -> receive round trip is bit-exact after the cast
back.  Any other dtype (float64, integers: float32's mantissa clips above
2^24) raises ``TypeError``.

A tree is the port's (``_tree``: dicts with sorted keys, lists, tuples),
and its leaves are either all torch tensors or all numpy arrays:

- torch tensors (on one device): the flat vector is built on that device
  as one buffer, and ``unflatten_f32`` gives tensors on the flat vector's
  device (float32 leaves are views of it);
- numpy arrays: the flat vector is numpy, as the JAX package's.  A numpy
  bfloat16 leaf (the ``bfloat16`` dtype that JAX arrays convert to) is
  read and written through its bits, so no bfloat16 package is needed.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from .. import _tree

_EXACT_TORCH = (torch.float32, torch.bfloat16, torch.float16)
_EXACT_NUMPY = ("float32", "bfloat16", "float16")


class TreeSpec:
    """A flattened tree's structure, leaf shapes and dtypes; ``device`` is
    the torch device of its leaves, None for numpy leaves."""

    def __init__(self, treedef, shapes: List[Tuple[int, ...]],
                 dtypes: List[Any], device=None):
        self.treedef = treedef
        self.shapes = shapes
        self.dtypes = dtypes
        self.device = device
        self.sizes = [int(np.prod(s)) for s in shapes]
        self.total = int(sum(self.sizes))


def _lossy(dtype) -> TypeError:
    return TypeError(
        f"parameter-server trees must be f32/bf16/f16 (exact in the f32 "
        f"wire format); got {dtype} — cast explicitly if the precision "
        f"loss is intended")


def _bf16_to_f32(a: np.ndarray) -> np.ndarray:
    """A numpy bfloat16 (or uint16 bit pattern) array as float32, exact."""
    bits = a.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even
    as a bfloat16 cast rounds; NaN stays NaN."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    out = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    out = np.where(np.isnan(a), (u >> 16) | 0x40, out)
    return out.astype(np.uint16)


def flatten_f32(tree) -> Tuple[Any, TreeSpec]:
    """Flatten a tree into one float32 vector (a tensor on the leaves'
    device, or numpy for numpy leaves) and its :class:`TreeSpec`.

    Raises TypeError for leaves whose dtype does not embed exactly in
    float32, and for a tree that mixes tensors with other leaves."""
    leaves, treedef = _tree.flatten(tree)
    if leaves and all(isinstance(x, torch.Tensor) for x in leaves):
        for x in leaves:
            if x.dtype not in _EXACT_TORCH:
                raise _lossy(x.dtype)
        dev = leaves[0].device
        if any(x.device != dev for x in leaves):
            raise ValueError("parameter-server tree leaves lie on several "
                             "devices")
        spec = TreeSpec(treedef, [tuple(x.shape) for x in leaves],
                        [x.dtype for x in leaves], dev)
        if all(x.dtype == torch.float32 for x in leaves):
            flat = torch.cat([x.detach().reshape(-1) for x in leaves])
        else:
            flat = torch.empty(spec.total, dtype=torch.float32, device=dev)
            off = 0
            for x, n in zip(leaves, spec.sizes):
                flat[off:off + n].copy_(x.detach().reshape(-1))
                off += n
        return flat, spec
    if any(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError("a parameter-server tree holds torch tensors or "
                        "numpy arrays, not both")
    arrs = [np.asarray(x) for x in leaves]
    for a in arrs:
        if a.dtype.name not in _EXACT_NUMPY:
            raise _lossy(a.dtype)
    spec = TreeSpec(treedef, [a.shape for a in arrs], [a.dtype for a in arrs])
    if not arrs:
        return np.zeros((0,), np.float32), spec
    flat = np.concatenate([
        (_bf16_to_f32(a) if a.dtype.name == "bfloat16"
         else a.astype(np.float32)).reshape(-1) for a in arrs])
    return np.ascontiguousarray(flat, np.float32), spec


def unflatten_f32(spec: TreeSpec, flat) -> Any:
    """The tree of ``spec`` holding ``flat``'s values in its leaf dtypes:
    tensors for a tensor ``flat`` (float32 leaves are views of it), numpy
    arrays (copies) for a numpy one.  A numpy ``flat`` of a tensor tree
    is taken as a CPU tensor, sharing its memory."""
    if spec.device is not None and isinstance(flat, np.ndarray):
        flat = torch.from_numpy(flat)
    out = []
    off = 0
    for shape, size, dtype in zip(spec.shapes, spec.sizes, spec.dtypes):
        seg = flat[off:off + size]
        if isinstance(flat, torch.Tensor):
            out.append(seg.view(shape) if dtype == torch.float32
                       else seg.to(dtype).view(shape))
        elif np.dtype(dtype).name == "bfloat16":
            out.append(_f32_to_bf16_bits(seg).view(dtype).reshape(shape))
        else:
            out.append(seg.reshape(shape).astype(dtype))
        off += size
    return _tree.unflatten(spec.treedef, out)
