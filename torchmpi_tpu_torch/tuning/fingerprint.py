"""Topology fingerprints: the key space of the collective plan database.

The PyTorch counterpart of ``torchmpi_tpu/tuning/fingerprint.py`` (:23-97).
A plan entry answers "which backend won for THIS situation"; the
fingerprint is what "situation" means: platform, the (dcn, ici) grid the
call spans, op, dtype, and a log2 size bucket, in the JAX package's format
``platform|dcn:a,ici:b|op|dtype|bN``.

Where the JAX package reads a device mesh, the port reads a :class:`Grid`:
``ici`` is the NVLink / NVSwitch domain (the cards of a node, or the ranks
of a rank-major stack on one card) and ``dcn`` the node count, the grid of
``runtime.grid``; the platform is the torch device type (``"cuda"`` on the
card, ``"cpu"`` in the tests).  A rank-major stack of n ranks on one card
is its own ``dcn:1,ici:n`` (or ``dcn:d,ici:n/d`` under ``Config.dcn_size``).
On the CPU the keys equal the JAX package's, string for string.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Grid:
    """The world a collective spans, as the fingerprint reads it: the axis
    sizes in grid order (``shape``, ``{"dcn": a, "ici": b}``, or the
    communicator's own axes, ``shape`` given, under ``Config.mesh_shape``
    or a pushed communicator) and the platform (the torch device type)."""

    __slots__ = ("shape", "platform")

    def __init__(self, dcn: int, ici: int, platform: str,
                 shape: Optional[dict] = None) -> None:
        self.shape = ({"dcn": int(dcn), "ici": int(ici)} if shape is None
                      else {a: int(s) for a, s in shape.items()})
        self.platform = platform

    def __repr__(self) -> str:
        return f"Grid({mesh_key(self)}, {self.platform!r})"


def size_bucket(nbytes: int) -> int:
    """floor(log2(nbytes)); sizes of 0/1 byte share bucket 0."""
    return max(0, int(nbytes).bit_length() - 1)


def bucket_bytes(bucket: int) -> int:
    """Lower edge (in bytes) of ``bucket``: inverse of size_bucket."""
    return 1 << bucket


def mesh_key(mesh, axes=None) -> str:
    """Ordered axis-name:size signature, e.g. ``dcn:2,ici:4``.  ``axes``
    restricts it to the axes the collective spans, in grid order, so a
    decision measured over the whole grid is never replayed for an axis
    subset that was never measured."""
    if axes is None:
        return ",".join(f"{a}:{int(s)}" for a, s in mesh.shape.items())
    sel = set(axes)
    return ",".join(f"{a}:{int(s)}" for a, s in mesh.shape.items()
                    if a in sel)


def topology(mesh=None, sizes=None, axes=None) -> str:
    """The ``n_dcn x n_ici`` topology label of a dispatch ("2x2", "1x4"):
    the spanned axis extents joined major-to-minor.  ``sizes`` wins over
    ``mesh``; ``axes`` restricts the grid like :func:`mesh_key`."""
    if sizes:
        return "x".join(str(int(s)) for s in sizes)
    if mesh is not None:
        sel = set(axes) if axes is not None else None
        return "x".join(str(int(s)) for a, s in mesh.shape.items()
                        if sel is None or a in sel)
    return ""


def platform_of(mesh) -> str:
    return getattr(mesh, "platform", None) or "unknown"


def dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype ("float32", "bfloat16")."""
    if isinstance(dtype, str):
        return dtype
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    return np.dtype(dtype).name


def fingerprint(op: str, nbytes: int, dtype, mesh,
                platform: Optional[str] = None, axes=None) -> str:
    """The plan-database key for one (op, size, grid, platform) decision.

    ``nbytes`` is the PER-RANK payload (what the selector's size cutover
    compares), ``dtype`` a torch or numpy dtype, ``axes`` the grid axes the
    collective spans (None: the whole grid)."""
    plat = platform if platform is not None else platform_of(mesh)
    return (f"{plat}|{mesh_key(mesh, axes)}|{op}|{dtype_name(dtype)}"
            f"|b{size_bucket(nbytes)}")
