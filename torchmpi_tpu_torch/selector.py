"""Collective implementation selector (stock route only).

The PyTorch counterpart of ``torchmpi_tpu/selector.py``: a table from
(op, backend name) to an implementation.  The port has one route so far:

- ``"xla"``: the stock route, which here is the process group's own backend
  (NCCL on the card, gloo on the CPU), the way the reference's stock route
  was NCCL/MPI.
- ``"pallas"``: the hand-written ring collectives.  Their CUDA counterparts
  are ROADMAP queue B (rows 7-14 of PERF.md's kernel table); until they
  land, asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(op: str, backend: str, fn: Callable) -> None:
    _REGISTRY.setdefault(op, {})[backend] = fn


def available(op: Optional[str] = None) -> Dict:
    """Introspection (reference: ``mpi.collectiveAvailability``)."""
    if op is not None:
        return dict(_REGISTRY.get(op, {}))
    return {k: sorted(v) for k, v in _REGISTRY.items()}


def select(op: str, backend: Optional[str] = None) -> Callable:
    """The implementation of ``op`` on ``backend`` (default: the active
    Config's ``backend``)."""
    if backend is None:
        from . import runtime

        backend = runtime.effective_config().backend
    if backend == "pallas":
        raise NotImplementedError(
            f"backend 'pallas' ({op}): the ring-collective kernels are not "
            "ported to CUDA yet (ROADMAP queue B); use backend='xla'")
    impls = _REGISTRY.get(op)
    if impls is None:
        raise ValueError(f"unknown collective {op!r} "
                         f"(known: {sorted(_REGISTRY)})")
    if backend not in impls:
        raise ValueError(f"collective {op!r} has no backend {backend!r} "
                         f"(available: {sorted(impls)})")
    return impls[backend]
