"""Collective implementation selector.

The PyTorch counterpart of ``torchmpi_tpu/selector.py``: a table from
(op, backend name) to an implementation, and the JAX package's rules for
picking one (``select`` :86-150, without its "hierarchical" and "auto"
routes, which belong to modules not ported yet).  Backends:

- ``"xla"``: the stock route.  Across processes it is the process group's
  own backend (NCCL on the card, gloo on the CPU), the way the reference's
  stock route was NCCL/MPI; over a rank-major stack it is a sum over the
  rank axis.
- ``"pallas"``: the hand-written ring kernels (``ops/ring.py``).  They run
  rank-major, every rank's buffer on one card.  Across processes their
  peers would be other processes' buffers, reached through CUDA IPC or
  symmetric memory on two or more cards (ROADMAP queue B): a world of one
  process returns a copy, a larger one raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

BACKENDS = ("xla", "pallas")

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(op: str, backend: str, fn: Callable) -> None:
    _REGISTRY.setdefault(op, {})[backend] = fn


def available(op: Optional[str] = None) -> Dict:
    """Introspection (reference: ``mpi.collectiveAvailability``)."""
    if op is not None:
        return dict(_REGISTRY.get(op, {}))
    return {k: sorted(v) for k, v in _REGISTRY.items()}


def select(op: str, backend: Optional[str] = None, *,
           nbytes: Optional[int] = None) -> Callable:
    """The implementation of ``op``.

    ``backend`` None takes the active Config's ``backend``; a per-call
    backend is explicit.  A custom backend falls back to ``"xla"`` when the
    payload (``nbytes``, one rank's bytes) is below
    ``Config.custom_min_bytes`` and the backend was not explicit, and when
    it has no implementation of ``op``."""
    from . import runtime

    cfg = runtime.effective_config()
    explicit = backend is not None
    name = backend if explicit else cfg.backend
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r} (ported: {BACKENDS})")
    impls = _REGISTRY.get(op)
    if impls is None:
        raise ValueError(f"unknown collective {op!r} "
                         f"(known: {sorted(_REGISTRY)})")
    if name != "xla":
        if (not explicit and nbytes is not None
                and nbytes < cfg.custom_min_bytes):
            name = "xla"
        elif name not in impls:
            name = "xla"
    if name not in impls:
        raise ValueError(f"collective {op!r} has no backend {name!r} "
                         f"(available: {sorted(impls)})")
    return impls[name]
