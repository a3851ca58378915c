"""Collective implementation selector.

The PyTorch counterpart of ``torchmpi_tpu/selector.py``: a table from
(op, backend name) to an implementation, and the JAX package's rules for
picking one (``select`` :64-150, the "auto" route included).  Backends:

- ``"xla"``: the stock route.  Across processes it is the process group's
  own backend (NCCL on the card, gloo on the CPU), the way the reference's
  stock route was NCCL/MPI; over a rank-major stack it is a sum over the
  rank axis.
- ``"pallas"``: the hand-written ring kernels (``ops/ring.py``).  They run
  rank-major, every rank's buffer on one card.  Across processes their
  peers would be other processes' buffers, reached through CUDA IPC or
  symmetric memory on two or more cards (ROADMAP queue B): a world of one
  process returns a copy, a larger one raises.  On a two-level world
  (``Config.dcn_size``) the rank-major ring runs over each node's ici
  ranks and the dcn level is folded around it (``ops/ring.py``).
- ``"hierarchical"``: the two-level verbs (``parallel/hierarchical.py``):
  reduce-scatter over ici, allreduce over dcn, all-gather over ici for the
  allreduce, and node leaders first for the others.  ``Config.hierarchical``
  picks it over ``Config.backend`` (JAX ``collectives._config_backend``
  :305-315).  On a flat world (one dcn member) it falls back to ``"xla"``
  with one ``RuntimeWarning`` per (op, backend) (JAX :136-142, :159).
- ``"auto"``: the tuning plans' measured choice (``tuning/``): the
  registered plan provider names the backend that won at this (op, size
  bucket, grid, platform); a hit has a per-call backend's authority (no
  size cutover, topology and availability degradation still apply), a
  miss is the stock route.  The eager paths measure a missing key before
  they get here (``planner.py``); the selector only reads.

Every :func:`register` bumps :func:`generation`, part of every plan's
key, so a re-registered implementation strands the plans that resolved
the old one.

The rank-major routes that run on the two-level grid (:data:`TWO_LEVEL`)
take the grid's dcn size as the keyword ``n_dcn``; :func:`select` binds
the call's when it is above 1, so no layer below reads the topology.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, Optional, Set, Tuple

import torch

BACKENDS = ("xla", "pallas", "hierarchical")

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_generation = 0

# The (op, backend) routes whose implementation takes the dcn size of the
# call's grid as ``n_dcn``: the two-level "pallas" ring (ops/ring.py) and
# the hierarchical verbs whose fold order or mean differ from the stock
# closed forms (parallel/hierarchical.py).
TWO_LEVEL = frozenset({
    ("allreduce_rank_major", "pallas"),
    ("reduce_scatter_rank_major", "pallas"),
    ("allgather_rank_major", "pallas"),
    ("allreduce_rank_major", "hierarchical"),
    ("reduce_rank_major", "hierarchical"),
})


def register(op: str, backend: str, fn: Callable) -> None:
    global _generation
    _REGISTRY.setdefault(op, {})[backend] = fn
    _generation += 1


def generation() -> int:
    return _generation


def available(op: Optional[str] = None) -> Dict:
    """Introspection (reference: ``mpi.collectiveAvailability``)."""
    if op is not None:
        return dict(_REGISTRY.get(op, {}))
    return {k: sorted(v) for k, v in _REGISTRY.items()}


# The tuning plans' read-only consult (tuning.autoselect.plan_lookup):
# fn(verb, nbytes, dtype, grid, axes) -> Optional[backend name].
_plan_provider: Optional[Callable] = None


def set_plan_provider(fn: Callable) -> None:
    global _plan_provider
    _plan_provider = fn


def clear_plan_provider() -> None:
    global _plan_provider
    _plan_provider = None


def plan_provider() -> Optional[Callable]:
    return _plan_provider


def verb_of(op: str) -> str:
    """The verb of a selector op ("allreduce_rank_major" -> "allreduce"):
    the name plan keys use."""
    return op[:-len("_rank_major")] if op.endswith("_rank_major") else op


def config_backend(cfg) -> str:
    """The Config's backend: ``"hierarchical"`` when
    ``Config.hierarchical``, else ``Config.backend`` (JAX
    ``collectives._config_backend`` :305-315)."""
    return "hierarchical" if cfg.hierarchical else cfg.backend


def grid_of(n: Optional[int] = None, device=None,
            n_dcn: Optional[int] = None):
    """The ``tuning.Grid`` a call spans: a rank-major stack of ``n`` ranks
    on ``device`` (dcn ``n_dcn``, else the Config's grid of n), or the
    process world (``n`` None; None before ``init``)."""
    from . import runtime
    from .tuning.fingerprint import Grid

    if n is None:
        if not runtime.is_initialized():
            return None
        d, i = runtime.grid()
        plat = (runtime.device() if device is None
                else torch.device(device)).type
        return Grid(d, i, plat)
    if n_dcn is None:
        try:
            n_dcn = runtime.grid(n)[0]
        except ValueError:  # dcn_size does not divide n: the selector
            n_dcn = 1       # raises where a route needs the grid
    plat = torch.device(device).type if device is not None else "cpu"
    return Grid(n_dcn, n // n_dcn, plat)


# (op, backend) pairs already warned about in this process: one warning per
# pair, so a loop that degrades on every call does not repeat it.
_warned_fallbacks: Set[Tuple[str, str]] = set()


def _note_fallback(op: str, backend: str, reason: str, *,
                   target: str = "'xla'") -> None:
    """One ``RuntimeWarning`` per (op, backend) that a requested backend
    degraded to ``target`` (JAX :159, without the telemetry counter, which
    waits for the obs layer, ROADMAP queue A, item 10)."""
    key = (op, backend)
    if key in _warned_fallbacks:
        return
    _warned_fallbacks.add(key)
    warnings.warn(
        f"collective {op!r}: {backend!r} requested but degraded to {target} "
        f"({reason}); check dcn_size if a two-level topology was intended",
        RuntimeWarning, stacklevel=4)


def _n_dcn(op: str, ranks: Optional[int]) -> int:
    """The dcn size the call spans: the grid of a rank-major stack of
    ``ranks`` (or of the Config's ``dcn_size`` when not given), the
    process world's otherwise."""
    from . import runtime

    if op.endswith("_rank_major"):
        if ranks is not None:
            return runtime.grid(ranks)[0]
        return runtime.effective_config().dcn_size or 1
    return runtime.grid()[0] if runtime.is_initialized() else 1


def select(op: str, backend: Optional[str] = None, *,
           nbytes: Optional[int] = None, ranks: Optional[int] = None,
           n_dcn: Optional[int] = None, dtype=None, device=None,
           grid=None, axes=None) -> Callable:
    """The implementation of ``op``.

    ``backend`` None takes the active Config's (:func:`config_backend`); a
    per-call backend is explicit.  ``"auto"`` asks the plan provider for
    the plan of (``op``'s verb, ``nbytes``, ``dtype``, grid, ``axes``),
    the grid ``grid`` or else the one the call spans (:func:`grid_of` of
    ``ranks`` on ``device`` for a rank-major op, of the process world
    otherwise): a hit is explicit, a miss the stock route.  A custom backend falls back to ``"xla"`` when the payload
    (``nbytes``, one rank's bytes) is below ``Config.custom_min_bytes``
    and the backend was not explicit, and when it has no implementation
    of ``op``.  ``"hierarchical"`` falls back, with a warning, where the
    call spans one dcn member: ``n_dcn``, else the grid of a rank-major
    stack of ``ranks`` or of the process world.  A :data:`TWO_LEVEL`
    route on more than one dcn member comes with that dcn size bound to
    its ``n_dcn`` (the routes' default is one level)."""
    from . import runtime

    cfg = runtime.effective_config()
    explicit = backend is not None
    name = backend if explicit else config_backend(cfg)
    if name == "auto":
        planned = None
        if _plan_provider is not None:
            if grid is None:
                grid = grid_of(ranks if op.endswith("_rank_major") else None,
                               device, n_dcn)
            planned = _plan_provider(verb_of(op), nbytes or 0, dtype, grid,
                                     axes)
        explicit = planned is not None
        name = planned if planned in BACKENDS else "xla"
        if (name == "pallas" and not op.endswith("_rank_major")
                and runtime.is_initialized() and runtime.size() > 1):
            # A plan measured on a rank-major stack of the same grid: the
            # ring across processes is not ported (availability).
            _note_fallback(op, name, "the ring runs rank-major only")
            name = "xla"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r} (ported: "
                         f"{BACKENDS + ('auto',)})")
    impls = _REGISTRY.get(op)
    if impls is None:
        raise ValueError(f"unknown collective {op!r} "
                         f"(known: {sorted(_REGISTRY)})")
    if name != "xla":
        if (not explicit and nbytes is not None
                and nbytes < cfg.custom_min_bytes):
            name = "xla"
        elif name == "hierarchical" and (
                _n_dcn(op, ranks) if n_dcn is None else n_dcn) <= 1:
            _note_fallback(op, name, "flat world (n_dcn <= 1)")
            name = "xla"
        elif name not in impls:
            name = "xla"
    if name not in impls:
        raise ValueError(f"collective {op!r} has no backend {name!r} "
                         f"(available: {sorted(impls)})")
    if (op, name) in TWO_LEVEL:
        n_dcn = _n_dcn(op, ranks) if n_dcn is None else n_dcn
        if n_dcn > 1:
            return functools.partial(impls[name], n_dcn=n_dcn)
    return impls[name]


def name_of(op: str, impl: Callable) -> str:
    """Reverse lookup: the backend name a resolved implementation was
    registered under (a plan's rows); ``"custom"`` for one that is not in
    the table."""
    fn = impl.func if isinstance(impl, functools.partial) else impl
    for b, f in _REGISTRY.get(op, {}).items():
        if f is fn:
            return b
    return "custom"


def nbytes_of(x) -> int:
    """Total payload bytes of ``x``: a tensor, or a tree of them (dict,
    list, tuple) summed over its tensor leaves; 0 for anything else (JAX
    :195)."""
    from . import _tree

    return sum(t.numel() * t.element_size() for t in _tree.leaves(x)
               if isinstance(t, torch.Tensor))
