"""CollectivePlan: one cached planner for the whole dispatch path.

The PyTorch counterpart of ``torchmpi_tpu/planner.py``.  TorchMPI's core
performance trick was a *resource cache* (SURVEY.md §8.4.5): plan a
collective once (buffers, communicator, algorithm) and replay the plan on
every later call.  Without it every call re-derives its route: the
selector's rules (Config read, size cutover, topology degradation), the
tuning plan's lookup, the fused layout (``FusedSpec``) of a gradient list.

This module keeps the decision record of a call site in an immutable
:class:`CollectivePlan`, computed once per key and replayed thereafter:

- **key**: ``(kind, op, tree structure with each leaf's shape, dtype and
  device, the grid or the axis, the backend, the static params, config
  epoch, selector generation)``.  Two calls with the same structure and
  other values share a plan; a ``set_config`` (the epoch), a new grid
  (``dcn_size`` / ``ici_size``, through the epoch), a re-registered
  implementation (the generation) or :func:`invalidate` miss and re-plan.
- **record**: the fused layout (``spec``), the resolved implementation
  per bucket (``impls``; ``"auto"`` measured on a plan miss of the tuning
  DB, ``tuning.resolve_eager``), ``staged``, ``topology``, ``nbytes`` and
  ``build_seconds``.  ``obs``, ``faults``, ``guard``, ``watchdog`` (False)
  and ``analysis`` ("off") are the JAX record's fields; those layers are
  not ported (ROADMAP queue A, items 10 and 11).
- **replay**: one dict lookup, then the bound closure.

Consumers: the rank-major verbs (``collectives._eager``, also under
``async_``), the process-world and in-axis verbs (``collectives._world``,
``_tree_in_axis``, ``async_in_axis``), the fused gradient syncs
(``fusion.fused_``, ``fused_allreduce_rank_major_``,
``gradsync.synchronize_gradients(_rank_major)``), the overlap schedule
(``gradsync.make_overlapped_grad_fn(_rank_major)``) and ZeRO's shard
layout (``zero.flat_spec``).  Invalidation has ONE point,
:func:`invalidate` (``collectives.clear_cache``; ``runtime.set_config``
and ``runtime.stop`` route there).  :func:`set_enabled` ``(False)`` runs
the unplanned path, the baseline the tests compare bit for bit.  The JAX
package's ``plan_serving_replica`` (a plan per TP serving replica's mesh)
waits for the TP serving replicas of ROADMAP queue A, item 9 (b).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import _tree, fusion, runtime, selector
from .tuning import fingerprint

_lock = threading.RLock()
_table: Dict[tuple, "CollectivePlan"] = {}
_enabled = True
_stats = {"hits": 0, "misses": 0, "invalidations": 0}


class CollectivePlan:
    """Immutable decision record for one collective dispatch site.

    Built once by the ``plan_*`` functions below, then replayed; the
    fields are assigned at construction and never mutated afterwards
    (``hits`` is the one bookkeeping exception).  Decision-only plans
    (kinds ``overlap`` / ``flatspec``) carry no closure and are read
    through ``spec`` / ``impls`` / ``extra``."""

    __slots__ = ("key", "kind", "op", "backend", "nbytes", "spec", "impls",
                 "backends", "extra", "staged", "obs", "faults", "guard",
                 "watchdog", "analysis", "epoch", "topology",
                 "build_seconds", "hits", "_replay")

    def __init__(self, key: tuple, kind: str, op: str, *,
                 backend: str = "", nbytes: int = 0,
                 spec: Optional[fusion.FusedSpec] = None,
                 impls: Optional[List[Callable]] = None,
                 impl_op: Optional[str] = None,
                 extra: Optional[dict] = None, staged: bool = False,
                 topology: str = "",
                 replay: Optional[Callable] = None) -> None:
        self.key = key
        self.kind = kind
        self.op = op
        self.nbytes = int(nbytes)
        self.spec = spec
        self.impls = impls
        # The backend each implementation was registered under, in bucket
        # order: what the plan replays, by name.
        self.backends = ([None if f is None else
                          selector.name_of(impl_op or op, f) for f in impls]
                         if impls is not None else [])
        self.backend = backend or _label(self.backends)
        self.extra = extra or {}
        self.staged = bool(staged)
        self.obs = self.faults = self.guard = self.watchdog = False
        self.analysis = "off"
        self.epoch = runtime.config_epoch()
        self.topology = topology
        self.build_seconds = 0.0
        self.hits = 0
        self._replay = replay

    def replay(self, *args, **kw):
        """Execute the planned dispatch for one same-structure input."""
        return self._replay(*args, **kw)

    def describe(self) -> dict:
        """JSON-ready row (the JAX package's ``plan_tool.py dump-live``
        row, plus ``backends``: each bucket's)."""
        return {
            "kind": self.kind, "op": self.op, "backend": self.backend,
            "backends": list(self.backends), "nbytes": self.nbytes,
            "launches": (len(self.impls) if self.impls
                         else (self.spec.n_launches
                               if self.spec is not None else 1)),
            "staged": self.staged, "obs": self.obs, "faults": self.faults,
            "guard": self.guard, "watchdog": self.watchdog,
            "analysis": self.analysis, "epoch": self.epoch,
            "topology": self.topology,
            "build_ms": round(self.build_seconds * 1e3, 3),
            "hits": self.hits,
        }


def _label(backends: Sequence[Optional[str]]) -> str:
    """A plan row's backend: the one every bucket resolved to, else the
    first bucket's + "+" (mixed), "" for none."""
    names = [b for b in backends if b is not None]
    if not names:
        return ""
    return names[0] if len(set(names)) == 1 else names[0] + "+"


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Switch the planner off (the unplanned dispatch path runs instead)
    or back on.  For the bit-identity tests and the host-cost comparison;
    production code leaves it on.  Returns the previous value."""
    global _enabled
    prev, _enabled = _enabled, bool(flag)
    return prev


def invalidate() -> None:
    """THE invalidation point: drop every plan.  Clears in place, so
    aliases of the table stay live."""
    with _lock:
        _table.clear()
        _stats["invalidations"] += 1


def stats() -> dict:
    """Cumulative ``hits`` / ``misses`` / ``invalidations`` (process-level:
    they survive :func:`invalidate`) and the live ``entries``."""
    return dict(_stats, entries=len(_table))


def reset_stats() -> None:
    _stats["hits"] = 0
    _stats["misses"] = 0
    _stats["invalidations"] = 0


def describe() -> List[dict]:
    """One JSON-ready row per live plan."""
    with _lock:
        return [p.describe() for p in _table.values()]


# ---------------------------------------------------------------------------
# Shared lookup / build plumbing
# ---------------------------------------------------------------------------


def _lookup(key: tuple) -> Optional[CollectivePlan]:
    plan = _table.get(key)
    if plan is not None:
        _stats["hits"] += 1
        plan.hits += 1
    return plan


def _get_or_build(key: tuple, builder: Callable[[], CollectivePlan]
                  ) -> CollectivePlan:
    """Lock-free hit, else build and insert under the planner lock.
    Builds are serialized (a build can measure ``"auto"`` candidates, which
    plans them recursively, hence the re-entrant lock); the steady state
    never takes the lock."""
    plan = _lookup(key)
    if plan is not None:
        return plan
    with _lock:
        plan = _lookup(key)
        if plan is not None:
            return plan
        t0 = time.monotonic()
        plan = builder()
        plan.build_seconds = time.monotonic() - t0
        _table[key] = plan
        _stats["misses"] += 1
    return plan


def _epoch() -> tuple:
    """The staleness part of every key: the config epoch (init, set_config
    and stop bump it; the grid follows the Config), the selector's
    registry generation and the current communicator (JAX keys on the
    mesh: a push plans its calls anew, and the world's plans hit again
    after the pop), by its value (``Communicator.ident``): an identical
    re-push hits, and no plan holds a communicator."""
    comm = (runtime.current_communicator().ident
            if runtime.is_initialized() else None)
    return (runtime.config_epoch(), selector.generation(), comm)


def _params_key(params: dict) -> tuple:
    return tuple(sorted(params.items()))


def _avals(leaves) -> Optional[tuple]:
    """Hashable (shape, dtype, device) of each leaf, or None when a leaf
    is not a tensor (a Python number): unplannable."""
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        return None
    return tuple((t.shape, t.dtype, t.device) for t in leaves)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _once(make: Callable) -> Callable:
    """A thunk that calls ``make`` on its first call and keeps the result:
    a measurement's input, made only if ``"auto"`` measures."""
    held = []

    def get():
        if not held:
            held.append(make())
        return held[0]

    return get


def resolve(op: str, backend: Optional[str], *, nbytes: int, dtype,
            grid, axes=None, ranks: Optional[int] = None,
            n_dcn: Optional[int] = None,
            runner: Optional[Callable[[str], object]] = None) -> Callable:
    """The implementation of selector op ``op`` for one call or bucket of
    one rank's ``nbytes``: where the backend (per call, else the Config's)
    is ``"auto"`` and a ``runner`` is given, a miss of the tuning DB is
    measured first (``tuning.resolve_eager``: ``runner(b)`` runs the call
    out of place under backend b); then the selector's rules.  Across
    more than one process the plans are read-only, and the selector
    reads them."""
    eff = (backend if backend is not None
           else selector.config_backend(runtime.effective_config()))
    if (eff == "auto" and runner is not None
            and (op.endswith("_rank_major") or not runtime.is_initialized()
                 or runtime.size() == 1)):
        from . import tuning

        measured = tuning.resolve_eager(selector.verb_of(op), nbytes, dtype,
                                        grid, runner, impl_op=op, axes=axes)
        if measured is not None:
            backend = measured
    return selector.select(op, backend, nbytes=nbytes, ranks=ranks,
                           n_dcn=n_dcn, dtype=dtype, grid=grid, axes=axes)


# ---------------------------------------------------------------------------
# Rank-major verbs (collectives._eager; async_ rides it)
# ---------------------------------------------------------------------------


def plan_for(verb: str, xs: torch.Tensor, backend: Optional[str],
             staged: Optional[bool], params: dict, axis: Optional[str],
             n_dcn: Optional[int]) -> CollectivePlan:
    """Plan (or replay-hit) one rank-major call of ``verb`` on ``xs``
    [n, ...]; ``replay(xs)`` takes any stack of the same shape, dtype and
    device."""
    key = ("eager", verb, xs.shape, xs.dtype, xs.device, backend, staged,
           _params_key(params), axis, n_dcn, _epoch())
    return _get_or_build(key, lambda: _build_eager(
        key, verb, xs, backend, staged, params, axis, n_dcn))


def _build_eager(key, verb, xs, backend, staged, params, axis,
                 n_dcn) -> CollectivePlan:
    from . import collectives as C

    n = xs.shape[0]
    nbytes = _nbytes(xs[0])
    full = selector.grid_of(n, xs.device, n_dcn if axis is None else None)
    topo = fingerprint.topology(full, axes=C._axes_tuple(axis))
    if C._staged_requested(backend, staged):
        def _replay(x):
            return C._eager_unplanned(verb, x, backend, staged, params,
                                      axis, n_dcn)

        return CollectivePlan(key, "eager-staged", verb, backend="host",
                              nbytes=nbytes, staged=True, topology=topo,
                              replay=_replay)

    def runner(b):
        return C._eager_unplanned(verb, xs, b, False, params, axis, n_dcn)

    op = f"{verb}_rank_major"
    if axis is None:
        impl = resolve(op, backend, nbytes=nbytes, dtype=xs.dtype,
                       grid=full, ranks=n, n_dcn=n_dcn, runner=runner)

        def _replay(x):
            return impl(x, **params)
    else:
        # Each group of one axis is a one-level stack.
        m = runtime.axis_size(axis, n)
        impl = resolve(op, backend, nbytes=nbytes, dtype=xs.dtype,
                       grid=full, axes=C._axes_tuple(axis), ranks=m,
                       n_dcn=1, runner=runner)

        def _replay(x):
            v = C._axis_view(x, axis)
            return C._from_axis_view(torch.stack(
                [impl(v[g], **params) for g in range(v.shape[0])]), axis)

    return CollectivePlan(key, "eager", verb, nbytes=nbytes, impls=[impl],
                          impl_op=op, topology=topo, replay=_replay)


# ---------------------------------------------------------------------------
# Process-world and in-axis verbs (collectives._world / _tree_in_axis)
# ---------------------------------------------------------------------------


def _world_fp(x: torch.Tensor, axis):
    from . import collectives as C

    return selector.grid_of(None, x.device), C._axes_tuple(axis)


def plan_world(verb: str, x: torch.Tensor, backend: Optional[str],
               params: dict, axis: Optional[str]) -> CollectivePlan:
    """Plan one process-world call of ``verb`` on this rank's ``x`` (over
    the world, or over ``axis``'s subgroup); ``replay(x, async_op=False,
    owned=False)`` is ``collectives._world_run`` on the bound
    implementation."""
    key = ("world", verb, x.shape, x.dtype, x.device, backend,
           _params_key(params), axis, _epoch())

    def build():
        from . import collectives as C

        grid, axes = _world_fp(x, axis)
        impl = resolve(verb, backend, nbytes=_nbytes(x), dtype=x.dtype,
                       grid=grid, axes=axes,
                       n_dcn=None if axis is None else 1,
                       runner=lambda b: fusion.run_bucket(
                           verb, x, params, backend=b, axis=axis))

        def _replay(x, async_op=False, owned=False):
            return C._world_run(verb, impl, x, params, async_op=async_op,
                                axis=axis, owned=owned)

        return CollectivePlan(key, "world", verb, nbytes=_nbytes(x),
                              impls=[impl],
                              topology=fingerprint.topology(grid, axes=axes),
                              replay=_replay)

    return _get_or_build(key, build)


def plan_in_axis(verb: str, tree, backend: Optional[str], params: dict,
                 axis: Optional[str]) -> Optional[CollectivePlan]:
    """Plan one in-axis call of ``verb`` on a tree of this rank's tensors,
    or None where a leaf is not a tensor (the unplanned path then runs).
    The record holds the fused layout (``fusion.elementwise_spec`` /
    ``reduce_scatter_spec``) and each bucket's (or leaf's)
    implementation."""
    leaves, treedef = _tree.flatten(tree)
    avals = _avals(leaves)
    if not leaves or avals is None:
        return None
    key = ("in_axis", verb, treedef, avals, backend, _params_key(params),
           axis, _epoch())
    return _get_or_build(key, lambda: _build_in_axis(
        key, verb, leaves, treedef, backend, params, axis))


def _build_in_axis(key, verb, leaves, treedef, backend, params,
                   axis) -> CollectivePlan:
    grid, axes = _world_fp(leaves[0], axis)
    n_dcn = None if axis is None else 1
    topo = fingerprint.topology(grid, axes=axes)
    nbytes = selector.nbytes_of(leaves)

    def pick(nbytes, dtype, make_buf):
        buf = _once(make_buf)
        return resolve(verb, backend, nbytes=nbytes, dtype=dtype, grid=grid,
                       axes=axes, n_dcn=n_dcn,
                       runner=lambda b: fusion.run_bucket(
                           verb, buf(), params, backend=b, axis=axis))

    spec = None
    if verb in fusion.ELEMENTWISE_OPS:
        spec = fusion.elementwise_spec(verb, leaves)
        if spec is not None:
            impls = [pick((hi - lo) * _itemsize(g.dtype), g.dtype,
                          lambda g=g, lo=lo, hi=hi:
                          fusion.group_flat(leaves, g)[lo:hi])
                     for g in spec.groups for lo, hi in g.bounds]

            def _replay(tree):
                return fusion.fuse_tree(verb, tree, spec=spec, impls=impls,
                                        backend=backend, axis=axis,
                                        **params)
    elif verb == "reduce_scatter":
        n = runtime.axis_size(axis)
        spec = fusion.reduce_scatter_spec(leaves, n)
        if spec is not None:
            impls = [pick(sum(g.sizes[pos] for pos in bucket)
                          * _itemsize(g.dtype), g.dtype,
                          lambda g=g, bucket=bucket:
                          fusion.tile_bucket(leaves, g, bucket, n))
                     for g in spec.groups for bucket in g.leaf_buckets]

            def _replay(tree):
                return fusion.fused_reduce_scatter(
                    tree, spec=spec, n=n, impls=impls, backend=backend,
                    axis=axis, **params)
    if spec is None:
        impls = [pick(_nbytes(t), t.dtype, lambda t=t: t) for t in leaves]

        def _replay(tree):
            return _tree.unflatten(treedef, [
                fusion.run_bucket(verb, t, params, impl=f, axis=axis)
                for f, t in zip(impls, _tree.leaves(tree))])

    return CollectivePlan(key, "in_axis-fused" if spec is not None
                          else "in_axis", verb, nbytes=nbytes, spec=spec,
                          impls=impls, topology=topo, replay=_replay)


# ---------------------------------------------------------------------------
# Fused gradient syncs (fusion.fused_, fused_allreduce_rank_major_,
# gradsync.synchronize_gradients(_rank_major))
# ---------------------------------------------------------------------------


def plan_gradsync(tensors: Sequence[torch.Tensor], *, n_buckets: int,
                  backend: Optional[str], barrier: bool = False,
                  rank_major: bool = False, verb: str = "allreduce",
                  **params) -> CollectivePlan:
    """Plan the fused ``verb`` (allreduce, or broadcast across processes)
    of a tensor list in place: the ``FusedSpec`` (count-driven for
    ``n_buckets`` > 1, else ``Config.fuse_max_bytes``-bounded) of one
    rank's tensors and each bucket's implementation, measured on the
    call's own buckets under ``"auto"``.  ``rank_major``: ``tensors[i]``
    is the [n, ...] stack of tensor i.  ``replay(tensors)`` returns the
    launch count."""
    key = ("gradsync", verb, _avals(tensors), bool(rank_major),
           int(n_buckets), backend, bool(barrier), _params_key(params),
           _epoch())
    return _get_or_build(key, lambda: _build_gradsync(
        key, list(tensors), n_buckets, backend, rank_major, verb, params))


def _build_gradsync(key, tensors, n_buckets, backend, rank_major, verb,
                    params) -> CollectivePlan:
    sample = [t[0] for t in tensors] if rank_major else tensors
    spec = (fusion.FusedSpec(sample, n_buckets=n_buckets) if n_buckets > 1
            else fusion.FusedSpec(sample))
    if rank_major:
        n = tensors[0].shape[0]
        op = f"{verb}_rank_major"
        grid, ranks = selector.grid_of(n, tensors[0].device), n
    else:
        op, ranks = verb, None
        grid = selector.grid_of(None, tensors[0].device)
    impls = []
    for g in spec.groups:
        for lo, hi in g.bounds:
            if lo == hi:
                impls.append(None)  # a group of empty tensors: no launch
                continue
            nbytes = (hi - lo) * _itemsize(g.dtype)

            buf = _once(lambda g=g, lo=lo, hi=hi: fusion.gather_bucket(
                tensors, g, lo, hi, rank_major=rank_major))
            impls.append(resolve(
                op, backend, nbytes=nbytes, dtype=g.dtype, grid=grid,
                ranks=ranks, runner=lambda b, buf=buf: fusion.run_bucket(
                    op, buf(), params, backend=b)))
    fused = (fusion.fused_allreduce_rank_major_ if rank_major
             else lambda ts, **kw: fusion.fused_(verb, ts, **kw))

    def _replay(ts):
        return fused(ts, spec=spec, impls=impls, **params)

    return CollectivePlan(
        key, "gradsync", verb, backend=backend or "",
        nbytes=selector.nbytes_of(sample), spec=spec, impls=impls,
        impl_op=op, topology=fingerprint.topology(grid), replay=_replay)


# ---------------------------------------------------------------------------
# The backprop-overlap schedule (gradsync.make_overlapped_grad_fn(_rank_major))
# ---------------------------------------------------------------------------


def plan_overlap(template: Sequence[torch.Tensor], *, n: Optional[int],
                 op: str, backend: Optional[str], compress: Optional[str],
                 max_bytes: int,
                 dcn_codec: Optional[str] = None) -> CollectivePlan:
    """Decision-only plan of the overlap schedule: the reverse-order bucket
    assignment (``extra["firing"]``, and ``extra["groups"]``, each
    bucket's ``fusion.bucket_group``) and each bucket's pre-picked
    allreduce (``impls``, in firing order; rank-major stacks of ``n``, or
    the process world for None).  ``"auto"`` is measured here, on zeros of
    each bucket's wire shape.  With ``dcn_codec`` (error feedback) the
    buckets run the fixed two-level schedule and no implementation is
    picked."""
    key = ("overlap", _avals(template), n, op, backend, compress,
           int(max_bytes), dcn_codec, _epoch())

    def build():
        from .parallel import gradsync

        firing = gradsync.assign_overlap_buckets(template, max_bytes)
        groups = [fusion.bucket_group(template, b) for b in firing]
        dev = template[0].device
        vop = "allreduce" if n is None else "allreduce_rank_major"
        grid = selector.grid_of(n, dev)
        impls: List[Optional[Callable]] = []
        for g in groups:
            if dcn_codec is not None:
                impls.append(None)
                continue
            wire = torch.bfloat16 if compress == "bf16" else g.dtype
            shape = (g.total,) if n is None else (n, g.total)
            nbytes = g.total * _itemsize(wire)

            buf = _once(lambda shape=shape, wire=wire: torch.zeros(
                shape, dtype=wire, device=dev))
            impls.append(resolve(
                vop, backend, nbytes=nbytes, dtype=wire, grid=grid, ranks=n,
                runner=None if dev.type == "meta"
                else lambda b, buf=buf: fusion.run_bucket(
                    vop, buf(), {"op": op}, backend=b)))
        return CollectivePlan(
            key, "overlap", "allreduce",
            backend=f"dcn-{dcn_codec}" if dcn_codec else (backend or ""),
            nbytes=selector.nbytes_of(template), impls=impls,
            impl_op=vop, topology=fingerprint.topology(grid)
            if grid is not None else "",
            extra={"firing": firing, "groups": groups,
                   "max_bytes": int(max_bytes)})

    return _get_or_build(key, build)


# ---------------------------------------------------------------------------
# ZeRO's shard layout (zero.flat_spec)
# ---------------------------------------------------------------------------


def flat_spec_for(tensors: Sequence[torch.Tensor],
                  n_shards: int) -> fusion.FusedSpec:
    """The cached ``FusedSpec(tensors, n_shards, max_bytes=0)``, ZeRO's
    flatten / pad / shard layout, for ``(shapes and dtypes, n_shards)``.
    Config-independent: no epoch in the key."""
    tensors = list(tensors)
    if not _enabled:
        return fusion.FusedSpec(tensors, int(n_shards), max_bytes=0)
    key = ("flatspec", tuple((t.shape, t.dtype) for t in tensors),
           int(n_shards))

    def build():
        spec = fusion.FusedSpec(tensors, int(n_shards), max_bytes=0)
        return CollectivePlan(key, "flatspec", "flatten",
                              nbytes=selector.nbytes_of(tensors),
                              spec=spec, extra={"n_shards": int(n_shards)})

    return _get_or_build(key, build).spec
