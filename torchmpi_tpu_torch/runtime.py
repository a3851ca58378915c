"""Process-group runtime: init / stop / rank / size / barrier, the world's
named axes and the communicator stack.

The PyTorch counterpart of ``torchmpi_tpu/runtime.py``.  Where the JAX
package builds a device mesh, the port builds one ``torch.distributed``
process group: NCCL when the runtime's device is the card, gloo when the
caller asks for the CPU.  Launched without a launcher (no ``RANK`` /
``WORLD_SIZE`` in the environment and no explicit arguments), the world is
this one process, rendezvousing with itself on a free localhost port.

The world is a grid of named axes, a :class:`Communicator` (the port's
counterpart of a JAX ``Mesh``), in one of two modes, as the JAX package's
world mesh (``runtime._build_world_mesh``):

- ``Config.mesh_shape`` (the N-D world): the dict's axes, major -> minor
  in dict order, a global rank the row-major index of its coordinates.
  At most one size may be -1 (inferred); the sizes must cover the ranks;
  ``mesh_shape`` excludes ``dcn_size`` / ``ici_size``; an empty dict
  raises (JAX's messages).
- Otherwise the two-level grid (``dcn``, ``ici``): ``ici`` the intra-node
  level (NVLink on the card), ``dcn`` the inter-node level (InfiniBand or
  Ethernet), global rank ``d * n_ici + i``, dcn-major.
  ``Config.dcn_size`` / ``Config.ici_size`` set it over the
  ``WORLD_SIZE`` processes.  Unset, ``dcn`` is the node count,
  ``WORLD_SIZE / LOCAL_WORLD_SIZE`` when the launcher sets both and that
  divides, else 1: the JAX package's auto rule (one process per host
  there, one process per card here, so the processes of one node share
  its NVLink).

Each communicator has two views:

- The process world: its member processes (``ranks``, world ranks in
  row-major order) and their sizes per axis.  A world of one process is
  all ones whatever the fields say: they then shape the rank-major stacks
  only.  :func:`init` creates the process groups of every axis and of
  every proper subset of axes with ``dist.new_group``, in one fixed order
  on every rank (``dist.new_group`` deadlocks unless every process calls
  it in the same order); :func:`push_communicator`, which every process
  calls with the same arguments (SPMD, as in JAX), creates those of a new
  communicator, and a re-push of a cached key creates none.
  :func:`group` returns the group of an axis or a tuple of axes,
  :func:`axis_index` / :func:`axis_size` this process's coordinate and
  the extent.
- A rank-major stack of ``n`` ranks on one card: the axes' sizes over n
  (:meth:`Communicator.sizes`), the leading dims of a stack in axis order
  (for example [n_pp, n_dp, n_tp, ...]) or one flat n.  Unset two-level
  fields factor n as ``dcn_size x n // dcn_size`` (unset meaning 1), read
  from the active Config on every call; a size that does not divide ``n``
  raises ValueError with the JAX package's messages.

The calls that span the whole communicator (the rank-major verbs, the
fused syncs, the recipes) read :func:`grid`: the (dcn, ici) sizes where
the communicator's axes are ``("dcn", "ici")``, else one level, (1, n).
The JAX package's selector takes the first axis of any multi-axis mesh as
the outer level; the port keeps two levels for the dcn / ici names only
(ROADMAP queue C).  A sub-stack of one axis, a leg of a two-level verb and
the process world's ring of one member are one-level, since the selector
passes their dcn size (1) down explicitly.

The communicator stack (reference: user-defined communicator splits keyed
by a string, SURVEY.md §1 capability 6): :func:`push_communicator`,
:func:`pop_communicator` and the context manager :func:`communicator`.
The port's names for the JAX package's mesh accessors are
:func:`current_communicator` (``current_mesh``),
:func:`current_communicator_name` (``current_mesh_name``) and
:func:`world_shape` (``world_mesh().shape``); a communicator's "devices"
are process ranks across processes, and ranks of the rank-major stack in
a world of one process.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import socket
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .config import (Config, check_fault_override, check_serving,
                     normalize_obs, ps_timeout_s, resolve_ckpt,
                     resolve_faults, resolve_obs)

Axes = Union[str, Sequence[str], None]
WORLD_AXES = ("dcn", "ici")


class Communicator:
    """A named grid of ranks (the JAX package's ``Mesh``): ``axes`` major
    -> minor; over the process world its member ``ranks`` (world ranks,
    row-major) and their ``proc_sizes``; rank-major, ``spec``, the sizes
    over a stack (one may be -1, inferred), or None for the two-level
    world, factored from the active Config on every call."""

    __slots__ = ("name", "axes", "spec", "ranks", "proc_sizes", "groups",
                 "__weakref__")

    def __init__(self, name: str, axes: Sequence[str],
                 spec: Optional[Sequence[int]], ranks: Sequence[int],
                 proc_sizes: Sequence[int]):
        self.name = name
        self.axes = tuple(axes)
        self.spec = None if spec is None else tuple(int(s) for s in spec)
        self.ranks = tuple(int(r) for r in ranks)
        self.proc_sizes = tuple(int(s) for s in proc_sizes)
        # Axis-index subset -> the groups of that subset, by the flat index
        # of the other axes' coordinates (None: the default group).
        self.groups: Dict[Tuple[int, ...], list] = {}

    def __repr__(self) -> str:
        return (f"Communicator({self.name!r}, axes={self.axes}, "
                f"spec={self.spec}, ranks={len(self.ranks)})")

    @property
    def ident(self) -> tuple:
        """The communicator's value: two pushes that build the same grid of
        the same ranks under one key are one communicator (JAX's ``Mesh``
        compares by value), and the planner keys on it."""
        return self.name, self.axes, self.spec, self.ranks, self.proc_sizes

    def sizes(self, n: Optional[int] = None) -> Tuple[int, ...]:
        """The axes' sizes: over the process world (``n`` None), else over
        a rank-major stack of ``n`` ranks (ValueError where they cannot
        cover it)."""
        if n is None:
            return self.proc_sizes
        if self.spec is None:
            cfg = effective_config()
            return _factor(int(n), cfg.dcn_size, cfg.ici_size)
        return _resolve(self.spec, int(n), self._what())

    def shape(self, n: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> size (JAX's ``mesh.shape``), of the process world or
        of a rank-major stack of ``n``."""
        return dict(zip(self.axes, self.sizes(n)))

    def size(self, n: Optional[int] = None) -> int:
        return int(math.prod(self.sizes(n)))

    def fixed_size(self) -> Optional[int]:
        """The rank-major stack size the spec fixes (no -1), else None."""
        if self.spec is None or -1 in self.spec:
            return None
        return int(math.prod(self.spec))

    def _what(self) -> str:
        shape = dict(zip(self.axes, self.spec))
        return (f"mesh_shape {shape}" if self.name == "world"
                else f"shape {shape}")

    def axis_ids(self, axis: Axes) -> Tuple[int, ...]:
        """The indices of ``axis`` (a name or a sequence of names; None:
        every axis) in this communicator's order."""
        if axis is None:
            return tuple(range(len(self.axes)))
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.axes:
                raise ValueError(f"unknown axis {a!r}: communicator "
                                 f"{self.name!r} has the axes {self.axes}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis named twice in {names}")
        return tuple(sorted(self.axes.index(a) for a in names))

    @property
    def member(self) -> bool:
        """Whether this process is one of the communicator's ranks."""
        return dist.get_rank() in self.ranks


def _resolve(spec: Sequence[int], n: int, what: str) -> Tuple[int, ...]:
    """``spec``'s sizes over ``n`` ranks, its one -1 inferred (JAX
    ``_build_world_mesh`` :91-105)."""
    sizes = list(spec)
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if wild:
        rest = math.prod(s for s in sizes if s != -1)
        if rest == 0 or n % rest != 0:
            raise ValueError(f"{what} cannot be inferred over {n} devices")
        sizes[wild[0]] = n // rest
    if math.prod(sizes) != n:
        raise ValueError(f"{what} does not cover {n} devices")
    return tuple(sizes)


def _mesh_spec(cfg: Config) -> Optional[Tuple[Tuple[str, ...],
                                              Tuple[int, ...]]]:
    """(axes, sizes) of ``cfg.mesh_shape``, checked as JAX checks it at init
    (:84-96), or None for the two-level world."""
    if cfg.mesh_shape is None:
        return None
    if cfg.ici_size is not None or cfg.dcn_size is not None:
        raise ValueError(
            "mesh_shape is mutually exclusive with ici_size/dcn_size "
            "(mesh_shape names its own axes)")
    if not cfg.mesh_shape:
        raise ValueError("mesh_shape must name at least one axis")
    sizes = tuple(int(s) for s in cfg.mesh_shape.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh_shape {cfg.mesh_shape}: at most one "
                         "axis size may be -1")
    return tuple(cfg.mesh_shape), sizes


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.config = Config()
        self.config_epoch = 0
        self.device = torch.device("cpu")
        self.owns_group = False
        # Bottom: the world; pushed communicators above it, and every
        # communicator made, by key.
        self.stack: List[Communicator] = []
        self.cache: Dict[str, Communicator] = {}


_state = _State()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _factor(n: int, dcn: Optional[int], ici: Optional[int]
            ) -> Tuple[int, int]:
    """(dcn, ici) of ``n`` ranks from the topology fields (None = 1 dcn),
    with the JAX package's messages (``_build_world_mesh`` :106-125)."""
    if dcn is None and ici is None:
        dcn = 1
    if dcn is None:
        if n % ici != 0:
            raise ValueError(f"ici_size={ici} does not divide device count "
                             f"{n}")
        dcn = n // ici
    elif ici is None:
        if n % dcn != 0:
            raise ValueError(f"dcn_size={dcn} does not divide device count "
                             f"{n}")
        ici = n // dcn
    if dcn * ici != n:
        raise ValueError(f"mesh shape dcn={dcn} x ici={ici} != device count "
                         f"{n}")
    return dcn, ici


def _world_grid(cfg: Config, world: int) -> Tuple[int, int]:
    """The process world's (dcn, ici): the topology fields, else the node
    count (``WORLD_SIZE / LOCAL_WORLD_SIZE``) when it divides, else 1."""
    if world == 1:
        return 1, 1
    dcn, ici = cfg.dcn_size, cfg.ici_size
    if dcn is None and ici is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
        nodes = world // local if local > 0 and world % local == 0 else 1
        dcn = nodes if nodes > 1 else 1
    return _factor(world, dcn, ici)


def _world_communicator(cfg: Config, world: int) -> Communicator:
    """The world of ``world`` processes under ``cfg`` (its groups not yet
    made)."""
    spec = _mesh_spec(cfg)
    if spec is None:
        return Communicator("world", WORLD_AXES, None, range(world),
                            _world_grid(cfg, world))
    axes, sizes = spec
    proc = ((1,) * len(axes) if world == 1
            else _resolve(sizes, world, f"mesh_shape {cfg.mesh_shape}"))
    return Communicator("world", axes, sizes, range(world), proc)


def _make_groups(comm: Communicator) -> None:
    """Every process creates every group of ``comm``, in the same order:
    for each subset of its axes (by size, then in axis order) spanning
    more than one process, one group per coordinate of the other axes.  A
    group of every world rank in rank order is the default group (None);
    a non-member gets ``dist.GroupMember.NON_GROUP_MEMBER``."""
    comm.groups = {}
    world = dist.get_world_size()
    if world == 1:
        return
    k = len(comm.axes)
    pos = torch.arange(len(comm.ranks)).reshape(comm.proc_sizes)
    everyone = list(range(world))
    for r in range(1, k + 1):
        for sub in itertools.combinations(range(k), r):
            m = math.prod(comm.proc_sizes[a] for a in sub)
            if m == 1:
                continue
            other = [a for a in range(k) if a not in sub]
            rows = pos.permute(*other, *sub).reshape(-1, m).tolist()
            groups = []
            for row in rows:
                members = [comm.ranks[p] for p in row]
                groups.append(None if members == everyone
                              else dist.new_group(members))
            comm.groups[sub] = groups


def _destroy_groups(comm: Communicator) -> None:
    """Destroy the groups :func:`_make_groups` made for ``comm`` (every
    process replaces it at the same push, so every process destroys
    them)."""
    for groups in comm.groups.values():
        for g in groups:
            if g is not None and g != dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(g)
    comm.groups = {}


def init(config: Optional[Config] = None, *, device: str = "cuda",
         init_method: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None, **overrides) -> torch.device:
    """Start the runtime (reference: ``mpi.start``).  Idempotent; returns the
    device this process computes on.

    ``device="cuda"`` (the default) binds the process to card
    ``local_rank()`` and uses NCCL; it raises when no card is visible.
    ``device="cpu"`` uses gloo.  ``init_method`` / ``rank`` / ``world_size``
    default to the launcher's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``), else to a world of one process.  A process
    group that the caller already initialized is adopted as it is."""
    with _state.lock:
        if _state.initialized:
            return _state.device
        cfg = Config.from_env() if config is None else dataclasses.replace(
            config)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        cfg.ps_timeout_s = ps_timeout_s(cfg.ps_timeout_s)
        check_serving(cfg)
        resolve_obs(cfg)
        resolve_faults(cfg)
        resolve_ckpt(cfg)
        # Arm (or disarm a stale) fault layer before the runtime marks
        # itself initialized: a corrupt or missing plan fails init
        # outright (JAX :716-724).  Off never imports faults.
        _configure_faults(cfg)
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "torchmpi_tpu_torch.init(device='cuda'): no CUDA device "
                    "is visible; pass device='cpu' to run on the CPU")
            dev = torch.device("cuda", local_rank())
            torch.cuda.set_device(dev)
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {device!r}")
        owns = False
        if not dist.is_initialized():
            if rank is None:
                rank = int(os.environ.get("RANK", "0"))
            if world_size is None:
                world_size = int(os.environ.get("WORLD_SIZE", "1"))
            if init_method is None:
                if "MASTER_ADDR" in os.environ and world_size > 1:
                    init_method = "env://"
                else:
                    init_method = f"tcp://localhost:{_free_port()}"
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=init_method, rank=rank, world_size=world_size)
            owns = True
        try:
            world = _world_communicator(cfg, dist.get_world_size())
        except ValueError:
            if owns:
                dist.destroy_process_group()
            raise
        _make_groups(world)
        _state.stack = [world]
        _state.cache = {"world": world}
        _state.config = cfg
        _state.device = dev
        _state.owns_group = owns
        _state.initialized = True
        _state.config_epoch += 1
    # Outside the lock: the tuning layer reads the runtime's accessors.
    _configure_tuning(cfg)
    _configure_obs(cfg)
    # Armed after obs, so the monitor's first events land in an armed
    # registry (JAX :762-769).  Off never imports the watchdog.
    _configure_watchdog(cfg)
    return dev


def stop() -> None:
    """Tear down (reference: ``mpi.stop``).  Destroys the process group if
    :func:`init` created it, and drops every collective plan and the
    loaded tuning plan."""
    with _state.lock:
        if _state.initialized and _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _state.initialized = False
        _state.owns_group = False
        _state.stack = []
        _state.cache = {}
        _state.config_epoch += 1
    from . import planner, tuning

    planner.invalidate()
    tuning.reset()


def _configure_faults(cfg: Config) -> None:
    """Arm the fault layer where ``cfg.faults`` asks for it (JAX
    :314-334): a plan that cannot be read raises.  With faults off a
    previous session's layer is disarmed through ``sys.modules`` only:
    turning faults off never imports them."""
    if cfg.faults == "off":
        mod = sys.modules.get(__package__ + ".faults")
        if mod is not None and mod.active():
            mod.deactivate()
        return
    from . import faults

    faults.activate(cfg.faults, retries=cfg.fault_retries,
                    backoff_s=cfg.fault_backoff_s,
                    deadline_s=cfg.fault_deadline_s)


def _configure_watchdog(cfg: Config) -> None:
    """Arm the collective watchdog where ``cfg.watchdog`` asks for it
    (JAX :336-365), its leases in ``watchdog_dir`` (on a re-activation
    with none, the directory the armed watchdog already leases into),
    named by this process's rank.  With the watchdog off a previous
    session's is disarmed through ``sys.modules`` only."""
    if cfg.watchdog == "off":
        mod = sys.modules.get(__package__ + ".watchdog")
        if mod is not None and mod.active():
            mod.deactivate()
        return
    from . import watchdog

    lease_dir = cfg.watchdog_dir
    if lease_dir is None and watchdog.active():
        lease_dir = watchdog.lease_dir()
    watchdog.activate(cfg.watchdog, deadline_s=cfg.watchdog_deadline_s,
                      poll_s=cfg.watchdog_poll_s, lease_dir=lease_dir,
                      rank=dist.get_rank() if dist.is_initialized() else 0)


def _configure_obs(cfg: Config) -> None:
    """Arm the telemetry layer where ``cfg.obs`` asks for it (JAX
    :369-395, :751-757): import and activate it, its dumps in
    ``obs_dir`` (else TORCHMPI_TPU_OBS_DIR, else its default) with a
    ring of ``obs_ring_size`` (a ring left at the default defers to
    TORCHMPI_TPU_OBS_RING), named by this process's rank.  With obs off
    a previous session's telemetry is turned off (its mode, SIGTERM
    handler and exit dump), through ``sys.modules`` only: turning obs off
    never imports it."""
    if cfg.obs == "off":
        mod = sys.modules.get(__package__ + ".obs")
        if mod is not None and mod.active():
            mod.deactivate()
        return
    from . import obs

    out_dir = (cfg.obs_dir or os.environ.get("TORCHMPI_TPU_OBS_DIR")
               or obs.DEFAULT_OUT_DIR)
    ring = int(cfg.obs_ring_size)
    env_ring = os.environ.get("TORCHMPI_TPU_OBS_RING")
    default_ring = next(f.default for f in dataclasses.fields(Config)
                        if f.name == "obs_ring_size")
    if env_ring and ring == default_ring:
        ring = int(env_ring)
    obs.activate(cfg.obs, out_dir=out_dir, ring_size=ring,
                 host=dist.get_rank() if dist.is_initialized() else 0)


def _configure_tuning(cfg: Config) -> None:
    """Load the tuning plans where the config asks for them (JAX
    :864-876): under backend "auto", or with a plan path, which loads
    without "auto" too (the decision log then says it is inactive)."""
    auto = cfg.backend == "auto"
    if auto or cfg.tuning_plan_path is not None:
        from . import tuning

        tuning.configure(cfg.tuning_plan_path, auto_active=auto)


_FAULT_FIELDS = frozenset({"faults", "fault_retries", "fault_backoff_s",
                           "fault_deadline_s"})
_WATCHDOG_FIELDS = frozenset({"watchdog", "watchdog_deadline_s",
                              "watchdog_poll_s", "watchdog_dir"})
_CKPT_FIELDS = frozenset({"ckpt_redundancy", "ckpt_buddies", "ckpt_keep"})


def set_config(**overrides) -> None:
    """Switch knobs of the running runtime (reference: the torchmpi_set_*
    setters; the JAX package's ``set_config``).  Bumps the config epoch
    and drops every collective plan (``collectives.clear_cache``); a
    config that opts into the tuning plans (re)loads them (an unchanged
    path keeps the in-memory entries, JAX :1067-1080).  The process
    world's grid stays the one :func:`init` built; a new ``dcn_size`` /
    ``ici_size`` factors the rank-major stacks from here on.  The world's
    axes are fixed at init: ``mesh_shape`` raises here, and so do
    ``dcn_size`` / ``ici_size`` under it."""
    with _state.lock:
        _require_init()
        for k in overrides:
            if not hasattr(_state.config, k):
                raise ValueError(f"unknown config field {k!r}")
        if "mesh_shape" in overrides or (
                _state.config.mesh_shape is not None
                and {"dcn_size", "ici_size"} & set(overrides)):
            raise ValueError("the world's axes (mesh_shape) are fixed at "
                             "init: stop() and init() again to change them")
        if "ps_timeout_s" in overrides:
            overrides["ps_timeout_s"] = ps_timeout_s(overrides["ps_timeout_s"])
        if "obs" in overrides:
            mode = normalize_obs(overrides["obs"])
            if mode is None:
                raise ValueError("config.obs must be off|metrics|trace")
            overrides["obs"] = mode
        for k in _FAULT_FIELDS | _WATCHDOG_FIELDS | _CKPT_FIELDS:
            if k in overrides:
                overrides[k] = check_fault_override(k, overrides[k])
        new = dataclasses.replace(_state.config, **overrides)
        check_serving(new)
        _state.config = new
        _state.config_epoch += 1
    from . import collectives

    collectives.clear_cache()
    _configure_tuning(_state.config)
    if _FAULT_FIELDS & set(overrides):
        _configure_faults(_state.config)
    if {"obs", "obs_dir", "obs_ring_size"} & set(overrides):
        _configure_obs(_state.config)
    if _WATCHDOG_FIELDS & set(overrides):
        _configure_watchdog(_state.config)


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> None:
    if not _state.initialized:
        raise RuntimeError(
            "torchmpi_tpu_torch runtime not initialized; call "
            "torchmpi_tpu_torch.init() first")


def config() -> Config:
    return _state.config


def device() -> torch.device:
    _require_init()
    return _state.device


def backend_name() -> str:
    """The process group's backend ("nccl" or "gloo")."""
    _require_init()
    return dist.get_backend()


def config_epoch() -> int:
    """Monotonic counter of configuration changes (init, set_config and
    stop bump it)."""
    return _state.config_epoch


def effective_config() -> Config:
    """The active Config when the runtime is initialized, else defaults:
    knob reads from code that may run outside ``init()`` (direct kernel
    calls, tests) resolve identically everywhere."""
    return _state.config if _state.initialized else Config()


def rank() -> int:
    """Process rank (reference: ``mpi.rank()``)."""
    _require_init()
    return dist.get_rank()


def size() -> int:
    """Process count (reference: ``mpi.size()``)."""
    _require_init()
    return dist.get_world_size()


def grid(n: Optional[int] = None) -> Tuple[int, int]:
    """(n_dcn, n_ici) of the calls that span the current communicator: of
    its rank-major stack of ``n`` ranks (the two-level world's from the
    active Config's ``dcn_size`` / ``ici_size``, unset: (1, n)); of the
    process world when ``n`` is None.  Two levels where the communicator's
    axes are ("dcn", "ici"), else (1, size).  The selector and the recipes
    read it for the calls that span the world, and pass the dcn size down
    to the two-level routes (``selector.TWO_LEVEL``)."""
    if n is None:
        _require_init()
    comm = _current_or_default()
    if n is not None and comm.axes != WORLD_AXES:
        return 1, int(n)
    sizes = comm.sizes(n)
    if comm.axes == WORLD_AXES:
        return sizes[0], sizes[1]
    return 1, int(math.prod(sizes))


def dcn_size() -> int:
    """The process world's outer (inter-node) size."""
    return grid()[0]


def ici_size() -> int:
    """The process world's inner (intra-node) size."""
    return grid()[1]


# --- the communicator stack --------------------------------------------------


_DEFAULT = Communicator("world", WORLD_AXES, None, [0], (1, 1))


def _current_or_default() -> Communicator:
    """The current communicator; before :func:`init`, the two-level world
    of one process (rank-major stacks factored by the default Config)."""
    return _state.stack[-1] if _state.initialized else _DEFAULT


def world_communicator() -> Communicator:
    _require_init()
    return _state.stack[0]


def current_communicator() -> Communicator:
    """The innermost pushed communicator (JAX ``current_mesh``): the one
    the collectives resolve their axes against."""
    _require_init()
    return _state.stack[-1]


def current_communicator_name() -> str:
    """JAX ``current_mesh_name``."""
    return current_communicator().name


def world_shape(n: Optional[int] = None) -> Dict[str, int]:
    """The world's axis -> size (JAX ``world_mesh().shape``): of the
    process world, or of a rank-major stack of ``n`` ranks."""
    return world_communicator().shape(n)


def push_communicator(key: str, *, devices: Optional[Sequence[int]] = None,
                      shape: Optional[Dict[str, int]] = None
                      ) -> Communicator:
    """Push a named communicator scope (JAX :1244; reference: user-defined
    communicator splits keyed by a string, SURVEY.md §1 capability 6).

    - ``devices``: the ranks of the new communicator, one axis named
      ``ici``, or with ``shape`` reshaped into its named axes: world ranks
      across processes; in a world of one process, ranks of the current
      communicator's rank-major stack.
    - ``shape``: axis name -> size over the current communicator's ranks,
      or over ``devices`` when given.
    - Neither: re-push of the communicator cached under ``key`` (KeyError
      if there is none); it creates no group.

    Every process calls it with the same arguments (the groups are made
    here, in the same order on every process).  Communicators are cached
    by key, as the reference cached its communicators per split string: a
    push that builds the cached communicator again (the same axes, sizes
    and ranks) takes the cached one and creates no group; one that builds
    another replaces it, and the replaced one's groups are destroyed
    unless it is still on the stack."""
    _require_init()
    with _state.lock:
        old = _state.cache.get(key)
        if devices is None and shape is None:
            if old is None:
                raise KeyError(f"no cached communicator {key!r}")
            comm = old
        else:
            comm = _new_communicator(key, devices, shape)
            if old is not None and old.ident == comm.ident:
                comm = old
            else:
                _make_groups(comm)
                if old is not None and not any(c is old
                                               for c in _state.stack):
                    _destroy_groups(old)
                _state.cache[key] = comm
        _state.stack.append(comm)
        return comm


def _new_communicator(key: str, devices, shape) -> Communicator:
    cur = _state.stack[-1]
    world = dist.get_world_size()
    axes = ("ici",) if shape is None else tuple(shape)
    sizes = None if shape is None else tuple(int(s) for s in
                                             shape.values())
    if devices is not None:
        devs = [int(d) for d in devices]
        if not devs or len(set(devs)) != len(devs):
            raise ValueError(f"devices must be distinct ranks, got {devs}")
        bound = world if world > 1 else cur.fixed_size()
        if bound is not None and not all(0 <= d < bound for d in devs):
            raise ValueError(f"devices {devs} are not ranks of the current "
                             f"communicator {cur.name!r} ({bound} ranks)")
        count = len(devs)
        ranks = devs if world > 1 else [0]
    else:
        count = math.prod(sizes)
        if world > 1:
            ranks = list(cur.ranks)
            count = len(ranks)
        else:
            ranks = [0]
            fixed = cur.fixed_size()
            if fixed is not None:
                count = fixed
            else:
                cur.sizes(count)  # the current spec must cover it
    if sizes is None:
        sizes = (count,)
    if math.prod(sizes) != count:
        raise ValueError(f"shape {shape} does not cover {count} devices")
    proc = sizes if world > 1 else (1,) * len(sizes)
    return Communicator(key, axes, sizes, ranks, proc)


def pop_communicator() -> None:
    _require_init()
    with _state.lock:
        if len(_state.stack) <= 1:
            raise RuntimeError("cannot pop the world communicator")
        _state.stack.pop()


class communicator:
    """Context manager: ``with runtime.communicator("half", shape={...}):``
    pushes on entry, pops on exit."""

    def __init__(self, key: str, **kw) -> None:
        self._key = key
        self._kw = kw

    def __enter__(self) -> Communicator:
        return push_communicator(self._key, **self._kw)

    def __exit__(self, *exc) -> None:
        pop_communicator()
        return None


def axes_of(axis: Axes) -> Tuple[str, ...]:
    """``axis`` (a name, a sequence of names, or None for every axis) as
    the current communicator's axis names in its order; ValueError for an
    axis it lacks."""
    comm = _current_or_default()
    return tuple(comm.axes[i] for i in comm.axis_ids(axis))


def axis_size(axis: Axes = None, n: Optional[int] = None) -> int:
    """The extent of ``axis`` (None: the whole communicator) in the
    current communicator: over the process world, or over a rank-major
    stack of ``n`` ranks."""
    if n is None:
        _require_init()
    comm = _current_or_default()
    sizes = comm.sizes(n)
    return int(math.prod(sizes[i] for i in comm.axis_ids(axis)))


def _coords() -> Tuple[int, ...]:
    """This process's coordinates in the current communicator."""
    comm = current_communicator()
    me = dist.get_rank()
    if me not in comm.ranks:
        raise RuntimeError(f"rank {me} is not a member of communicator "
                           f"{comm.name!r} (ranks {list(comm.ranks)})")
    p = comm.ranks.index(me)
    out = []
    for s in reversed(comm.proc_sizes):
        out.append(p % s)
        p //= s
    return tuple(reversed(out))


def axis_index(axis: Axes) -> int:
    """This process's index along ``axis`` (a name, or a tuple of names:
    the row-major index of its coordinates on them) in the current
    communicator."""
    _require_init()
    comm = current_communicator()
    ids = comm.axis_ids(axis)
    c = _coords()
    idx = 0
    for i in ids:
        idx = idx * comm.proc_sizes[i] + c[i]
    return idx


def group(axis: Axes = None):
    """The process group of ``axis`` (a name or a tuple of names; None: the
    whole current communicator) that holds this process: the ranks that
    share its coordinates on the other axes.  None is the world's default
    group; an axis of one process also gives None, meaning this process
    alone (callers compute locally)."""
    _require_init()
    comm = current_communicator()
    ids = comm.axis_ids(axis)
    c = _coords()
    groups = comm.groups.get(ids)
    if groups is None:
        return None
    other = [i for i in range(len(comm.axes)) if i not in ids]
    idx = 0
    for i in other:
        idx = idx * comm.proc_sizes[i] + c[i]
    return groups[idx]


def local_rank() -> int:
    """Rank among the processes of this host: the launcher's ``LOCAL_RANK``
    (or the JAX package's ``TORCHMPI_TPU_LOCAL_RANK``), else 0."""
    v = os.environ.get("LOCAL_RANK",
                       os.environ.get("TORCHMPI_TPU_LOCAL_RANK"))
    return int(v) if v is not None else 0


def barrier(name: str = "torchmpi_tpu_barrier") -> None:
    """Global barrier (reference: ``mpi.barrier()``).  With obs on, its
    start is recorded before the wait (a host stuck in it shows it as its
    last flight event) and its completion after (JAX :1131-1178).  With
    faults armed it is the ``runtime.barrier`` site (an arrival an
    attempt, the sync under ``fault_deadline_s``); with the watchdog
    armed its wait is an in-flight window."""
    _require_init()
    cfg = _state.config
    obs_on = cfg.obs != "off"
    if obs_on:
        from . import obs

        obs.record_barrier(name)
    wd = None
    wd_tok = -1
    if cfg.watchdog != "off":
        # A barrier the gang never completes is flagged within the
        # deadline, and a deferred break of a stalled background wait is
        # delivered here, before this process commits to another wait.
        from . import watchdog as wd

        wd.raise_pending()
        wd_tok = wd.begin("runtime.barrier", op=name, peer="gang")

    def _sync():
        if _state.device.type == "cuda":
            dist.barrier(device_ids=[_state.device.index])
        else:
            dist.barrier()

    try:
        if cfg.faults != "off":
            from . import faults

            # Injection fires once an attempt and the sync runs under
            # the site deadline: a wedged peer is a PeerTimeoutError.
            faults.guarded_barrier(name, _sync)
        else:
            _sync()
    finally:
        if wd is not None:
            wd.end(wd_tok)
    if obs_on:
        obs.record_barrier_done(name)
