"""Process-group runtime: init / stop / rank / size / barrier.

The PyTorch counterpart of ``torchmpi_tpu/runtime.py``.  Where the JAX
package builds a device mesh, the port builds one ``torch.distributed``
process group: NCCL when the runtime's device is the card, gloo when the
caller asks for the CPU.  Launched without a launcher (no ``RANK`` /
``WORLD_SIZE`` in the environment and no explicit arguments), the world is
this one process, rendezvousing with itself on a free localhost port.

The world is a two-level grid (``dcn``, ``ici``), as the JAX package's
world mesh (``runtime._build_world_mesh``, ``WORLD_AXES``): ``ici`` the
intra-node level (NVLink on the card), ``dcn`` the inter-node level
(InfiniBand or Ethernet), global rank ``d * n_ici + i``, dcn-major.

- The process world: ``Config.dcn_size`` / ``Config.ici_size`` set the grid
  over the ``WORLD_SIZE`` processes.  Unset, ``dcn`` is the node count,
  ``WORLD_SIZE / LOCAL_WORLD_SIZE`` when the launcher sets both and that
  divides, else 1: the JAX package's auto rule (one process per host
  there, one process per card here, so the processes of one node share
  its NVLink).  A world of one process is the grid (1, 1) whatever the
  fields say: they then factor the rank-major stacks only.  When ``dcn``
  is above 1, :func:`init` creates the subgroups with ``dist.new_group``,
  in the same order on every rank: one ``ici`` group per node (ranks
  ``d * n_ici .. d * n_ici + n_ici - 1``), one ``dcn`` group per ici index
  (the ranks that share it); :func:`group` returns them.
- A rank-major stack of ``n`` ranks on one card: ``n`` factors as
  ``dcn_size x n // dcn_size`` (:func:`grid`), unset meaning 1; a size that
  does not divide ``n`` raises ValueError with the JAX package's
  messages.  This is the grid of the calls that span the world (the
  rank-major verbs, the fused syncs, the recipes): a sub-stack of one axis,
  a leg of a two-level verb and the process world's ring of one member
  are one-level, since the selector passes their dcn size (1) down
  explicitly.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .config import Config, ps_timeout_s


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.config = Config()
        self.config_epoch = 0
        self.device = torch.device("cpu")
        self.owns_group = False
        self.grid = (1, 1)
        self.groups: Dict[str, list] = {}


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


def _make_groups(dcn: int, ici: int) -> Dict[str, list]:
    """Every rank creates every subgroup, in the same order: the ici
    groups (one per node), then the dcn groups (one per ici index)."""
    groups = {"ici": [dist.new_group([d * ici + i for i in range(ici)])
                      for d in range(dcn)]}
    groups["dcn"] = [dist.new_group([d * ici + i for d in range(dcn)])
                     for i in range(ici)]
    return groups


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
            grid = _world_grid(cfg, dist.get_world_size())
        except ValueError:
            if owns:
                dist.destroy_process_group()
            raise
        _state.groups = _make_groups(*grid) if grid[0] > 1 else {}
        _state.grid = grid
        _state.config = cfg
        _state.device = dev
        _state.owns_group = owns
        _state.initialized = True
        _state.config_epoch += 1
    # Outside the lock: the tuning layer reads the runtime's accessors.
    _configure_tuning(cfg)
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
        _state.grid = (1, 1)
        _state.groups = {}
        _state.config_epoch += 1
    from . import planner, tuning

    planner.invalidate()
    tuning.reset()


def _configure_tuning(cfg: Config) -> None:
    """Load the tuning plans where the config asks for them (JAX
    :864-876): under backend "auto", or with a plan path, which loads
    without "auto" too (the decision log then says it is inactive)."""
    auto = cfg.backend == "auto"
    if auto or cfg.tuning_plan_path is not None:
        from . import tuning

        tuning.configure(cfg.tuning_plan_path, auto_active=auto)


def set_config(**overrides) -> None:
    """Switch knobs of the running runtime (reference: the torchmpi_set_*
    setters; the JAX package's ``set_config``).  Bumps the config epoch
    and drops every collective plan (``collectives.clear_cache``); a
    config that opts into the tuning plans (re)loads them (an unchanged
    path keeps the in-memory entries, JAX :1067-1080).  The process
    world's grid stays the one :func:`init` built; a new ``dcn_size`` /
    ``ici_size`` factors the rank-major stacks from here on."""
    with _state.lock:
        _require_init()
        for k in overrides:
            if not hasattr(_state.config, k):
                raise ValueError(f"unknown config field {k!r}")
        if "ps_timeout_s" in overrides:
            overrides["ps_timeout_s"] = ps_timeout_s(overrides["ps_timeout_s"])
        _state.config = dataclasses.replace(_state.config, **overrides)
        _state.config_epoch += 1
    from . import collectives

    collectives.clear_cache()
    _configure_tuning(_state.config)


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
    """(n_dcn, n_ici): of the world's rank-major stack of ``n`` ranks, from
    the active Config's ``dcn_size`` / ``ici_size`` (unset: (1, n)); of the
    process world when ``n`` is None.  The selector and the recipes read it
    for the calls that span the world, and pass the dcn size down to the
    two-level routes (``selector.TWO_LEVEL``)."""
    if n is None:
        _require_init()
        return _state.grid
    cfg = effective_config()
    return _factor(int(n), cfg.dcn_size, cfg.ici_size)


def dcn_size() -> int:
    """The process world's outer (inter-node) size."""
    return grid()[0]


def ici_size() -> int:
    """The process world's inner (intra-node) size."""
    return grid()[1]


def axis_index(axis: str) -> int:
    """This process's index along ``axis`` ("dcn" or "ici")."""
    n_ici = ici_size()
    r = rank()
    return r // n_ici if axis == "dcn" else r % n_ici


def group(axis: str):
    """The process group of ``axis`` that holds this process: this node's
    ranks for "ici", the ranks sharing this ici index for "dcn", None (the
    world's default group) for both.  An axis of size 1 has no group:
    None there means this process alone (callers compute locally)."""
    _require_init()
    if axis not in ("dcn", "ici"):
        raise ValueError(f"unknown axis {axis!r} (the world axes are "
                         f"'dcn' and 'ici')")
    if not _state.groups:
        return None
    d, i = axis_index("dcn"), axis_index("ici")
    return _state.groups[axis][d if axis == "ici" else i]


def local_rank() -> int:
    """Rank among the processes of this host: the launcher's ``LOCAL_RANK``
    (or the JAX package's ``TORCHMPI_TPU_LOCAL_RANK``), else 0."""
    v = os.environ.get("LOCAL_RANK",
                       os.environ.get("TORCHMPI_TPU_LOCAL_RANK"))
    return int(v) if v is not None else 0


def barrier() -> None:
    """Global barrier (reference: ``mpi.barrier()``)."""
    _require_init()
    if _state.device.type == "cuda":
        dist.barrier(device_ids=[_state.device.index])
    else:
        dist.barrier()
