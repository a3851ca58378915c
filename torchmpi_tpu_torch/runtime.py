"""Process-group runtime: init / stop / rank / size / barrier.

The PyTorch counterpart of ``torchmpi_tpu/runtime.py``.  Where the JAX
package builds a device mesh, the port builds one ``torch.distributed``
process group: NCCL when the runtime's device is the card, gloo when the
caller asks for the CPU.  Launched without a launcher (no ``RANK`` /
``WORLD_SIZE`` in the environment and no explicit arguments), the world is
this one process, rendezvousing with itself on a free localhost port.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
from typing import Optional

import torch
import torch.distributed as dist

from .config import Config


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.config = Config()
        self.config_epoch = 0
        self.device = torch.device("cpu")
        self.owns_group = False


_state = _State()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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
        _state.config = cfg
        _state.device = dev
        _state.owns_group = owns
        _state.initialized = True
        _state.config_epoch += 1
        return dev


def stop() -> None:
    """Tear down (reference: ``mpi.stop``).  Destroys the process group if
    :func:`init` created it."""
    with _state.lock:
        if _state.initialized and _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _state.initialized = False
        _state.owns_group = False
        _state.config_epoch += 1


def set_config(**overrides) -> None:
    """Switch knobs of the running runtime (reference: the torchmpi_set_*
    setters; the JAX package's ``set_config``).  Bumps the config epoch."""
    with _state.lock:
        _require_init()
        for k in overrides:
            if not hasattr(_state.config, k):
                raise ValueError(f"unknown config field {k!r}")
        _state.config = dataclasses.replace(_state.config, **overrides)
        _state.config_epoch += 1


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
