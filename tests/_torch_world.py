"""One gloo process group of one process for a whole test module.

``tmpi.init`` adopts a process group that already exists and ``tmpi.stop``
leaves it standing, so a module that inits and stops the port's runtime in
every test creates the group once here (``module_group``) instead of a new
rendezvous per test.  Both runtimes are stopped around the module, so a
runtime left by an earlier file in the same worker sets none of its knobs.
"""

import contextlib
import socket

import torch.distributed as dist

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def module_group():
    jmpi.stop()
    tmpi.stop()
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    try:
        yield
    finally:
        tmpi.stop()
        jmpi.stop()
        if own and dist.is_initialized():
            dist.destroy_process_group()
