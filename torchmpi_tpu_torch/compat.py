"""TorchMPI-naming compatibility surface.

The PyTorch counterpart of ``torchmpi_tpu/compat.py``.  A user of the
reference (``require('torchmpi')``, SURVEY.md §3 C9) finds the verbs here
under the names they knew; the native snake_case API is the primary
surface, and these are thin aliases::

    import torchmpi_tpu_torch.compat as mpi
    mpi.start()                       # mpi.start(withCuda)
    y = mpi.allreduceTensor(xs)       # xs [n, ...]: rank r's tensor xs[r]
    h = mpi.async_.allreduceTensor(xs)
    y = mpi.syncHandle(h)
    mpi.nn.synchronizeParameters(model)
    mpi.nn.synchronizeGradients(model)
    mpi.stop()

Which verbs the names alias.  The JAX package drives every device from one
controller, so its eager ``allreduce(x)`` takes a rank-major stack, and so
do its ``*Tensor`` names and their ``async_`` forms.  The port's
``async_`` verbs are rank-major too (``collectives.async_``), while its
``allreduce`` is the process-world verb (each process its own tensor, the
torch.distributed convention and TorchMPI's own per-process meaning).  So
the sync ``*Tensor`` names alias the ``*_rank_major`` verbs: the JAX
compat's inputs give the JAX compat's outputs, and the sync and async
names agree.  The per-process forms are ``collectives.allreduce`` and
friends (ROADMAP queue C note 21).  ``nn.synchronizeParameters`` /
``synchronizeGradients`` alias ``torchmpi_tpu_torch.nn``'s (the process
world, parameters and ``.grad`` in place), as the JAX package's alias its
``gradsync``.

The knob setters mirror the reference's C-level setters
(``torchmpi_set_flat_collectives`` etc., SURVEY.md §6.6).
"""

from __future__ import annotations

from types import SimpleNamespace

from . import collectives as _collectives
from . import runtime as _runtime
from .parallel import gradsync as _gradsync

# --- runtime ---------------------------------------------------------------


def start(use_accelerator: bool = True, **kw):
    """Reference: ``mpi.start(withCuda)``: the runtime on the card, or on
    the CPU (gloo) with ``use_accelerator=False``
    (``Config.use_accelerator``); ``kw`` are ``init``'s."""
    return _runtime.init(use_accelerator=use_accelerator, **kw)


stop = _runtime.stop
rank = _runtime.rank
size = _runtime.size
barrier = _runtime.barrier
localRank = _runtime.local_rank

# --- knob setters (reference: torchmpi_set_* setters) ---------------------

# The backends set_hierarchical_collectives replaced, most recent last.
_pre_hierarchical_backend: list = []


def set_flat_collectives():
    """Restore the backend that was active before
    ``set_hierarchical_collectives`` (default ``xla``): clearing the flag
    alone would leave backend='hierarchical' routing the same way."""
    prev = _pre_hierarchical_backend.pop() if _pre_hierarchical_backend \
        else "xla"
    _runtime.set_config(hierarchical=False, backend=prev)


def set_hierarchical_collectives():
    _pre_hierarchical_backend.append(_runtime.config().backend)
    _runtime.set_config(hierarchical=True, backend="hierarchical")


def set_staged_collectives():
    """Reference: ``torchmpi_set_staged_collectives``: tensors staged
    through pinned host memory, the reduction on the host CPU
    (``Config.staged``); the rank-major verbs take the staged path."""
    _runtime.set_config(staged=True)


def set_direct_collectives():
    """Reference: ``torchmpi_set_direct_collectives`` (the default)."""
    _runtime.set_config(staged=False)


def set_chunk_size(nbytes: int):
    _runtime.set_config(chunk_bytes=int(nbytes))


def set_min_bytes_for_custom(nbytes: int):
    _runtime.set_config(custom_min_bytes=int(nbytes))


def collectiveSelector(backend: str):
    """Reference: assigning into ``mpi.collectiveSelector``: "xla",
    "pallas", "hierarchical" or "auto" (the tuning plans)."""
    _runtime.set_config(backend=backend)


def collectiveAvailability():
    """Reference: ``mpi.collectiveAvailability`` introspection."""
    from . import selector

    return selector.available()


# --- tensor collectives (rank-major stacks, as the JAX package's) ----------

allreduceTensor = _collectives.allreduce_rank_major
broadcastTensor = _collectives.broadcast_rank_major
reduceTensor = _collectives.reduce_rank_major
allgatherTensor = _collectives.allgather_rank_major
gatherTensor = _collectives.gather_rank_major
scatterTensor = _collectives.scatter_rank_major
sendreceiveTensor = _collectives.sendreceive_rank_major
reduce_scatterTensor = _collectives.reduce_scatter_rank_major
alltoallTensor = _collectives.alltoall_rank_major
syncHandle = _collectives.sync_handle

async_ = SimpleNamespace(
    allreduceTensor=_collectives.async_.allreduce,
    broadcastTensor=_collectives.async_.broadcast,
    reduceTensor=_collectives.async_.reduce,
    allgatherTensor=_collectives.async_.allgather,
    gatherTensor=_collectives.async_.gather,
    scatterTensor=_collectives.async_.scatter,
    sendreceiveTensor=_collectives.async_.sendreceive,
    reduce_scatterTensor=_collectives.async_.reduce_scatter,
    alltoallTensor=_collectives.async_.alltoall,
)

# --- integration layers ----------------------------------------------------

nn = SimpleNamespace(
    synchronizeParameters=_gradsync.synchronize_parameters,
    synchronizeGradients=_gradsync.synchronize_gradients,
)


def parameterserver():
    from . import parameterserver as ps

    return ps
