"""torchmpi_tpu_torch — the PyTorch / CUDA port of torchmpi_tpu.

The same shape as the JAX package, a communication library with a
data-parallel integration layer on top, built on ``torch.distributed`` for
an NVIDIA H100, with the JAX package's Pallas TPU kernels rewritten by hand
as CUDA kernels (``ops/csrc``):

    import torchmpi_tpu_torch as mpi
    mpi.init()                              # NCCL on the card, world of 1
    mpi.rank(), mpi.size()
    mpi.allreduce(x)                        # sum over ranks
    mpi.allreduce_rank_major(xs, backend="pallas")  # xs[i] = rank i's, one card
    mpi.reduce_scatter(x), mpi.allgather(x)   # this rank's tile / the stack
    h = mpi.async_.allreduce(xs); h.wait()  # on a side stream; wait_all(hs)
    step = mpi.nn.data_parallel_step(model, optimizer, loss_fn)
    loss = step(batch)                      # grads synced in fused buckets
    vag = mpi.nn.make_overlapped_grad_fn(loss_fn, params)
    loss, grads = vag(params, *batch)       # synced from backward hooks
    new_params, state = mpi.parallel.zero.update(params, grads, state, tx)
    step = mpi.recipes.make_bn_dp_train_step(resnet, tx, zero=1)  # BN models
    mpi.allreduce_rank_major(xs, backend="hierarchical")  # dcn x ici grid
    mpi.init(mpi.Config(mesh_shape={"pp": 2, "dp": 2, "tp": 2}))  # N-D world
    with mpi.communicator("half", shape={"ici": 4}): ...  # pushed split
    y = mpi.parallel.tensor.tp_mlp(x, w1, w2, "tp")  # Megatron f / g pair
    out = mpi.parallel.pipeline.gpipe_apply(stage, p, mbs, "pp")
    mpi.init(mpi.Config(backend="auto"))    # routes measured, then planned
    ps = mpi.parameterserver.init(params)   # async PS (downpour, EASGD)
    ps.send(updates, rule="add"); h = ps.receive(); params = h.wait()
    mpi.utils.checkpoint.save_async(dir, tree, step=s).wait()
    mpi.stop()

It imports nothing of JAX and nothing of ``torchmpi_tpu``.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from .config import Config
from .runtime import (
    barrier,
    communicator,
    config,
    config_epoch,
    current_communicator,
    current_communicator_name,
    effective_config,
    init,
    is_initialized,
    local_rank,
    pop_communicator,
    push_communicator,
    rank,
    set_config,
    size,
    stop,
    world_shape,
)
from . import collectives, fusion, planner, selector, tuning
from . import models, nn, ops, optim, parallel, weights
from . import parameterserver, recipes, utils
from .collectives import (  # noqa: F401
    AsyncHandle, PeerTimeoutError, allgather, allgather_in_axis,
    allgather_rank_major, allreduce, allreduce_in_axis, allreduce_rank_major,
    alltoall, alltoall_in_axis, alltoall_rank_major, async_, async_in_axis,
    broadcast, broadcast_in_axis, broadcast_rank_major, gather,
    gather_in_axis, gather_rank_major, reduce, reduce_in_axis,
    reduce_rank_major, reduce_scatter, reduce_scatter_in_axis,
    reduce_scatter_rank_major, scatter, scatter_in_axis, scatter_rank_major,
    sendreceive, sendreceive_in_axis, sendreceive_rank_major, sync_handle,
    wait_all)

__version__ = "0.1.0"

__all__ = [
    "Config", "init", "stop", "is_initialized", "rank", "size", "local_rank",
    "barrier", "config", "config_epoch", "effective_config", "set_config",
    "communicator", "push_communicator", "pop_communicator",
    "current_communicator", "current_communicator_name", "world_shape",
    "collectives", "fusion", "planner", "selector", "tuning", "models", "nn", "ops", "parallel",
    "weights", "optim", "parameterserver", "recipes", "utils",
    "__version__",
    "AsyncHandle", "PeerTimeoutError", "async_", "async_in_axis",
    "sync_handle", "wait_all",
] + [f"{verb}{form}" for verb in collectives.VERBS
     for form in ("", "_in_axis", "_rank_major")]
