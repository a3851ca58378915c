"""``torchmpi_tpu_torch.nn`` — the ``torchmpi.nn`` integration surface.

Facade over :mod:`torchmpi_tpu_torch.parallel.gradsync`, the counterpart of
``torchmpi_tpu/nn.py``: ``mpi.nn.synchronize_parameters`` /
``mpi.nn.synchronize_gradients`` / ``mpi.nn.make_overlapped_grad_fn`` /
``mpi.nn.data_parallel_step``, and the rank-major
``mpi.nn.make_overlapped_grad_fn_rank_major`` /
``mpi.nn.data_parallel_step_rank_major``.
"""

from .parallel.gradsync import (  # noqa: F401
    data_parallel_step,
    data_parallel_step_rank_major,
    make_overlapped_grad_fn,
    make_overlapped_grad_fn_rank_major,
    synchronize_gradients,
    synchronize_parameters,
)

__all__ = ["synchronize_parameters", "synchronize_gradients",
           "make_overlapped_grad_fn", "make_overlapped_grad_fn_rank_major",
           "data_parallel_step", "data_parallel_step_rank_major"]
