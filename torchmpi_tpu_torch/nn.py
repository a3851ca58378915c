"""``torchmpi_tpu_torch.nn`` — the ``torchmpi.nn`` integration surface.

Facade over :mod:`torchmpi_tpu_torch.parallel.gradsync`, the counterpart of
``torchmpi_tpu/nn.py``: ``mpi.nn.synchronize_parameters`` /
``mpi.nn.synchronize_gradients`` / ``mpi.nn.data_parallel_step``, and the
rank-major ``mpi.nn.data_parallel_step_rank_major``.
"""

from .parallel.gradsync import (  # noqa: F401
    data_parallel_step,
    data_parallel_step_rank_major,
    synchronize_gradients,
    synchronize_parameters,
)

__all__ = ["synchronize_parameters", "synchronize_gradients",
           "data_parallel_step", "data_parallel_step_rank_major"]
