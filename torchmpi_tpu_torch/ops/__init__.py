"""Hand-written Hopper kernels of the port and their plain PyTorch
versions.  Importing this package builds nothing: a kernel is compiled the
first time it is launched (see ``_build``)."""

from . import flash, ring, ring_sim, xent  # noqa: F401
from .xent import fused_linear_cross_entropy  # noqa: F401
