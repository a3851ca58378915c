"""The port's ring reduce-scatter and all-gather against the JAX package's
ring kernels for rings of 8 ranks (the JAX package's own test mesh).

The comparison is in tests/_torch_ring_cases.py; rings of 2 and 4 ranks
are tests/test_torch_ring_rs_ag.py.
"""

import pytest
import torch

from _torch_ring_cases import (DTYPES, RS_AG_KERNELS, check_rs_ag_parity,
                               runtimes)  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", RS_AG_KERNELS)
def test_rs_ag_bitwise_equals_jax_8_ranks(kernel, dtype):
    check_rs_ag_parity(kernel, 8, dtype, seed=800 + len(dtype))
