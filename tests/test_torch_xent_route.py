"""The route of the port's fused-loss backward kernels, on the CPU.

``xent._route`` picks, before any launch, whether a backward call takes the
TMA-fed ``wgmma`` product (every row pitch a multiple of 16 bytes, so E and
V multiples of 8, and every operand's base 16-byte aligned) or the
``cp.async`` / ``wmma`` product.  It is a pure function of the shapes and
the addresses, so it is held here without a card or a compiler; the card
tests (tests/test_torch_xent_kernels.py) check that the launches follow
it.  No JAX.
"""

import pytest
import torch

from torchmpi_tpu_torch.ops import xent

A = 1 << 20  # a 16-byte aligned device address


# (E, V, addresses, route): the card tests' shapes, the flagship, the
# smallest box, E or V off the multiple of 8, an operand 8 bytes off, and
# a missing operand (None: the dW accumulator of a one-chunk call).
ROUTE_CASES = [
    (2048, 32768, (A, A, A, A), "wgmma"),
    (2048, 4104, (A, A + 4104 * 2 * 1000), "wgmma"),
    (128, 2056, (A, A, A, None, A), "wgmma"),
    (64, 520, (A, A, A), "wgmma"),
    (8, 8, (A, A), "wgmma"),
    (36, 256, (A, A, A), "wmma"),
    (40, 333, (A, A, A), "wmma"),
    (36, 333, (A, A, A), "wmma"),
    (2048, 32768, (A + 8, A, A), "wmma"),
    (2048, 32768, (A, A, A + 4), "wmma"),
    (2044, 32768, (A, A), "wmma"),
    (2048, 32764, (A, A), "wmma"),
]


@pytest.mark.parametrize("E,V,ptrs,route", ROUTE_CASES,
                         ids=lambda v: str(v))
def test_route_is_a_function_of_shape_and_alignment(E, V, ptrs, route):
    assert xent._route(E, V, *ptrs) == route


def test_reset_launches_clears_the_route_counts():
    xent.ROUTE_LAUNCHES["xent_bwd_dx"]["wgmma"] += 3
    xent.ROUTE_LAUNCHES["xent_bwd_dw"]["wmma"] += 1
    xent.reset_launches()
    assert all(c == 0 for counts in xent.ROUTE_LAUNCHES.values()
               for c in counts.values())
    assert set(xent.ROUTE_LAUNCHES) == {"xent_bwd_dx", "xent_bwd_dw"}
    assert all(set(c) == set(xent.ROUTES)
               for c in xent.ROUTE_LAUNCHES.values())


def test_cpu_wrappers_count_no_route():
    """On CPU tensors the wrappers take their plain versions: no launch,
    so no route is counted."""
    xent.reset_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 8, generator=g).bfloat16()
    w = torch.randn(8, 16, generator=g).bfloat16()
    lab = torch.randint(0, 16, (5,), generator=g)
    _, lse = xent.xent_fwd(x, w, lab)
    xent.xent_bwd(x, w, lab, lse, torch.ones(5))
    assert all(c == 0 for counts in xent.ROUTE_LAUNCHES.values()
               for c in counts.values())
