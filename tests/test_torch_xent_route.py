"""The route of the port's fused-loss kernels, on the CPU.

``xent._route`` picks, before any launch, whether a call takes the TMA-fed
``wgmma`` product (every row pitch a multiple of 16 bytes, so E and V
multiples of 8, and every operand's base 16-byte aligned) or the
``cp.async`` / ``wmma`` product: the forward from x's and w's addresses,
the backward from those of every operand it reads or writes.  It is a pure
function of the shapes and the addresses, so it is held here without a
card or a compiler; the forward wrapper's launch arguments are held with
the launch replaced by a stand-in; the card tests
(tests/test_torch_xent_kernels.py) check that the launches follow it.  No
JAX.
"""

import pytest
import torch

from torchmpi_tpu_torch.ops import xent

A = 1 << 20  # a 16-byte aligned device address


# (E, V, addresses, route): the card tests' shapes, the flagship, the
# smallest box, E or V off the multiple of 8, an operand 8 bytes off, and
# a missing operand (None: the dW accumulator of a one-chunk call).  The
# forward's calls give two addresses, x's and w's: the flagship, V below
# one 256-column tile, and x or w off the 16-byte boundary (the train
# step's x is a fresh contiguous copy, so aligned).
ROUTE_CASES = [
    (2048, 32768, (A, A), "wgmma"),
    (64, 200, (A, A + 64), "wgmma"),
    (2048, 32768, (A + 8, A), "wmma"),
    (2048, 32768, (A, A + 2), "wmma"),
    (36, 200, (A, A), "wmma"),
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
    assert set(xent.ROUTE_LAUNCHES) == {"xent_fwd", "xent_bwd_dx",
                                        "xent_bwd_dw"}
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


# (N, E, V, x offset in elements): the forward's launch on each route.
FWD_CASES = [(21, 16, 40, 0), (300, 64, 1000, 0), (64, 8, 8, 0),
             (21, 36, 333, 0), (40, 64, 520, 4)]


@pytest.mark.parametrize("N,E,V,off", FWD_CASES, ids=lambda v: str(v))
def test_forward_launch_follows_its_route(monkeypatch, N, E, V, off):
    """The forward wrapper, its launch replaced by a stand-in that does the
    kernel's work in torch: the route flag and the partial count it passes
    (one partial per 256-column tile on the wgmma route, ``_fwd_splits``
    on the wmma route), the workspace's shape, and one count on that route
    and none on the other."""
    calls = []

    def launch(name, dev, *a):
        x, w, lab, part, loss, lse, n, e, v, splits, wgmma = a
        calls.append((name, part.shape, (n, e, v), splits, wgmma))
        l_, s_ = xent.xent_fwd_plain(x, w, lab)
        loss.copy_(l_)
        lse.copy_(s_)

    monkeypatch.setattr(xent, "_launch", launch)
    monkeypatch.setattr(xent, "_device_kind", lambda t: "cuda")
    g = torch.Generator().manual_seed(N + V)
    buf = torch.randn(N * E + off, generator=g).bfloat16()
    x = buf[off:].view(N, E)
    w = torch.randn(E, V, generator=g).bfloat16()
    lab = torch.randint(0, V, (N,), generator=g)
    route = xent._route(E, V, x.data_ptr(), w.data_ptr())
    assert route == ("wgmma" if E % 8 == 0 and V % 8 == 0 and off == 0
                     else "wmma")
    xent.reset_launches()
    loss, lse = xent.xent_fwd(x, w, lab)
    splits = -(-V // 256) if route == "wgmma" else xent._fwd_splits(N, V)
    assert calls == [("xent_fwd", (3, splits, N), (N, E, V), splits,
                      int(route == "wgmma"))]
    assert xent.LAUNCHES["xent_fwd"] == 1
    assert xent.ROUTE_LAUNCHES["xent_fwd"] == {
        r: int(r == route) for r in xent.ROUTES}
    want = xent.xent_fwd_plain(x, w, lab)
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])
