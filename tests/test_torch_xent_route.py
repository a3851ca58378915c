"""The route of the port's fused-loss kernels, on the CPU.

``xent._route`` picks, before any launch, whether a call takes the TMA-fed
``wgmma`` product (bfloat16, every row pitch a multiple of 16 bytes, so E
and V multiples of 8, and every operand's base 16-byte aligned), the
``cp.async`` / ``wmma`` product (any other bfloat16 call) or its TF32
three-product form ``tf32x3`` (every float32 call, whatever its shapes
and addresses): the forward from x's and w's addresses, the backward from
those of every operand it reads or writes.  It is a pure function of the
dtype, the shapes and the addresses, so it is held here without a card or
a compiler; the wrappers' launch arguments (route flag, dtype code, the
g workspace's dtype) are held with the launch replaced by a torch
stand-in; the card tests (tests/test_torch_xent_kernels.py) check that the
launches follow it.  No JAX.
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
    assert xent._route(E, V, *ptrs, dtype=torch.bfloat16) == route


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
    kernel's work in torch: the route code and the partial count it passes
    (one partial per 256-column tile on the wgmma route, ``_fwd_splits``
    on the wmma route), the workspace's shape, and one count on that route
    and none on the other."""
    calls = []

    def launch(name, dev, *a):
        x, w, lab, part, loss, lse, n, e, v, splits, code = a
        calls.append((name, part.shape, (n, e, v), splits, code))
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
    route = xent._route(E, V, x.data_ptr(), w.data_ptr(),
                        dtype=torch.bfloat16)
    assert route == ("wgmma" if E % 8 == 0 and V % 8 == 0 and off == 0
                     else "wmma")
    xent.reset_launches()
    loss, lse = xent.xent_fwd(x, w, lab)
    splits = -(-V // 256) if route == "wgmma" else xent._fwd_splits(N, V)
    assert calls == [("xent_fwd", (3, splits, N), (N, E, V), splits,
                      xent.ROUTES.index(route))]
    assert xent.LAUNCHES["xent_fwd"] == 1
    assert xent.ROUTE_LAUNCHES["xent_fwd"] == {
        r: int(r == route) for r in xent.ROUTES}
    want = xent.xent_fwd_plain(x, w, lab)
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])


@pytest.mark.parametrize("E,V,ptrs,route", ROUTE_CASES,
                         ids=lambda v: str(v))
def test_float32_takes_tf32x3_whatever_its_alignment(E, V, ptrs, route):
    assert xent._route(E, V, *ptrs, dtype=torch.float32) == "tf32x3"


def _chunk_work(name, dev, *a):
    """A stand-in for ``xent._launch`` that does each backward kernel's
    work on its chunk in torch, as the kernels do: g formed into the
    workspace when asked (cast to the workspace's dtype), dx = g W^T, dW
    accumulated across chunks in float32."""
    x, w, lab, lse, dl, g = a[:6]
    rows = x.shape[0]
    if name == "xent_bwd_dx":
        dx, _, _, _, make_g = a[6:11]
    else:
        acc, dw, _, _, _, make_g, first, last = a[6:14]
    if make_g:
        g[:rows] = xent._grad_plain(x, w, lab, lse, dl).to(g.dtype)
    gr = g[:rows].float()
    if name == "xent_bwd_dx":
        dx.copy_((gr @ w.float().t()).to(dx.dtype))
        return
    s = x.float().t() @ gr
    s = s if first else acc + s
    if last:
        dw.copy_(s.to(dw.dtype))
    else:
        acc.copy_(s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,E,V,off", FWD_CASES, ids=lambda v: str(v))
def test_launches_carry_the_route(monkeypatch, N, E, V, off, dtype):
    """Forward and backward on CUDA tensors, the launch standing in as
    torch: float32 x and w take ``tf32x3`` (the wmma grid's splits, route
    code 2) and bfloat16 their address route (code 0 or 1);
    the backward's g workspace is w's dtype (float32 g is never rounded)
    and holds one chunk; each wrapper counts one launch on its route; the
    results agree with the plain versions."""
    calls = []

    def launch(name, dev, *a):
        if name == "xent_fwd":
            x, w, lab, part, loss, lse, n, e, v, splits, code = a
            calls.append((name, splits, code))
            l_, s_ = xent.xent_fwd_plain(x, w, lab)
            loss.copy_(l_)
            lse.copy_(s_)
            return
        g = a[5]
        calls.append((name, g.dtype, tuple(g.shape), a[-1]))
        _chunk_work(name, dev, *a)

    monkeypatch.setattr(xent, "_launch", launch)
    monkeypatch.setattr(xent, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(xent, "BWD_CHUNK", 16)
    g = torch.Generator().manual_seed(N * E + V)
    buf = torch.randn(N * E + off, generator=g).to(dtype)
    x = buf[off:].view(N, E)
    w = (torch.randn(E, V, generator=g) / E ** 0.5).to(dtype)
    lab = torch.randint(0, V, (N,), generator=g)
    dl = torch.randn(N, generator=g)
    f32 = dtype == torch.float32
    route = xent._route(E, V, x.data_ptr(), w.data_ptr(), dtype=dtype)
    assert (route == "tf32x3") == f32
    xent.reset_launches()
    loss, lse = xent.xent_fwd(x, w, lab)
    splits = -(-V // 256) if route == "wgmma" else xent._fwd_splits(N, V)
    assert calls == [("xent_fwd", splits, xent.ROUTES.index(route))]
    dx, dw = xent.xent_bwd(x, w, lab, lse, dl)
    broute = xent._route(E, V, x.data_ptr(), w.data_ptr(), dtype=dtype)
    chunks = -(-N // 16)
    assert calls[1:] == [
        (name, dtype, (min(16, N), V), xent.ROUTES.index(broute))
        for _ in range(chunks) for name in ("xent_bwd_dx", "xent_bwd_dw")]
    assert dx.dtype == dw.dtype == dtype
    for name in xent.KERNELS:
        r = route if name == "xent_fwd" else broute
        assert xent.LAUNCHES[name] == 1
        assert xent.ROUTE_LAUNCHES[name] == {
            k: int(k == r) for k in xent.ROUTES}, name
    want = xent.xent_fwd_plain(x, w, lab)
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])
    # The chunks sum dW in another f32 order than one product (float32:
    # 1e-5 of the largest |dW|); bf16 results round once more (2^-7).
    rtol = 1e-5 if f32 else 2.0 ** -7
    for got, plain in ((dx, xent.xent_bwd_dx_plain),
                       (dw, xent.xent_bwd_dw_plain)):
        want = plain(x, w, lab, lse, dl).float()
        err = float((got.float() - want).abs().max())
        assert err <= rtol * float(want.abs().max()), (plain.__name__, err)


@pytest.mark.parametrize("xdt,wdt", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16), (torch.float64, torch.float64)],
    ids=lambda v: str(v))
def test_mixed_and_other_dtypes_raise(monkeypatch, xdt, wdt):
    """Only (bf16, bf16) and (f32, f32) reach a kernel: anything else
    raises TypeError by the kernel's name before a launch, forward and
    backward alike."""
    def launch(*a):
        raise AssertionError("launched")

    monkeypatch.setattr(xent, "_launch", launch)
    monkeypatch.setattr(xent, "_device_kind", lambda t: "cuda")
    x = torch.randn(8, 16).to(xdt)
    w = torch.randn(16, 24).to(wdt)
    lab = torch.randint(0, 24, (8,))
    with pytest.raises(TypeError, match="xent_fwd"):
        xent.xent_fwd(x, w, lab)
    with pytest.raises(TypeError, match="xent_bwd"):
        xent.xent_bwd(x, w, lab, torch.zeros(8), torch.ones(8))
    with pytest.raises(TypeError, match="xent_bwd"):
        xent.xent_bwd_dw(x, w, lab, torch.zeros(8), torch.ones(8))
