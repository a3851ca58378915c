"""The route of the port's fused-loss kernels, on the CPU.

``xent._route`` picks, before any launch, whether a call takes the TMA-fed
``wgmma`` product (bfloat16, every row pitch a multiple of 16 bytes, so E
and V multiples of 8, and every operand's base 16-byte aligned), the
``cp.async`` / ``wmma`` product (any other bfloat16 call), the TF32
``wgmma`` product in the three-product form ``wgmma_tf32`` (a float32
call whose row pitches are multiples of 16 bytes, E and V multiples of 4,
and whose bases are 16-byte aligned) or the ``wmma`` TF32 three-product
form ``tf32x3`` (every other float32 call), the same in the forward and
the backward: the forward from x's and w's addresses, the backward from
those of every operand it reads or writes.  It is a pure function of the
dtype, the shapes and the addresses, so it is held here without a card or
a compiler; the wrappers' launch arguments (route flag, dtype code, the g
workspace's dtype, the ``wgmma_tf32`` route's K-major copies and their lo
parts, forward and backward) are held with the launches replaced by torch
stand-ins; the
truncating split and the three-product form are held to numpy; the card
tests (tests/test_torch_xent_kernels.py) check that the launches follow
the route.  No JAX.
"""

import numpy as np
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


# (N, E, V, x offset in elements): the forward's launch on each route; an
# offset of 4 elements is 8 bytes off in bfloat16 and 16 bytes (aligned)
# in float32, one is off in both.
FWD_CASES = [(21, 16, 40, 0), (300, 64, 1000, 0), (64, 8, 8, 0),
             (21, 36, 333, 0), (40, 64, 520, 4), (40, 64, 520, 1)]


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
    """Float32 takes ``wgmma_tf32`` exactly when E and V are multiples of
    4 and every base is 16-byte aligned, else ``tf32x3``; the rule has no
    direction (the forward's addresses are x's and w's, the backward's
    every operand's).  Where bfloat16 takes ``wgmma``, float32 takes
    ``wgmma_tf32``."""
    tma = (E % 4 == 0 and V % 4 == 0
           and all(p is None or p % 16 == 0 for p in ptrs))
    assert xent._route(E, V, *ptrs, dtype=torch.float32) == (
        "wgmma_tf32" if tma else "tf32x3")
    assert route == "wmma" or tma


def _split_work(a):
    """A stand-in for the ``xent_split`` launch (tm_xent_split): the K-major
    copies of src [R, C] by the plain split, lo [R, C] and, at pitch ldt,
    src^T and lo^T [C, ldt] (each where given)."""
    src, lo, hi_t, lo_t, R, C, ldt = a
    assert tuple(src.shape) == (R, C) and src.is_contiguous()
    low = xent.tf32_split_plain(src)[1]
    if lo is not None:
        lo[:R] = low
    for dst, val in ((hi_t, src), (lo_t, low)):
        if dst is not None:
            assert ldt % 4 == 0 and ldt >= R and dst.numel() >= C * ldt
            dst.view(-1)[:C * ldt].view(C, ldt)[:, :R] = val.t()


def _transposed(t, rows):
    """The [., pitch] copy of a chunk of ``rows`` rows packed at the start
    of buffer ``t``, cut to its rows."""
    p = xent._tf32_pitch(rows)
    return t.view(-1)[:t.shape[0] * p].view(t.shape[0], p)[:, :rows]


def _chunk_work(name, dev, *a, ops=None):
    """A stand-in for ``xent._launch`` that does each backward kernel's
    work on its chunk in torch, as the kernels do: g formed into the
    workspace when asked (cast to the workspace's dtype), dx = g W^T, dW
    accumulated across chunks in float32.  On the ``wgmma_tf32`` route
    (``ops``) g is formed into the copies the kernels read (g and its lo
    part for dx, g^T and its lo part for dW), and dW is taken from the
    chunk's x^T and g^T copies, as the kernel reads them."""
    if name == "xent_split":
        return _split_work(a)
    x, w, lab, lse, dl, g = a[:6]
    rows = x.shape[0]
    if name == "xent_bwd_dx":
        dx, _, _, _, make_g = a[6:11]
    else:
        acc, dw, _, _, _, make_g, first, last = a[6:14]
    if ops is not None:
        o = dict(zip(xent.TF32_OPS, ops))
        if make_g:
            gf = xent._grad_plain(x, w, lab, lse, dl)
            if g is not None:
                g[:rows] = gf
                o["g_lo"][:rows] = xent.tf32_split_plain(gf)[1]
            if o["gt"] is not None:
                _transposed(o["gt"], rows)[:] = gf.t()
                _transposed(o["gt_lo"], rows)[:] = (
                    xent.tf32_split_plain(gf)[1].t())
        if name == "xent_bwd_dx":
            dx.copy_(g[:rows] @ w.t())
            return
        s = _transposed(o["xt"], rows) @ _transposed(o["gt"], rows).t()
        s = s if first else acc + s
        if last:
            dw.copy_(s)
        else:
            acc.copy_(s)
        return
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
    torch: float32 x and w take their address route in both directions
    (``wgmma_tf32``, code 3, with ceil(V / 128) partials in the forward
    and two ``xent_split`` launches before it, W's at pitch E and then x's
    lo part; or ``tf32x3``, code 2, the wmma grid's splits, null copies);
    bfloat16 theirs (code 0 or 1) in both; the backward's g workspace is
    w's dtype (float32 g is never rounded) and holds one chunk; each
    wrapper counts one launch on its route; the results agree with the
    plain versions."""
    calls, splits_made = [], []

    def launch(name, dev, *a, ops=None):
        if name == "xent_fwd":
            x, w, lab, part, loss, lse, n, e, v, splits, code = a
            calls.append((name, splits, code, ops is None))
            l_, s_ = xent.xent_fwd_plain(x, w, lab)
            loss.copy_(l_)
            lse.copy_(s_)
            return
        if name == "xent_split":
            splits_made.append(tuple(a[4:]))
        else:
            g = a[5]
            calls.append((name, g.dtype, tuple(g.shape), a[-1]))
            assert (ops is not None) == (a[-1] == xent.ROUTES.index(
                "wgmma_tf32"))
        _chunk_work(name, dev, *a, ops=ops)

    monkeypatch.setattr(xent, "_launch", launch)
    monkeypatch.setattr(xent, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(xent, "BWD_CHUNK", 16)
    monkeypatch.setattr(xent, "TF32_CHUNK", 16)
    g = torch.Generator().manual_seed(N * E + V)
    buf = torch.randn(N * E + off, generator=g).to(dtype)
    x = buf[off:].view(N, E)
    w = (torch.randn(E, V, generator=g) / E ** 0.5).to(dtype)
    lab = torch.randint(0, V, (N,), generator=g)
    dl = torch.randn(N, generator=g)
    f32 = dtype == torch.float32
    route = xent._route(E, V, x.data_ptr(), w.data_ptr(), dtype=dtype)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if f32:
        assert route == ("wgmma_tf32" if E % 4 == 0 and V % 4 == 0
                         and aligned else "tf32x3")
    else:
        assert route in ("wgmma", "wmma")
    code = xent.ROUTES.index(route)
    xent.reset_launches()
    loss, lse = xent.xent_fwd(x, w, lab)
    splits = {"wgmma": -(-V // 256), "wgmma_tf32": -(-V // 128)}.get(
        route, xent._fwd_splits(N, V))
    assert calls == [("xent_fwd", splits, code, route != "wgmma_tf32")]
    tf32 = route == "wgmma_tf32"
    assert splits_made == ([(E, V, E), (N, E, 0)] if tf32 else [])
    dx, dw = xent.xent_bwd(x, w, lab, lse, dl)
    chunks = -(-N // 16)
    assert calls[1:] == [
        (name, dtype, (min(16, N), V), code)
        for _ in range(chunks) for name in ("xent_bwd_dx", "xent_bwd_dw")]
    # wgmma_tf32: the forward's copies, then the backward's: W's once
    # (pitch E), then x's per chunk.
    rows = [min(16, N - c0) for c0 in range(0, N, 16)]
    assert splits_made == ([(E, V, E), (N, E, 0), (E, V, E)]
                           + [(r, E, xent._tf32_pitch(r)) for r in rows]
                           if tf32 else [])
    assert dx.dtype == dw.dtype == dtype
    for name in xent.KERNELS:
        assert xent.LAUNCHES[name] == 1
        assert xent.ROUTE_LAUNCHES[name] == {
            k: int(k == route) for k in xent.ROUTES}, name
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


# (N, E, V, chunk): the wgmma_tf32 route's wrapper at chunks with a ragged
# last one (its transposed copies packed at their own pitch), a pitch
# that is not the chunk's (N 37: chunks 16, 16, 5), and one chunk (no dW
# accumulator).
TF32_CASES = [(21, 16, 40, 8), (37, 12, 20, 16), (9, 8, 8, 16)]


@pytest.mark.parametrize("want", [(True, True), (True, False),
                                  (False, True)], ids=str)
@pytest.mark.parametrize("N,E,V,chunk", TF32_CASES, ids=lambda v: str(v))
def test_wgmma_tf32_launch_arguments(monkeypatch, N, E, V, chunk, want):
    """The float32 backward on the wgmma_tf32 route, its launches standing
    in as torch: at every launch the K-major copies it is handed are those
    of its operands, bit for bit (W^T and W's and W^T's lo parts from the
    call's one W split; the chunk's x lo part, x^T and its lo part at the
    chunk's pitch), the copies a call does not need are None, the g
    workspace is [chunk, V] float32 (none for dW alone), g^T and its lo
    part are [V, pitch(chunk)]; dx forms g once per chunk when both are
    wanted; the results equal the plain versions'."""
    want_dx, want_dw = want
    seen = []

    def launch(name, dev, *a, ops=None):
        if name != "xent_split":
            o = dict(zip(xent.TF32_OPS, ops))
            x, w, g = a[0], a[1], a[5]
            rows = x.shape[0]
            lo = lambda t: xent.tf32_split_plain(t)[1]  # noqa: E731
            need = dict(x_lo=True, wt=True, wt_lo=True, w_lo=want_dx,
                        g_lo=want_dx, xt=want_dw, xt_lo=want_dw,
                        gt=want_dw, gt_lo=want_dw)
            assert {k: o[k] is not None for k in o} == need
            assert torch.equal(o["wt"], w.t()) and torch.equal(
                o["wt_lo"], lo(w).t())
            if want_dx:
                assert torch.equal(o["w_lo"], lo(w))
                assert tuple(o["g_lo"].shape) == (min(chunk, N), V)
            assert torch.equal(o["x_lo"][:rows], lo(x))
            p = xent._tf32_pitch(min(chunk, N))
            if want_dw:
                assert torch.equal(_transposed(o["xt"], rows), x.t())
                assert torch.equal(_transposed(o["xt_lo"], rows), lo(x).t())
                for k in ("xt", "xt_lo"):
                    assert tuple(o[k].shape) == (E, p)
                for k in ("gt", "gt_lo"):
                    assert tuple(o[k].shape) == (V, p)
            if want_dx:
                assert g.dtype == torch.float32 and tuple(g.shape) == (
                    min(chunk, N), V)
            else:
                assert g is None
            make_g = a[10] if name == "xent_bwd_dx" else a[11]
            seen.append((name, make_g, a[-1]))
        _chunk_work(name, dev, *a, ops=ops)

    monkeypatch.setattr(xent, "_launch", launch)
    monkeypatch.setattr(xent, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(xent, "TF32_CHUNK", chunk)
    monkeypatch.setattr(xent, "BWD_CHUNK", 2 * chunk)  # not this route's
    rng = np.random.default_rng(N * V + E)
    x = torch.from_numpy(rng.standard_normal((N, E), np.float32))
    w = torch.from_numpy(rng.standard_normal((E, V), np.float32) / E)
    lab = torch.from_numpy(rng.integers(-1, V + 1, N))
    dl = torch.from_numpy(rng.standard_normal(N, np.float32))
    _, lse = xent.xent_fwd_plain(x, w, lab)
    dx, dw = xent.xent_bwd(x, w, lab, lse, dl, want_dx=want_dx,
                           want_dw=want_dw)
    code = xent.ROUTES.index("wgmma_tf32")
    names = [n for n, w_ in (("xent_bwd_dx", want_dx),
                             ("xent_bwd_dw", want_dw)) if w_]
    assert seen == [(n, int(n == "xent_bwd_dx" or not want_dx), code)
                    for _ in range(-(-N // chunk)) for n in names]
    for got, plain in ((dx, xent.xent_bwd_dx_plain),
                       (dw, xent.xent_bwd_dw_plain)):
        if got is None:
            continue
        want_ = plain(x, w, lab, lse, dl)
        err = float((got - want_).abs().max())
        assert got.dtype == torch.float32
        assert err <= 1e-5 * float(want_.abs().max()), (plain.__name__, err)


def _stat_fold(z, lab, tile):
    """(m, l, t) of each row of z [N, V] over each ``tile``-column tile,
    [3, ceil(V / tile), N], as the wgmma routes' epilogue writes them:
    columns past V left out, t the label's logit in its tile, else 0."""
    N, V = z.shape
    nt = -(-V // tile)
    zp = torch.full((N, nt * tile), xent.NEG_INF)
    zp[:, :V] = z
    zt = zp.view(N, nt, tile)
    m = zt.max(dim=2).values
    l = torch.exp(zt - m[..., None]).sum(dim=2)
    cols = torch.arange(nt * tile).view(nt, tile)
    hit = (lab.long()[:, None, None] == cols[None]) & (cols < V)[None]
    t = torch.where(hit, zt, torch.zeros_like(zt)).sum(dim=2)
    return torch.stack([m, l, t]).transpose(1, 2)


# (N, E, V): the forward on wgmma_tf32 at a ragged N (37 rows, not a
# multiple of the 128-row tile), V a multiple of 4 but not of 128 (300:
# three tiles, the last of 44 columns), and one row.
TF32_FWD_CASES = [(37, 12, 256), (130, 16, 300), (1, 8, 132)]


@pytest.mark.parametrize("N,E,V", TF32_FWD_CASES, ids=lambda v: str(v))
def test_wgmma_tf32_forward_launch_arguments(monkeypatch, N, E, V):
    """The float32 forward on the wgmma_tf32 route, its launches standing
    in as torch: two ``xent_split`` launches before the forward's, W's
    (no lo part, W^T and its lo part at pitch E) and then x's (its lo
    part, no transposes); the forward's launch gets route code 3, the
    copies bit for bit (x's lo part, W^T, W^T's lo part), a [3,
    ceil(V / 128), N] workspace and splits = ceil(V / 128); the partials
    folded per 128-column tile from the copies and merged give the plain
    loss and lse within 1e-5 of their largest magnitude."""
    seen = []

    def launch(name, dev, *a, ops=None):
        if name == "xent_split":
            src, lo, hi_t, lo_t, R, C, ldt = a
            seen.append((name, tuple(src.shape), lo is None, hi_t is None,
                         lo_t is None, R, C, ldt))
            return _split_work(a)
        x, w, lab, part, loss, lse, n, e, v, splits, code = a
        x_lo, wt, wt_lo = ops
        seen.append((name, tuple(part.shape), (n, e, v), splits, code))
        low = lambda t: xent.tf32_split_plain(t)[1]  # noqa: E731
        assert torch.equal(x_lo, low(x)) and torch.equal(wt, w.t())
        assert torch.equal(wt_lo, low(w).t())
        part.copy_(_stat_fold(x @ wt.t(), lab, 128))
        m = part[0].max(dim=0).values
        s_ = m + torch.log(torch.clamp(
            (part[1] * torch.exp(part[0] - m)).sum(dim=0), min=1e-37))
        lse.copy_(s_)
        loss.copy_(s_ - part[2].sum(dim=0))

    monkeypatch.setattr(xent, "_launch", launch)
    monkeypatch.setattr(xent, "_device_kind", lambda t: "cuda")
    rng = np.random.default_rng(N * V + E)
    x = torch.from_numpy(rng.standard_normal((N, E), np.float32))
    w = torch.from_numpy(rng.standard_normal((E, V), np.float32)
                         / np.sqrt(E, dtype=np.float32))
    lab = torch.from_numpy(rng.integers(-1, V + 1, N))
    lab[-1] = V - 1
    xent.reset_launches()
    loss, lse = xent.xent_fwd(x, w, lab)
    nt = -(-V // 128)
    assert seen == [
        ("xent_split", (E, V), True, False, False, E, V, E),
        ("xent_split", (N, E), False, True, True, N, E, 0),
        ("xent_fwd", (3, nt, N), (N, E, V), nt,
         xent.ROUTES.index("wgmma_tf32"))]
    assert xent.ROUTE_LAUNCHES["xent_fwd"] == {
        r: int(r == "wgmma_tf32") for r in xent.ROUTES}
    for got, want in zip((loss, lse), xent.xent_fwd_plain(x, w, lab)):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


# Value families for the split: normal, wide exponents, and the edges
# (signed zeros, subnormals, the largest finite float32, values whose low
# 13 bits are all set or all clear).
def _split_values(kind, n=4096):
    rng = np.random.default_rng(7)
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "wide":
        return (rng.standard_normal(n) * np.exp2(
            rng.integers(-120, 120, n))).astype(np.float32)
    bits = np.array([0, 0x80000000, 1, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x3F801FFF, 0x3F802000, 0xBF800001, 0x00800000],
                    np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide", "edges"])
def test_tf32_split_plain_matches_bit_mask(kind):
    """``tf32_split_plain``: hi is x with its low 13 bits cleared, bit for
    bit as numpy's mask; lo = x - hi in float32, bit for bit; hi + lo
    gives x back exactly; |lo| < 2^-10 |x| for normal x (a subnormal's
    TF32 part may be 0, and lo then x itself)."""
    a = _split_values(kind)
    hi, lo = xent.tf32_split_plain(torch.from_numpy(a))
    want_hi = (a.view(np.int32) & ~0x1FFF).view(np.float32)
    assert np.array_equal(hi.numpy().view(np.int32), want_hi.view(np.int32))
    assert np.array_equal(lo.numpy().view(np.int32),
                          (a - want_hi).view(np.int32))
    assert np.array_equal((hi + lo).numpy(), a)
    normal = np.abs(a) >= np.finfo(np.float32).tiny
    assert np.all(np.abs(lo.numpy()[normal]) <= np.abs(a[normal]) * 2.0 ** -10)


def _trunc_tf32(a):
    """What the tensor core reads of float32 bits as TF32."""
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _three_products(a, b):
    """a b in the three-product form on truncated parts, as the kernels
    form it: hi = x (read truncated), lo = x - trunc(x) (read truncated),
    a_lo b_hi + a_hi b_lo + a_hi b_hi, each TF32 product exact in
    float64."""
    ah, bh = _trunc_tf32(a), _trunc_tf32(b)
    al = _trunc_tf32(a - ah)
    bl = _trunc_tf32(b - bh)
    f = lambda t: t.astype(np.float64)  # noqa: E731
    return f(al) * f(bh) + f(ah) * f(bl) + f(ah) * f(bh)


@pytest.mark.parametrize("scale", [0, 20, -30])
@pytest.mark.parametrize("seed", [1, 2])
def test_three_product_form_keeps_float32_accuracy(seed, scale):
    """Every product a b of random finite float32 operands (exponents
    spread over 2^±8 around 2^scale) taken in the three-product form on
    truncated parts is within 2^-18 |a b| of the float64 product (the
    dropped a_lo b_lo and the truncation of the lo parts are under 2^-19,
    flash_common.cuh); a sum of such products is within 2^-18 of the sum
    of |a b|.  TF32 alone misses by up to 2^-9."""
    rng = np.random.default_rng(seed)
    n = 1 << 16
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-8, 9, n) + scale)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-8, 9, n) - scale)
         ).astype(np.float32)
    exact = a.astype(np.float64) * b.astype(np.float64)
    err = np.abs(_three_products(a, b) - exact)
    assert np.all(err <= 2.0 ** -18 * np.abs(exact))
    one = np.abs(_trunc_tf32(a).astype(np.float64)
                 * _trunc_tf32(b).astype(np.float64) - exact)
    assert np.max(one / np.abs(exact)) > 2.0 ** -12
    rows = _three_products(a, b).reshape(64, -1).sum(axis=1)
    want = exact.reshape(64, -1).sum(axis=1)
    bound = 2.0 ** -18 * np.abs(exact).reshape(64, -1).sum(axis=1)
    assert np.all(np.abs(rows - want) <= bound)
