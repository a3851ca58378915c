"""The port's CUDA fused linear + cross-entropy kernels against their plain
versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_xent_kernels.py -q

The CPU parity of the plain versions with the JAX package is
tests/test_torch_xent.py.  Tolerances: loss and lse within 1e-4 of the
largest |reference| (float32 sums in another order); on bfloat16 operands
dx and dW, which come out in bf16, within 2^-7 of the largest |reference|
(one bf16 rounding of the largest element); on float32 operands (the
``wgmma_tf32`` and ``tf32x3`` routes) dx and dW within 1e-4 of the largest
|reference| as well: g is not rounded, and the three-product form keeps
f32's accuracy.
"""

import pytest
import torch

from torchmpi_tpu_torch.ops import xent

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# The launchers' route codes of the wgmma and wgmma_tf32 routes.
WGMMA = xent.ROUTES.index("wgmma")
WGMMA_TF32 = xent.ROUTES.index("wgmma_tf32")

STAT_RTOL = 1e-4
GRAD_RTOL = 2.0 ** -7
F32_GRAD_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol, what):
    tol = rtol * max(float(want.float().abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _inputs(dev, N, E, V, seed, x_scale=1.0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(N, E, generator=g, device=dev) * x_scale).to(dtype)
    w = (torch.randn(E, V, generator=g, device=dev) / E ** 0.5).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    dl = torch.randn(N, generator=g, device=dev)
    return x, w, labels, dl


def _offset(x, nbytes=8):
    """x's copy ``nbytes`` off a 16-byte boundary: TMA cannot read it, so
    every bf16 kernel takes the wmma route, and no loader reads it by
    16-byte vectors."""
    k = nbytes // x.element_size()
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    xo = buf[k:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 == nbytes
    return xo


def _run_all(x, w, labels, dl):
    loss, lse = xent.xent_fwd(x, w, labels)
    return (loss, lse, xent.xent_bwd_dx(x, w, labels, lse, dl),
            xent.xent_bwd_dw(x, w, labels, lse, dl),
            *xent.xent_bwd(x, w, labels, lse, dl))


# (N, E, V): ragged N and V against the 128 x 128 tiles; E 40 and 36 are
# not multiples of the 32-deep step, and E 36 / V 333 are not multiples of
# 8 (the loaders' element-wise path, and the backward's wmma route); N 2500
# spans two backward chunks.  On the backward's wgmma route (E and V
# multiples of 8): E at the flagship's width with V a multiple of 8 but not
# of the 256-wide tile; three backward chunks with a ragged last one; the
# smallest TMA box (64 x 8 x 8, one box holds every operand).
CASES = [(300, 64, 1000), (77, 40, 333), (129, 36, 256), (2500, 64, 520),
         (1000, 2048, 4104), (4100, 128, 2056), (64, 8, 8)]

# The route of each shape of CASES (xent._route), the forward's and the
# backward's alike: every operand here is allocated, so 16-byte aligned.
ROUTES = {(300, 64, 1000): "wgmma", (77, 40, 333): "wmma",
          (129, 36, 256): "wmma", (2500, 64, 520): "wgmma",
          (1000, 2048, 4104): "wgmma", (4100, 128, 2056): "wgmma",
          (64, 8, 8): "wgmma"}


@pytest.mark.parametrize("N,E,V", CASES, ids=lambda v: str(v))
def test_kernels_match_plain(cuda, N, E, V):
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=N + V)
    # Labels at the last column, at tile edges, -1 and past V.
    edges = [V - 1, 0, min(127, V - 1), min(128, V - 1), min(255, V - 1),
             V, V + 5, -1]
    labels[:len(edges)] = torch.tensor(edges, device=cuda)
    before = dict(xent.LAUNCHES)
    loss, lse, dx, dw, dx2, dw2 = _run_all(x, w, labels, dl)
    torch.cuda.synchronize()
    ref_loss, ref_lse = xent.xent_fwd_plain(x, w, labels)
    _close(loss, ref_loss, STAT_RTOL, "loss")
    _close(lse, ref_lse, STAT_RTOL, "lse")
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), GRAD_RTOL, "dx")
    _close(dw, xent.xent_bwd_dw_plain(x, w, labels, lse, dl), GRAD_RTOL, "dW")
    # One g per chunk for both gradients gives the same bits.
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == dw.dtype == torch.bfloat16
    # One count per wrapper call: each backward kernel ran in two calls.
    assert xent.LAUNCHES["xent_fwd"] == before["xent_fwd"] + 1
    for name in ("xent_bwd_dx", "xent_bwd_dw"):
        assert xent.LAUNCHES[name] == before[name] + 2


@pytest.mark.parametrize("N,E,V", CASES, ids=lambda v: str(v))
def test_backward_launches_count_on_their_route(cuda, N, E, V):
    """Each backward wrapper call counts one launch on the route its shape
    takes, and none on the other."""
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=N + E)
    _, lse = xent.xent_fwd(x, w, labels)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    xent.xent_bwd_dx(x, w, labels, lse, dl)
    xent.xent_bwd_dw(x, w, labels, lse, dl)
    xent.xent_bwd(x, w, labels, lse, dl)
    torch.cuda.synchronize()
    route = ROUTES[(N, E, V)]
    for name in ("xent_bwd_dx", "xent_bwd_dw"):
        counts = xent.ROUTE_LAUNCHES[name]
        assert {r: counts[r] - before[name][r] for r in counts} == {
            r: 2 * int(r == route) for r in xent.ROUTES}, name


@pytest.mark.parametrize("N,E,V", CASES, ids=lambda v: str(v))
def test_forward_launches_count_on_their_route(cuda, N, E, V):
    """Each forward call counts one launch on the route its shape takes,
    and none on the other."""
    x, w, labels, _ = _inputs(cuda, N, E, V, seed=N + 3 * E)
    before = dict(xent.ROUTE_LAUNCHES["xent_fwd"])
    xent.xent_fwd(x, w, labels)
    xent.xent_fwd(x, w, labels)
    torch.cuda.synchronize()
    route = ROUTES[(N, E, V)]
    counts = xent.ROUTE_LAUNCHES["xent_fwd"]
    assert {r: counts[r] - before[r] for r in counts} == {
        r: 2 * int(r == route) for r in xent.ROUTES}


# The forward's wgmma route (one 128 x 256 tile of z a block, its (m, l, t)
# folded from the accumulators): ragged V against the 256-column tile,
# ragged N against the 128-row tile, the smallest box, V below one tile,
# and the flagship's shape.
FWD_WGMMA_CASES = [(1000, 2048, 4104), (300, 64, 1000), (64, 8, 8),
                   (129, 64, 200), (8188, 2048, 32768)]


@pytest.mark.parametrize("N,E,V", FWD_WGMMA_CASES, ids=lambda v: str(v))
def test_forward_wgmma_route_matches_plain(cuda, N, E, V):
    x, w, labels, _ = _inputs(cuda, N, E, V, seed=2 * N + V)
    # Labels at the last column, at the 256-column tile's edges, in the
    # quad's other lanes (columns 1, 2, 9), -1 and past V.
    edges = [V - 1, 0, 1, 2, 9, min(255, V - 1), min(256, V - 1),
             min(257, V - 1), V, V + 5, -1]
    labels[:len(edges)] = torch.tensor(edges, device=cuda)
    before = dict(xent.ROUTE_LAUNCHES["xent_fwd"])
    loss, lse = xent.xent_fwd(x, w, labels)
    loss2, lse2 = xent.xent_fwd(x, w, labels)
    torch.cuda.synchronize()
    assert xent.ROUTE_LAUNCHES["xent_fwd"] == {
        "wgmma": before["wgmma"] + 2, "wmma": before["wmma"],
        "tf32x3": before["tf32x3"], "wgmma_tf32": before["wgmma_tf32"]}
    ref_loss, ref_lse = xent.xent_fwd_plain(x, w, labels)
    _close(loss, ref_loss, STAT_RTOL, "loss")
    _close(lse, ref_lse, STAT_RTOL, "lse")
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)


def test_offset_base_takes_the_wmma_route(cuda):
    """x 8 bytes off a 16-byte boundary (a slice of a larger buffer): TMA
    cannot read it, so the forward and the backward take the wmma route and
    agree with the plain versions; a launch that asks the wgmma route for
    it is refused and raises."""
    N, E, V = 300, 64, 1000
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=8)
    xo = _offset(x)
    assert xo.is_contiguous()
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    _, lse = xent.xent_fwd(xo, w, labels)
    dx, dw = xent.xent_bwd(xo, w, labels, lse, dl)
    torch.cuda.synchronize()
    for name, counts in xent.ROUTE_LAUNCHES.items():
        assert counts["wmma"] == before[name]["wmma"] + 1, name
        assert counts["wgmma"] == before[name]["wgmma"], name
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), GRAD_RTOL, "dx")
    _close(dw, xent.xent_bwd_dw_plain(x, w, labels, lse, dl), GRAD_RTOL, "dW")
    lab32 = labels.to(torch.int32)
    g = torch.empty(N, V, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError):
        xent._launch("xent_bwd_dx", cuda, xo, w, lab32, lse, dl, g,
                     torch.empty_like(x), N, E, V, 1, WGMMA)
    part = torch.empty(3, -(-V // 256), N, device=cuda)
    with pytest.raises(RuntimeError):
        xent._launch("xent_fwd", cuda, xo, w, lab32, part, torch.empty_like(
            lse), torch.empty_like(lse), N, E, V, part.shape[1], WGMMA)


def test_two_calls_are_bitwise_equal(cuda):
    x, w, labels, dl = _inputs(cuda, 700, 128, 2000, seed=3)
    first = _run_all(x, w, labels, dl)
    second = _run_all(x, w, labels, dl)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["wgmma", "wmma", "wgmma_tf32", "tf32x3"])
def test_extreme_logits(cuda, route):
    """Logits in the hundreds: the lse stays finite and agrees, on every
    route (the float32 ones on float32 operands, x 4 bytes off for
    tf32x3).  On float32 operands dx is held end to end, from the
    kernels' own lse against the plain dx from the plain lse: the forward
    and the backward form z in one order, so their softmax agrees with
    itself, while z itself is off the plain float32 z by about 1e-6 of
    |z|, which a plain dx taken at the kernel's lse turns into an error
    of about that times |z| in dx (scripts/torch_xent_f32_accuracy.py
    measures both forms against float64)."""
    f32 = route in ("wgmma_tf32", "tf32x3")
    x, w, labels, dl = _inputs(cuda, 200, 64, 640, seed=4, x_scale=60.0,
                               dtype=torch.float32 if f32 else torch.bfloat16)
    if route in ("wmma", "tf32x3"):
        x = _offset(x, 4 if f32 else 8)
    before = dict(xent.ROUTE_LAUNCHES["xent_fwd"])
    loss, lse = xent.xent_fwd(x, w, labels)
    assert xent.ROUTE_LAUNCHES["xent_fwd"][route] == before[route] + 1
    ref_loss, ref_lse = xent.xent_fwd_plain(x, w, labels)
    assert torch.isfinite(loss).all() and float(ref_lse.abs().max()) > 100
    _close(loss, ref_loss, STAT_RTOL, "loss")
    _close(lse, ref_lse, STAT_RTOL, "lse")
    _close(xent.xent_bwd_dx(x, w, labels, lse, dl),
           xent.xent_bwd_dx_plain(x, w, labels, ref_lse if f32 else lse, dl),
           F32_GRAD_RTOL if f32 else GRAD_RTOL, "dx")


def test_autograd_matches_dense_loss(cuda):
    """The fused loss and its gradients against the dense two-call loss
    (a bf16 product, then cross_entropy in float32) on the same inputs."""
    x, w, labels, _ = _inputs(cuda, 1000, 128, 3000, seed=5)
    wgt = torch.rand(1000, device=cuda)
    grads = []
    for fused in (True, False):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        if fused:
            loss = xent.fused_linear_cross_entropy(xs, ws, labels)
        else:
            loss = torch.nn.functional.cross_entropy(
                (xs.float() @ ws.float()), labels, reduction="none")
        (loss * wgt).sum().backward()
        grads.append((loss.detach(), xs.grad, ws.grad))
    for a, b, (what, rtol) in zip(*grads, (("loss", STAT_RTOL),
                                           ("dx", 2 * GRAD_RTOL),
                                           ("dW", 2 * GRAD_RTOL))):
        _close(a, b, rtol, what)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, w, labels, dl = _inputs(cuda, 16, 32, 64, seed=6)
    with pytest.raises(TypeError):  # mixed operands: nothing is cast
        xent.xent_fwd(x.float(), w, labels)
    with pytest.raises(TypeError):
        xent.xent_fwd(x, w.half(), labels)
    with pytest.raises(ValueError):  # non-contiguous w
        xent.xent_fwd(x, w.t().contiguous().t(), labels)
    with pytest.raises(ValueError):  # mismatched shapes
        xent.xent_fwd(x, w[:31], labels)
    with pytest.raises(ValueError):  # tensors on two devices
        xent.xent_fwd(x, w, labels.cpu())
    _, lse = xent.xent_fwd(x, w, labels)
    with pytest.raises(TypeError):  # float16 operands: no kernel takes them
        xent.xent_bwd_dw(x.half(), w.half(), labels, lse, dl)
    # A route code outside xent.ROUTES: refused, nothing falls back.
    part = torch.empty(3, 1, 16, device=cuda)
    with pytest.raises(RuntimeError):
        xent._launch("xent_fwd", cuda, x, w, labels.to(torch.int32), part,
                     torch.empty_like(lse), torch.empty_like(lse), 16, 32,
                     64, 1, len(xent.ROUTES))


# Float32 x and w: the JAX test's shape (tests/test_xent.py), a ragged
# one, E and V not multiples of 4 (no row of x or w starts on a 16-byte
# boundary: the loaders' element path), a wgmma shape of the bf16 cases,
# and the flagship's head.  The forward and the backward take wgmma_tf32
# where E and V are multiples of 4 (every operand here is allocated, so
# 16-byte aligned), else tf32x3.
F32_CASES = [(64, 8, 16), (129, 64, 200), (129, 63, 201),
             (1000, 2048, 4104), (8188, 2048, 32768)]
# The wgmma_tf32 route at ragged shapes: N not a multiple of the 128-row
# tile, V not a multiple of 128 or 256, E and V multiples of 4 but not of
# 8 (no bf16 TMA route there), two chunks with a short last one (N 2500),
# and a last chunk of 4 rows (N 4100, whose transposed copies' pitch is 4).
TF32_RAGGED = [(300, 64, 1000), (77, 40, 332), (2500, 64, 520),
               (4100, 128, 2056)]
# Float32 shapes whose row pitches TMA cannot read: E or V not a multiple
# of 4 (V odd; V 2 mod 4; E 2 mod 4).
F32_ODD_PITCH = [(77, 40, 333), (129, 36, 254), (129, 38, 256)]


def _f32_route(name, E, V):
    return "tf32x3" if E % 4 or V % 4 else "wgmma_tf32"


@pytest.mark.parametrize("N,E,V", F32_CASES + TF32_RAGGED + F32_ODD_PITCH,
                         ids=lambda v: str(v))
def test_float32_kernels_match_plain(cuda, N, E, V):
    """The three kernels on float32 operands: within 1e-4 of the largest
    |reference| of the plain float32 versions, dx and dW in float32, two
    calls bitwise, dx and dW from a g each launch forms alone bitwise equal
    to those from the g formed once for both, every launch on its route
    (wgmma_tf32 where TMA can read the operands, forward and backward,
    else tf32x3)."""
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=N + 7 * V,
                               dtype=torch.float32)
    edges = [V - 1, 0, min(127, V - 1), min(128, V - 1), V, -1]
    labels[:len(edges)] = torch.tensor(edges, device=cuda)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    first = _run_all(x, w, labels, dl)
    second = _run_all(x, w, labels, dl)
    torch.cuda.synchronize()
    for name, counts in xent.ROUTE_LAUNCHES.items():
        n = 2 if name == "xent_fwd" else 4
        assert {r: counts[r] - before[name][r] for r in counts} == {
            r: n * int(r == _f32_route(name, E, V)) for r in xent.ROUTES}, name
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    loss, lse, dx, dw, dx2, dw2 = first
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == dw.dtype == torch.float32
    ref_loss, ref_lse = xent.xent_fwd_plain(x, w, labels)
    _close(loss, ref_loss, STAT_RTOL, "loss")
    _close(lse, ref_lse, STAT_RTOL, "lse")
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dx")
    _close(dw, xent.xent_bwd_dw_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dW")


@pytest.mark.parametrize("N,E,V", F32_CASES + TF32_RAGGED + F32_ODD_PITCH,
                         ids=lambda v: str(v))
def test_float32_autograd_matches_dense_loss(cuda, N, E, V):
    """fused_linear_cross_entropy on float32 x and w, and its gradients,
    against the dense float32 loss (x @ w, then cross_entropy) on the same
    inputs, every launch on its route."""
    x, w, labels, _ = _inputs(cuda, N, E, V, seed=N + 5 * V,
                              dtype=torch.float32)
    wgt = torch.rand(N, device=cuda)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    grads = []
    for fused in (True, False):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        if fused:
            loss = xent.fused_linear_cross_entropy(xs, ws, labels)
        else:
            loss = torch.nn.functional.cross_entropy(xs @ ws, labels,
                                                     reduction="none")
        (loss * wgt).sum().backward()
        grads.append((loss.detach(), xs.grad, ws.grad))
    torch.cuda.synchronize()
    for name, counts in xent.ROUTE_LAUNCHES.items():
        assert {r: counts[r] - before[name][r] for r in counts} == {
            r: int(r == _f32_route(name, E, V)) for r in xent.ROUTES}, name
    for a, b, what in zip(*grads, ("loss", "dx", "dW")):
        assert a.dtype == torch.float32
        _close(a, b, STAT_RTOL if what == "loss" else F32_GRAD_RTOL, what)


@pytest.mark.parametrize("which", ["x", "w"])
def test_float32_offset_base_takes_the_element_path(cuda, which):
    """float32 x or w 4 bytes off a 16-byte boundary (a slice of a larger
    buffer), E and V multiples of 4: the tf32x3 kernels read that operand
    element by element and agree with the plain versions within 1e-4,
    every launch on tf32x3."""
    N, E, V = 300, 64, 1000
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=11, dtype=torch.float32)
    if which == "x":
        x = _offset(x, 4)
    else:
        w = _offset(w, 4)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    loss, lse = xent.xent_fwd(x, w, labels)
    dx, dw = xent.xent_bwd(x, w, labels, lse, dl)
    torch.cuda.synchronize()
    for name, counts in xent.ROUTE_LAUNCHES.items():
        assert {r: counts[r] - before[name][r] for r in counts} == {
            r: int(r == "tf32x3") for r in xent.ROUTES}, name
    ref_loss, ref_lse = xent.xent_fwd_plain(x, w, labels)
    _close(loss, ref_loss, STAT_RTOL, "loss")
    _close(lse, ref_lse, STAT_RTOL, "lse")
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dx")
    _close(dw, xent.xent_bwd_dw_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dW")


@pytest.mark.parametrize("N,E,V", TF32_RAGGED, ids=lambda v: str(v))
def test_wgmma_tf32_route_matches_plain(cuda, N, E, V):
    """The float32 backward on wgmma_tf32 at ragged shapes: dx and dW
    within 1e-4 of the largest |reference| of the plain float32 versions,
    two calls bitwise, dx and dW from a g each launch forms alone bitwise
    equal to those from the g formed once for both, every backward launch
    on wgmma_tf32."""
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=3 * N + V,
                               dtype=torch.float32)
    edges = [V - 1, 0, min(127, V - 1), min(128, V - 1), V, -1]
    labels[:len(edges)] = torch.tensor(edges, device=cuda)
    _, lse = xent.xent_fwd(x, w, labels)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    dx = xent.xent_bwd_dx(x, w, labels, lse, dl)
    dw = xent.xent_bwd_dw(x, w, labels, lse, dl)
    once = xent.xent_bwd(x, w, labels, lse, dl)
    again = xent.xent_bwd(x, w, labels, lse, dl)
    torch.cuda.synchronize()
    for name in ("xent_bwd_dx", "xent_bwd_dw"):
        counts = xent.ROUTE_LAUNCHES[name]
        assert {r: counts[r] - before[name][r] for r in counts} == {
            r: 3 * int(r == "wgmma_tf32") for r in xent.ROUTES}, name
    assert torch.equal(dx, once[0]) and torch.equal(dw, once[1])
    assert torch.equal(once[0], again[0]) and torch.equal(once[1], again[1])
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dx")
    _close(dw, xent.xent_bwd_dw_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dW")


@pytest.mark.parametrize("N,E,V", F32_ODD_PITCH, ids=lambda v: str(v))
def test_float32_odd_pitch_takes_tf32x3(cuda, N, E, V):
    """A float32 forward and backward whose operands TMA cannot read take
    tf32x3, counted, and agree with the plain versions within 1e-4."""
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=N * V + E,
                               dtype=torch.float32)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    loss, lse = xent.xent_fwd(x, w, labels)
    dx, dw = xent.xent_bwd(x, w, labels, lse, dl)
    torch.cuda.synchronize()
    _close(loss, xent.xent_fwd_plain(x, w, labels)[0], STAT_RTOL, "loss")
    for name in xent.KERNELS:
        counts = xent.ROUTE_LAUNCHES[name]
        assert {r: counts[r] - before[name][r] for r in counts} == {
            r: int(r == "tf32x3") for r in xent.ROUTES}, name
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dx")
    _close(dw, xent.xent_bwd_dw_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dW")


def test_wgmma_tf32_launch_is_refused_without_its_operands(cuda):
    """A launch, backward or forward, that asks the wgmma_tf32 route for
    operands TMA cannot read (x 4 bytes off), or without the K-major
    copies it needs, or (the forward) with partials not one per 128-column
    tile, is refused and raises: nothing falls back."""
    N, E, V = 300, 64, 1000
    x, w, labels, dl = _inputs(cuda, N, E, V, seed=12, dtype=torch.float32)
    _, lse = xent.xent_fwd(x, w, labels)
    lab32 = labels.to(torch.int32)
    ops = xent._tf32_workspace(w, N, True, True)
    xent._launch("xent_split", cuda, x, *ops[:3], N, E, xent._tf32_pitch(N))
    g = torch.empty(N, V, device=cuda)
    dx = torch.empty_like(x)
    args = (lab32, lse, dl, g, dx, N, E, V, 1, WGMMA_TF32)
    xent._launch("xent_bwd_dx", cuda, x, w, *args, ops=ops)  # accepted
    torch.cuda.synchronize()
    _close(dx, xent.xent_bwd_dx_plain(x, w, labels, lse, dl), F32_GRAD_RTOL,
           "dx")
    with pytest.raises(RuntimeError):
        xent._launch("xent_bwd_dx", cuda, _offset(x, 4), w, *args, ops=ops)
    with pytest.raises(RuntimeError):
        xent._launch("xent_bwd_dx", cuda, x, w, *args)
    no_wt = [None if k == "wt" else t for k, t in zip(xent.TF32_OPS, ops)]
    with pytest.raises(RuntimeError):
        xent._launch("xent_bwd_dx", cuda, x, w, *args, ops=no_wt)
    with pytest.raises(RuntimeError):
        xent._launch("xent_bwd_dw", cuda, x, w, lab32, lse, dl, g, None,
                     torch.empty_like(w), N, E, V, 1, 1, 1, WGMMA_TF32,
                     ops=[None if k == "gt" else t
                          for k, t in zip(xent.TF32_OPS, ops)])
    # The forward: accepted with its copies and ceil(V / 128) partials;
    # refused for x off alignment, without a copy, or with other splits.
    fops = xent._fwd_tf32_copies(x, w)
    nt = -(-V // 128)
    part = torch.empty(3, nt + 1, N, device=cuda)
    loss, lse2 = torch.empty_like(lse), torch.empty_like(lse)
    fargs = (lab32, part, loss, lse2, N, E, V)
    xent._launch("xent_fwd", cuda, x, w, *fargs, nt, WGMMA_TF32, ops=fops)
    torch.cuda.synchronize()
    _close(lse2, lse, STAT_RTOL, "lse")
    with pytest.raises(RuntimeError):
        xent._launch("xent_fwd", cuda, _offset(x, 4), w, *fargs, nt,
                     WGMMA_TF32, ops=fops)
    with pytest.raises(RuntimeError):
        xent._launch("xent_fwd", cuda, x, w, *fargs, nt, WGMMA_TF32)
    with pytest.raises(RuntimeError):
        xent._launch("xent_fwd", cuda, x, w, *fargs, nt, WGMMA_TF32,
                     ops=[fops[0], None, fops[2]])
    with pytest.raises(RuntimeError):
        xent._launch("xent_fwd", cuda, x, w, *fargs, nt + 1, WGMMA_TF32,
                     ops=fops)
