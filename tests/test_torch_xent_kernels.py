"""The port's CUDA fused linear + cross-entropy kernels against their plain
versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_xent_kernels.py -q

The CPU parity of the plain versions with the JAX package is
tests/test_torch_xent.py.  Tolerances: loss and lse within 1e-4 of the
largest |reference| (float32 sums in another order); dx and dW, which come
out in bf16, within 2^-7 of the largest |reference| (one bf16 rounding of
the largest element).
"""

import pytest
import torch

from torchmpi_tpu_torch.ops import xent

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

STAT_RTOL = 1e-4
GRAD_RTOL = 2.0 ** -7


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


def _inputs(dev, N, E, V, seed, x_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(N, E, generator=g, device=dev) * x_scale).bfloat16()
    w = (torch.randn(E, V, generator=g, device=dev) / E ** 0.5).bfloat16()
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    dl = torch.randn(N, generator=g, device=dev)
    return x, w, labels, dl


def _run_all(x, w, labels, dl):
    loss, lse = xent.xent_fwd(x, w, labels)
    return (loss, lse, xent.xent_bwd_dx(x, w, labels, lse, dl),
            xent.xent_bwd_dw(x, w, labels, lse, dl),
            *xent.xent_bwd(x, w, labels, lse, dl))


# (N, E, V): ragged N and V against the 128 x 128 tiles; E 40 and 36 are
# not multiples of the 32-deep step, and E 36 / V 333 are not multiples of
# 8 (the loaders' element-wise path); N 2500 spans two backward chunks.
CASES = [(300, 64, 1000), (77, 40, 333), (129, 36, 256), (2500, 64, 520)]


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


def test_two_calls_are_bitwise_equal(cuda):
    x, w, labels, dl = _inputs(cuda, 700, 128, 2000, seed=3)
    first = _run_all(x, w, labels, dl)
    second = _run_all(x, w, labels, dl)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_extreme_logits(cuda):
    """Logits in the hundreds: the online lse stays finite and agrees."""
    x, w, labels, dl = _inputs(cuda, 200, 64, 640, seed=4, x_scale=60.0)
    loss, lse = xent.xent_fwd(x, w, labels)
    ref_loss, ref_lse = xent.xent_fwd_plain(x, w, labels)
    assert torch.isfinite(loss).all() and float(ref_lse.abs().max()) > 100
    _close(loss, ref_loss, STAT_RTOL, "loss")
    _close(lse, ref_lse, STAT_RTOL, "lse")
    _close(xent.xent_bwd_dx(x, w, labels, lse, dl),
           xent.xent_bwd_dx_plain(x, w, labels, lse, dl), GRAD_RTOL, "dx")


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
    with pytest.raises(TypeError):  # float32 operands: no fallback
        xent.xent_fwd(x.float(), w.float(), labels)
    with pytest.raises(TypeError):
        xent.xent_fwd(x, w.half(), labels)
    with pytest.raises(ValueError):  # non-contiguous w
        xent.xent_fwd(x, w.t().contiguous().t(), labels)
    with pytest.raises(ValueError):  # mismatched shapes
        xent.xent_fwd(x, w[:31], labels)
    with pytest.raises(ValueError):  # tensors on two devices
        xent.xent_fwd(x, w, labels.cpu())
    _, lse = xent.xent_fwd(x, w, labels)
    with pytest.raises(TypeError):
        xent.xent_bwd_dw(x.float(), w.float(), labels, lse, dl)
