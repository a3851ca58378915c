"""The port's bf16 flash attention against the JAX package on the CPU.

The same numpy-seeded bf16 inputs go through the JAX functions (their
Pallas kernels in interpret mode, as tests/test_flash.py runs them) and the
port's (the plain PyTorch versions, which the kernel wrappers take for CPU
tensors): ``flash_attention`` with and without residuals,
``flash_attention_bwd`` and ``flash_attention_grad``.  Both round P to v's
dtype before P V and dS to k's / q's dtype before dS K and dS^T Q
(torchmpi_tpu/ops/flash.py:321, :407, :478), so the port's result is
JAX's up to summation order and where the rounding of P lands (JAX rounds
P against each kv block's running max, the plain version against the
row's final max).

Tolerance: max |port - JAX| <= 2^-7 max |JAX| (one bf16 ulp of the
largest element) on every output, whose dtypes must be JAX's; and JAX's
own 0.05 bar (tests/test_flash.py::test_flash_bf16) against the float32
oracle on the bf16-exact inputs.  The kernels' bf16 route on the card is
held to the same plain versions in tests/test_torch_flash_bf16_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.ops import flash as jflash
from torchmpi_tpu_torch.ops import flash as tflash

torch.set_num_threads(2)

ULP = 2.0 ** -7  # one bf16 ulp of max |ref|
ORACLE_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
    jmpi.stop()
    tmpi.stop()


# (B, T, H, Hkv, D, window, block): test_flash_bf16's causal case, a GQA
# case and a windowed one.
CASES = {
    "jax-test-1x32x2x8": (1, 32, 2, 2, 8, None, 16),
    "gqa-4-2": (1, 32, 4, 2, 16, None, 16),
    "window-12": (1, 48, 2, 1, 16, 12, 16),
}


def _bf16(a):
    """numpy float32 values rounded to bf16 (both packages' inputs)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, B, T, H, Hkv, D):
    rng = np.random.RandomState(seed)
    q = _bf16(rng.randn(B, T, H, D))
    k = _bf16(rng.randn(B, T, Hkv, D))
    v = _bf16(rng.randn(B, T, Hkv, D))
    w = _bf16(rng.randn(B, T, H, D))
    return q, k, v, w


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what):
    """Same dtype name, and within one bf16 ulp of max |want|."""
    gd = str(got.dtype).replace("torch.", "")
    assert gd == str(want.dtype), f"{what}: dtype {gd} != {want.dtype}"
    g, w = _np(got), _np(want)
    err = float(np.abs(g - w).max())
    bound = ULP * float(np.abs(w).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _oracle(q, k, v, window):
    """Float32 dense causal attention (GQA by repeat) in numpy."""
    B, T, H, D = q.shape
    rep = H // k.shape[2]
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(D)
    i, j = np.arange(T)[:, None], np.arange(T)[None, :]
    keep = j <= i
    if window is not None:
        keep &= i - j < window
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vr)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_matches_jax(case):
    B, T, H, Hkv, D, window, blk = CASES[case]
    q, k, v, _ = _inputs(15, B, T, H, Hkv, D)
    kw = dict(causal=True, window=window)
    o_j = jflash.flash_attention(_j(q), _j(k), _j(v), block_q=blk,
                                 block_k=blk, **kw)
    o_t = tflash.flash_attention(_t(q), _t(k), _t(v), **kw)
    _close(o_t, o_j, "o")
    # JAX's own bar against the float32 oracle on the same inputs.
    ref = _oracle(q, k, v, window)
    np.testing.assert_allclose(_np(o_t), ref, rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_residuals_match_jax(case):
    B, T, H, Hkv, D, window, blk = CASES[case]
    q, k, v, _ = _inputs(16, B, T, H, Hkv, D)
    kw = dict(causal=True, window=window, return_residuals=True)
    num_j, m_j, l_j = jflash.flash_attention(_j(q), _j(k), _j(v),
                                             block_q=blk, block_k=blk, **kw)
    num_t, m_t, l_t = tflash.flash_attention(_t(q), _t(k), _t(v), **kw)
    for got, want, name in ((num_t, num_j, "num"), (m_t, m_j, "m"),
                            (l_t, l_j, "l")):
        _close(got, want, name)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_bwd_matches_jax(case):
    B, T, H, Hkv, D, window, blk = CASES[case]
    q, k, v, w = _inputs(17, B, T, H, Hkv, D)
    scale = 1.0 / np.sqrt(D)
    kw = dict(causal=True, window=window, scale=scale)
    # One lse and D for both: JAX's residual forward, D = dO . O.
    num, m, l = jflash.flash_attention(_j(q), _j(k), _j(v),
                                       return_residuals=True, block_q=blk,
                                       block_k=blk, **kw)
    lse = np.asarray(jflash.lse_from_residuals(m, l))
    o = np.asarray(num) / np.moveaxis(np.where(np.asarray(l) > 0,
                                               np.asarray(l), 1.0),
                                      1, 2)[..., None]
    dvec = np.einsum("bqhd,bqhd->bhq", w, o).astype(np.float32)
    g_j = jflash.flash_attention_bwd(_j(q), _j(k), _j(v), _j(w),
                                     jnp.asarray(lse), jnp.asarray(dvec),
                                     block_q=blk, block_k=blk, **kw)
    g_t = tflash.flash_attention_bwd(_t(q), _t(k), _t(v), _t(w),
                                     torch.from_numpy(lse),
                                     torch.from_numpy(dvec), **kw)
    for got, want, name in zip(g_t, g_j, ("dq", "dk", "dv")):
        _close(got, want, name)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_grad_matches_jax(case):
    B, T, H, Hkv, D, window, blk = CASES[case]
    q, k, v, w = _inputs(18, B, T, H, Hkv, D)
    kw = dict(causal=True, window=window)

    def jf(q, k, v):
        return jflash.flash_attention_grad(q, k, v, block_q=blk,
                                           block_k=blk, **kw)

    o_j, vjp = jax.vjp(jf, _j(q), _j(k), _j(v))
    g_j = vjp(_j(w))
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    o_t = tflash.flash_attention_grad(*xs, **kw)
    o_t.backward(_t(w))
    _close(o_t, o_j, "o")
    for x, g, name in zip(xs, g_j, ("dq", "dk", "dv")):
        _close(x.grad, g, name)


def test_bf16_rounds_p_and_ds():
    """The plain versions round P and dS on bf16 operands only: on the
    same bf16-exact values in float32 they differ from the bf16 call,
    which the float32 route (every rounding the identity) does not."""
    B, T, H, Hkv, D, window, _ = CASES["gqa-4-2"]
    q, k, v, w = _inputs(19, B, T, H, Hkv, D)
    kw = dict(scale=D ** -0.5, causal=True, window=window)
    f32 = [torch.from_numpy(a) for a in (q, k, v)]
    bf = [_t(a) for a in (q, k, v)]
    num32, m32, l32 = tflash.flash_fwd_residual_plain(*f32, **kw)
    num16, m16, l16 = tflash.flash_fwd_residual_plain(*bf, **kw)
    assert torch.equal(m32, m16) and torch.equal(l32, l16)
    assert not torch.equal(num32, num16)
    assert (num32 - num16).abs().max() <= ULP * num32.abs().max()
    o, lse = tflash.flash_fwd_plain(*bf, **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    do = torch.from_numpy(w)
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o.float())
    dq16 = tflash.flash_bwd_dq_plain(*bf, do, lse, dvec, **kw)
    dq32 = tflash.flash_bwd_dq_plain(*f32, do, lse, dvec, **kw)
    assert dq16.dtype == torch.float32 and not torch.equal(dq16, dq32)
    dk16, dv16 = tflash.flash_bwd_dkv_plain(*bf, do, lse, dvec, **kw)
    dk32, dv32 = tflash.flash_bwd_dkv_plain(*f32, do, lse, dvec, **kw)
    assert not torch.equal(dk16, dk32)
    assert torch.equal(dv16, dv32)  # P V^T's P stays float32 (dO is f32)


def test_route_of_names_the_dtypes():
    """The kernels' route by q / k / v's dtype; float16 and mixed dtypes
    raise by name (the check the card's launches make first)."""
    f = torch.zeros(1, 16, 1, 16)
    b = f.to(torch.bfloat16)
    assert tflash.route_of("flash_fwd", f, f, f) == "tf32x3"
    assert tflash.route_of("flash_fwd", b, b, b) == "bf16"
    with pytest.raises(TypeError, match="float16"):
        tflash.route_of("flash_fwd", *(f.half(),) * 3)
    with pytest.raises(TypeError, match="bfloat16 / torch.float32"):
        tflash.route_of("flash_bwd_dq", b, b, f)
    assert set(tflash.ROUTE_LAUNCHES["flash_fwd"]) == {"tf32x3", "bf16"}
