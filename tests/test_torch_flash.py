"""The port's flash attention (torchmpi_tpu_torch.ops.flash) and dense
oracle (parallel.sequence) against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function (its Pallas
kernels in interpret mode, as tests/test_flash.py runs them) and the
port's counterpart (the plain PyTorch versions of the CUDA kernels, which a
wrapper takes for CPU tensors).  float32 throughout; tolerance
rtol = atol = 2e-5, as in the JAX package's own flash tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmpi_tpu.ops import flash as jflash
from torchmpi_tpu.parallel import sequence as jseq
import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.ops import flash as tflash
from torchmpi_tpu_torch.parallel import sequence as tseq

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    """Neither package's runtime left running by an earlier test file in
    this worker: both sides of every comparison here read their default
    Config (or the one a test sets up itself), and this module leaves
    nothing running either."""
    jmpi.stop()
    tmpi.stop()
    yield
    jmpi.stop()
    tmpi.stop()


TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, T, H, Hkv, D, scale=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, H, D) * scale).astype(np.float32)
    k = (rng.randn(B, T, Hkv, D) * scale).astype(np.float32)
    v = (rng.randn(B, T, Hkv, D) * scale).astype(np.float32)
    w = rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, w


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


# (T, block, window): GQA 4/2 everywhere; T=40 is not a multiple of the
# 128-row tile alignment; window 24 spans several 32-row blocks.
GRAD_CASES = [(40, 16, None), (128, 32, 24)]


@pytest.mark.parametrize("T,block,window", GRAD_CASES,
                         ids=["T40-causal", "T128-window24"])
def test_flash_forward_and_grads_match_jax(T, block, window):
    q, k, v, w = _inputs(11, 1, T, 4, 2, 16, scale=0.7)

    def jf(q, k, v):
        return jflash.flash_attention_grad(q, k, v, causal=True,
                                           block_q=block, block_k=block,
                                           window=window)

    o_j, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g_j = vjp(jnp.asarray(w))

    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o_t = tflash.flash_attention_grad(*xs, causal=True, block_q=block,
                                      block_k=block, window=window)
    o_t.backward(torch.from_numpy(w))
    _close(o_t.detach(), o_j, "o")
    for x, g, name in zip(xs, g_j, "qkv"):
        _close(x.grad, g, f"d{name}")


def test_flash_forward_noncausal_offsets_match_jax():
    """Non-causal MHA, and causal with q / kv offsets (rows with no valid
    key must read as zeros in both)."""
    q, k, v, _ = _inputs(12, 2, 40, 2, 2, 16)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=False, block_q=8, block_k=8)
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=False, block_q=8, block_k=8)
    _close(got, want, "non-causal")
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, q_offset=0, kv_offset=16,
                                 block_q=8, block_k=8)
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=True, q_offset=0, kv_offset=16,
                                  block_q=8, block_k=8)
    _close(got, want, "offsets")
    assert float(got[:, :16].abs().max()) == 0.0


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_reference_attention_matches_jax(window, hkv):
    q, k, v, _ = _inputs(13, 2, 24, 4, hkv, 8)
    got = tseq.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window)
    want = jseq.reference_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=True, window=window)
    _close(got, want)


def test_causal_window_mask_matches_jax():
    qp, kp = np.arange(5, 17), np.arange(0, 20)
    for window in (None, 1, 4):
        got = tseq.causal_window_mask(torch.from_numpy(qp),
                                      torch.from_numpy(kp), window)
        want = jseq.causal_window_mask(jnp.asarray(qp), jnp.asarray(kp),
                                       window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_kernels_match_jax_bwd():
    """The plain versions of the two backward kernels, fed the JAX
    forward's lse, against the JAX package's flash_attention_bwd."""
    q, k, v, do = _inputs(14, 1, 48, 4, 2, 16, scale=0.7)
    kw = dict(causal=True, scale=0.25, window=20)
    num, m, l = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                       return_residuals=True, block_q=16,
                                       block_k=16, **kw)
    lse = np.asarray(jflash.lse_from_residuals(m, l))
    o = np.asarray(num) / np.moveaxis(np.where(l > 0, l, 1.0), 1, 2)[..., None]
    dvec = np.einsum("bqhd,bqhd->bhq", do, o).astype(np.float32)
    want = jflash.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do, lse,
                                                         dvec)),
                                      block_q=16, block_k=16, **kw)
    t = [torch.from_numpy(np.array(a, np.float32))
         for a in (q, k, v, do, lse, dvec)]
    got_lse = tflash.flash_fwd(*t[:3], **kw)[1]
    _close(got_lse, lse, "lse")
    got = (tflash.flash_bwd_dq(*t, **kw), *tflash.flash_bwd_dkv(*t, **kw))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, name)


def test_lse_from_residuals_matches_jax():
    m = np.array([[[0.5, -1e30, 3.0]]], np.float32)
    l = np.array([[[2.0, 0.0, 1e-3]]], np.float32)
    got = tflash.lse_from_residuals(torch.from_numpy(m), torch.from_numpy(l))
    want = jflash.lse_from_residuals(jnp.asarray(m), jnp.asarray(l))
    _close(got, want)


def test_helpers_match_jax():
    for h, hkv in ((8, 8), (8, 2), (8, 1)):
        assert tflash._gqa_group(h, hkv) == jflash._gqa_group(h, hkv)
    for fn in (tflash._gqa_group, jflash._gqa_group):
        with pytest.raises(ValueError):
            fn(8, 3)
    for args in ((4, False), (0, True)):
        for fn in (tflash._check_window, jflash._check_window):
            with pytest.raises(ValueError):
                fn(*args)


def test_prescale_keeps_forward_and_grads():
    """Config.flash_prescale folds the scale into q; in float32 the
    forward and gradients stay within rounding of the unscaled path."""
    q, k, v, w = _inputs(15, 1, 40, 4, 2, 16)
    out = []
    for prescale in (False, True):
        tmpi.init(device="cpu", flash_prescale=prescale)
        try:
            xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
            o = tflash.flash_attention_grad(*xs, causal=True, window=12)
            o.backward(torch.from_numpy(w))
            out.append([o.detach()] + [x.grad for x in xs])
        finally:
            tmpi.stop()
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_path_without_launching():
    q, k, v, _ = _inputs(16, 1, 16, 2, 2, 8)
    before = dict(tflash.LAUNCHES)
    o = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert tflash.LAUNCHES == before
    # The TPU tiling arguments are accepted and change nothing.
    o_tiled = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=True, block_q=8, block_k=4)
    assert torch.equal(o, o_tiled)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(TypeError):
        tflash.flash_fwd(*t, scale=1.0, causal=True,
                         q_offset=torch.tensor(0))
    with pytest.raises(ValueError):
        tflash.flash_bwd_dq(*t, t[0], torch.zeros(1, 2, 15),
                            torch.zeros(1, 2, 15), scale=1.0, causal=True)
    with pytest.raises(ValueError):
        tflash.flash_fwd(t[0], t[1][:, :, :1].repeat(1, 1, 3, 1),
                         t[2][:, :, :1].repeat(1, 1, 3, 1), scale=1.0,
                         causal=True)
