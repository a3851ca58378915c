"""The port's fused linear + cross-entropy (torchmpi_tpu_torch.ops.xent)
against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function (its Pallas
kernels in interpret mode with small explicit blocks, as tests/test_xent.py
runs them) and the port's counterpart (the plain PyTorch versions of the
CUDA kernels, which a wrapper takes for CPU tensors).  Each test states its
tolerance.  The last tests check, on the CPU, the wrappers' chunked
backward schedule and the forward kernel's split-and-merge order of
operations, with the launches replaced by torch models of the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.ops.xent import fused_linear_cross_entropy as jax_xent
import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.models import TransformerLM
from torchmpi_tpu_torch.ops import xent

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


BLOCKS = dict(block_n=8, block_v=16)


def _rand(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _labels(n, v, seed):
    return np.random.RandomState(seed).randint(0, v, n).astype(np.int32)


def _jax_loss_and_grads(x, w, labels, wgt, dtype=jnp.float32, **blocks):
    def f(x, w):
        return (jax_xent(x, w, jnp.asarray(labels), **blocks)
                * jnp.asarray(wgt)).sum()

    loss = jax_xent(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                    jnp.asarray(labels), **blocks)
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x, dtype),
                                         jnp.asarray(w, dtype))
    return loss, gx, gw


def _port_loss_and_grads(x, w, labels, wgt, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = tmpi.ops.fused_linear_cross_entropy(
        xt, wt, torch.from_numpy(labels).long())
    (loss * torch.from_numpy(wgt)).sum().backward()
    return loss.detach(), xt.grad, wt.grad


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


# (N, E, V): aligned with the JAX blocks, and ragged in N and V (21 x 16 x
# 50: neither is a multiple of the blocks 8 / 16).
SHAPES = [(32, 16, 64), (21, 16, 50)]


@pytest.mark.parametrize("N,E,V", SHAPES, ids=["aligned", "ragged"])
def test_loss_matches_jax(flat_runtime, N, E, V):
    """float32 loss, rtol = atol = 2e-5 (tests/test_xent.py's)."""
    x, w = _rand((N, E), 0), _rand((E, V), 1)
    labels = _labels(N, V, 2)
    want = jax_xent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                    **BLOCKS)
    got = tmpi.ops.fused_linear_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# Labels: all in range; some -1 and some far past V (never match: t = 0).
# A label in [V, V rounded up to the TPU's vocab block) is left out: the
# JAX kernel matches it against a masked padding column (ROADMAP C5).
LABEL_CASES = ["in-range", "minus-one-and-out-of-range"]


@pytest.mark.parametrize("case", LABEL_CASES)
@pytest.mark.parametrize("N,E,V", SHAPES, ids=["aligned", "ragged"])
def test_weighted_grads_match_jax(flat_runtime, N, E, V, case):
    """dx and dW of sum(w_i * loss_i) at float32, rtol = atol = 3e-5
    (tests/test_xent.py's); the loss at 2e-5."""
    x, w = _rand((N, E), 6), _rand((E, V), 7)
    labels = _labels(N, V, 8)
    if case != "in-range":
        labels[::5] = -1
        labels[1::7] = 10 * V + 3
    wgt = _rand((N,), 9)
    lj, gxj, gwj = _jax_loss_and_grads(x, w, labels, wgt, **BLOCKS)
    lt, gxt, gwt = _port_loss_and_grads(x, w, labels, wgt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-5,
                               atol=2e-5)
    for got, want, what in ((gxt, gxj, "dx"), (gwt, gwj, "dW")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                                   atol=3e-5, err_msg=what)


def test_bf16_operands_round_g_where_the_tpu_does(flat_runtime):
    """bf16 x and w, as stage B' feeds them.  The loss is float32 from
    exact bf16 products: rtol = atol = 2e-5.  dx and dW come out in bf16;
    a float32 sum taken in another order may land on the other side of a
    bf16 rounding boundary, so each element is held to one bf16 ulp
    (2^-7 relative, atol 1e-7) and 97% of the elements must be bitwise
    equal.  The rounding points matter: the same gradients with g kept in
    float32 (not rounded before the products) miss the bitwise share."""
    N, E, V = 48, 32, 80
    x, w = _rand((N, E), 10, 1.0), _rand((E, V), 11, 0.3)
    labels = _labels(N, V, 12)
    wgt = _rand((N,), 13, 2.0)
    lj, gxj, gwj = _jax_loss_and_grads(x, w, labels, wgt, jnp.bfloat16,
                                       **BLOCKS)
    lt, gxt, gwt = _port_loss_and_grads(x, w, labels, wgt, torch.bfloat16)
    assert gxt.dtype == gwt.dtype == torch.bfloat16
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=2e-5, atol=2e-5)

    # The same function without rounding g to bf16 before the products.
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    lab = torch.from_numpy(labels)
    _, lse = xent.xent_fwd_plain(xb, wb, lab)
    g32 = xent._grad_plain(xb, wb, lab, lse, torch.from_numpy(wgt))
    unrounded = {"dx": (g32 @ wb.float().t()).bfloat16(),
                 "dW": (xb.float().t() @ g32).bfloat16()}
    for got, want, what in ((gxt, gxj, "dx"), (gwt, gwj, "dW")):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=1e-7,
                                   err_msg=what)
        assert (_np(got) == want).mean() >= 0.97, what
        assert (_np(unrounded[what]) == want).mean() < 0.97, what


def test_extreme_logits_match_jax(flat_runtime):
    """Logits of magnitude ~100 (a naive sum of exp overflows): finite,
    and equal to JAX at rtol = atol = 1e-4 (tests/test_xent.py's); the
    gradients at rtol 1e-4, atol 1e-5."""
    N, E, V = 8, 8, 32
    x, w = _rand((N, E), 13, 6.0), _rand((E, V), 14, 6.0)
    labels = _labels(N, V, 15)
    wgt = np.ones(N, np.float32)
    lj, gxj, gwj = _jax_loss_and_grads(x, w, labels, wgt, block_n=8,
                                       block_v=8)
    lt, gxt, gwt = _port_loss_and_grads(x, w, labels, wgt)
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    for got, want in ((gxt, gxj), (gwt, gwj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# The small stage B' LM: depth 2, embed 64, vocab 128, T 64, RoPE, window
# 24, GQA 4/2 (tests/test_torch_transformer.py's configuration).
CFG = dict(vocab=128, embed=64, depth=2, num_heads=4, head_dim=16,
           num_kv_heads=2, max_len=64, window=24, pos_emb="rope")
B, T = 2, 64


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_b_prime_lm_loss_and_grads_match_jax(flat_runtime, dtype):
    """The stage B' loss (bench.py :1706-1720): TransformerLM(return_prehead)
    then the fused loss of h[:, :-1] and the head, both cast to the compute
    dtype, mean over tokens.  The JAX model + JAX fused loss against the
    port's model (weights through weights.from_flax_params) + the port's
    fused loss.  float32: loss and every gradient at rtol 1e-4 (atol 1e-6).
    bfloat16 (the flagship's compute dtype): the frameworks round bf16
    products at different points, so the loss is held to rtol 1e-2 and
    each gradient to a relative L2 error of 5e-2, as
    tests/test_torch_transformer.py holds the dense loss."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    E = CFG["embed"]
    jmodel = JaxLM(**CFG, attn_impl="local", dtype=jdt)
    params = jax.jit(JaxLM(**CFG, attn_impl="local").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tok = np.random.RandomState(5).randint(0, CFG["vocab"],
                                           size=(B, T)).astype(np.int32)

    def jax_loss(p):
        h, head = jmodel.apply({"params": p}, jnp.asarray(tok),
                               return_prehead=True)
        return jax_xent(h[:, :-1].reshape(-1, E).astype(jdt),
                        head.astype(jdt), jnp.asarray(tok)[:, 1:].reshape(-1),
                        block_n=128, block_v=128).mean()

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(params)

    model = TransformerLM(**CFG, attn_impl="flash", dtype=tdt, device="cpu")
    model.load_state_dict(tmpi.weights.from_flax_params(params, model))
    tt = torch.from_numpy(tok).long()
    h, head = model(tt, return_prehead=True)
    loss_t = tmpi.ops.fused_linear_cross_entropy(
        h[:, :-1].reshape(-1, E).to(tdt), head.to(tdt),
        tt[:, 1:].reshape(-1)).mean()
    loss_t.backward()
    want = tmpi.weights.from_flax_params(jax.tree.map(np.asarray, grads_j),
                                         model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    if dtype == "float32":
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)
    else:
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-2)
        for n in want:
            assert _rel_l2(got[n], want[n]) < 5e-2, n


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors every wrapper returns its plain version's result and
    launches nothing; the TPU block arguments are accepted and ignored."""
    x = torch.from_numpy(_rand((12, 8), 20))
    w = torch.from_numpy(_rand((8, 24), 21))
    lab = torch.from_numpy(_labels(12, 24, 22))
    dl = torch.from_numpy(_rand((12,), 23))
    before = dict(xent.LAUNCHES)
    loss, lse = xent.xent_fwd(x, w, lab)
    assert torch.equal(loss, xent.xent_fwd_plain(x, w, lab)[0])
    assert torch.equal(xent.xent_bwd_dx(x, w, lab, lse, dl),
                       xent.xent_bwd_dx_plain(x, w, lab, lse, dl))
    assert torch.equal(xent.xent_bwd_dw(x, w, lab, lse, dl),
                       xent.xent_bwd_dw_plain(x, w, lab, lse, dl))
    assert torch.equal(
        tmpi.ops.fused_linear_cross_entropy(x, w, lab, block_n=4,
                                            block_v=512), loss)
    assert xent.LAUNCHES == before
    # A non-finite lse reads as 0 in the backward (the TPU's :302).
    bad = lse.clone()
    bad[0] = float("nan")
    fixed = lse.clone()
    fixed[0] = 0.0
    assert torch.equal(xent.xent_bwd_dx(x, w, lab, bad, dl),
                       xent.xent_bwd_dx(x, w, lab, fixed, dl))
    with pytest.raises(ValueError):
        xent.xent_fwd(x, w[:7], lab)
    with pytest.raises(TypeError):
        xent.xent_fwd(x, w, lab.float())


# ---------------------------------------------------------------------------
# The card-side schedule, modelled in torch on the CPU
# ---------------------------------------------------------------------------


def _fake_launch(calls):
    """A stand-in for ``xent._launch`` that records each launch and does
    the kernel's work in torch (on the chunk it was handed, with the C
    entry points' make_g / first / last semantics; the route code, last,
    is recorded)."""

    def launch(name, dev, *a):
        if name == "xent_bwd_dw":
            calls.append((name, a[-4:-1], a[-1]))
        else:
            calls.append((name, a[-2:-1] if name == "xent_bwd_dx" else a[-1:],
                          a[-1]))
        if name == "xent_fwd":
            x, w, lab, part, loss, lse, N, E, V, splits, route = a
            l_, s_ = xent.xent_fwd_plain(x, w, lab)
            loss.copy_(l_)
            lse.copy_(s_)
            return
        x, w, lab, lse, dl, g = a[:6]
        rows = x.shape[0]
        if (name == "xent_bwd_dx" and a[-2]) or (name == "xent_bwd_dw"
                                                 and a[-4]):
            g[:rows] = xent._grad_plain(x, w, lab, lse, dl).bfloat16()
        if name == "xent_bwd_dx":
            a[6].copy_((g[:rows].float() @ w.float().t()).to(x.dtype))
            return
        acc, dw, first, last = a[6], a[7], a[-3], a[-2]
        s = x.float().t() @ g[:rows].float()
        if not first:
            s = acc + s
        if last:
            dw.copy_(s.to(dw.dtype))
        else:
            acc.copy_(s)

    return launch


@pytest.mark.parametrize("chunk", [8, 64])
def test_chunked_backward_schedule(monkeypatch, chunk):
    """_bwd_cuda's chunking (rows sliced per chunk, g formed once per chunk
    by the dx launch when both gradients are wanted, the dW accumulator's
    first / last flags) gives the unchunked plain gradients: bitwise for dx
    (each row's sum is the same), and to one bf16 ulp (2^-7 relative) for
    dW, whose float32 sum is taken chunk by chunk."""
    N, E, V = 21, 16, 40
    x = torch.from_numpy(_rand((N, E), 30, 1.0)).bfloat16()
    w = torch.from_numpy(_rand((E, V), 31, 0.3)).bfloat16()
    lab = torch.from_numpy(_labels(N, V, 32))
    dl = torch.from_numpy(_rand((N,), 33))
    _, lse = xent.xent_fwd_plain(x, w, lab)
    calls = []
    monkeypatch.setattr(xent, "_launch", _fake_launch(calls))
    monkeypatch.setattr(xent, "BWD_CHUNK", chunk)
    before = dict(xent.LAUNCHES)
    routes_before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    dx, dw = xent._bwd_cuda(x, w, lab, lse, dl, True, True)
    # One count per kernel per wrapper call, however many chunks.
    assert {n: xent.LAUNCHES[n] - before[n] for n in before} == {
        "xent_fwd": 0, "xent_bwd_dx": 1, "xent_bwd_dw": 1}
    # Every chunk of the call takes one route, and the call counts once on
    # it for each backward kernel (the forward's count does not move).
    assert len({c[2] for c in calls}) == 1
    route = xent.ROUTES[calls[0][2]]
    for n, counts in xent.ROUTE_LAUNCHES.items():
        assert {r: counts[r] - routes_before[n][r] for r in counts} == {
            r: int(r == route and n != "xent_fwd") for r in xent.ROUTES}
    n_chunks = -(-N // chunk)
    assert [c[0] for c in calls] == ["xent_bwd_dx", "xent_bwd_dw"] * n_chunks
    # dx forms g (make_g 1); dW reads it (make_g 0); first / last flags.
    assert all(c[1] == (1,) for c in calls[::2])
    assert [c[1][1:] for c in calls[1::2]] == [
        (int(i == 0), int(i == n_chunks - 1)) for i in range(n_chunks)]
    assert all(c[1][0] == 0 for c in calls[1::2])
    assert torch.equal(dx, xent.xent_bwd_dx_plain(x, w, lab, lse, dl))
    np.testing.assert_allclose(
        _np(dw), _np(xent.xent_bwd_dw_plain(x, w, lab, lse, dl)),
        rtol=2 ** -7, atol=1e-7)
    calls.clear()
    dw_alone = xent._bwd_cuda(x, w, lab, lse, dl, False, True)[1]
    assert torch.equal(dw_alone, dw)
    assert all(c[0] == "xent_bwd_dw" and c[1][0] == 1 for c in calls)


def _fwd_split_model(x, w, labels, splits, BM=8, BN=16):
    """The forward kernel's order of operations in float32 torch: per row
    block and vocab split, an online (m, l, t) over vocab tiles of BN
    columns (columns past V masked to NEG_INF, the label's logit picked up
    when its tile passes); then the merge of the splits in order."""
    N, V = x.shape[0], w.shape[1]
    z_all = x.float() @ w.float()
    nt = -(-V // BN)
    per = -(-nt // splits)
    part = torch.empty(3, splits, N)
    for s in range(splits):
        m = torch.full((N,), xent.NEG_INF)
        l = torch.zeros(N)
        t = torch.zeros(N)
        for j in range(s * per, min(nt, s * per + per)):
            cols = torch.arange(j * BN, j * BN + BN)
            z = torch.full((N, BN), xent.NEG_INF)
            live = cols < V
            z[:, live] = z_all[:, cols[live]]
            m_new = torch.maximum(m, z.max(dim=1).values)
            l = l * torch.exp(m - m_new) + torch.exp(
                z - m_new[:, None]).sum(dim=1)
            hit = (labels.long()[:, None] == cols[None, :]) & live[None, :]
            t = t + torch.where(hit, z, torch.zeros_like(z)).sum(dim=1)
            m = m_new
        part[:, s] = torch.stack([m, l, t])
    m = part[0].max(dim=0).values
    l = (part[1] * torch.exp(part[0] - m)).sum(dim=0)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return lse - part[2].sum(dim=0), lse


@pytest.mark.parametrize("splits,V,BN", [
    pytest.param(1, 70, 16, id="1"), pytest.param(3, 70, 16, id="3"),
    pytest.param(4, 70, 16, id="4"), pytest.param(5, 70, 16, id="5"),
    pytest.param(3, 300, 128, id="tf32-tiles-V300"),
    pytest.param(2, 256, 128, id="tf32-tiles-V256")])
def test_forward_split_merge_matches_plain(splits, V, BN):
    """The split-and-merge of the forward kernel gives the plain loss and
    lse (rtol = atol = 2e-5; f32 sums in another order), with ragged N
    and V, labels -1 and past V, and splits that leave one run short or
    empty (5 tiles over 4 splits).  5 splits of the 5 tiles is the wgmma
    route's form: one partial (m, l, t) per tile, the ragged last tile's
    columns past V left out, merged in tile order.  The wgmma_tf32
    route's form is one partial per 128-column tile: three at V 300 (the
    last of 44 columns), two at V 256 (no ragged tile)."""
    N, E = 21, 16
    x = torch.from_numpy(_rand((N, E), 40, 1.0))
    w = torch.from_numpy(_rand((E, V), 41, 1.0))
    lab = torch.from_numpy(_labels(N, V, 42))
    lab[0], lab[1], lab[2] = -1, V + 1, V - 1
    assert splits == -(-V // BN) or BN == 16
    got = _fwd_split_model(x, w, lab, splits, BN=BN)
    want = xent.xent_fwd_plain(x, w, lab)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)
    assert xent._fwd_splits(8188, 32768) * 64 >= 512
    assert xent._fwd_splits(3, 100) == 1
