"""The port's tensor-parallel layers (torchmpi_tpu_torch/parallel/tensor.py,
rank-major) against the JAX package's under ``shard_map`` on the CPU.

Every case of tests/test_tensor_parallel.py, on the same inputs made from
a seed with numpy, at its tolerances: the rank-major stacks [n, ...] of
the port (rank r's slice its shard, replicated inputs repeated) against
JAX's ``shard_map`` run on the 8-device CPU mesh over ("dcn", "ici"), and
TP composed with DP on the 2 x 4 mesh ("ici" the model axis).  JAX's
flash in the Pallas interpreter costs tens of seconds a case, so the
port's ``impl="flash"`` (its plain version on the CPU) is held against
JAX's ``impl="dense"`` on the same shards, as JAX's own test holds its two
impls.  Also: JAX's errors, the f / g pair's gradients, and
``backend="pallas"`` (the ring's plain version here) equal to the stock
route.  The process-world forms are held to these in
tests/test_torch_nd_world_procs.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.parallel import tensor as jtp
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.parallel import tensor as ttp

torch.set_num_threads(2)

N = 8
AXES = ("dcn", "ici")


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """The JAX runtime (flat 1 x 8) for the module; the port's runtime of
    one gloo process is started by each test (its Config factors the
    rank-major stacks)."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    yield
    jmpi.stop()
    tmpi.stop()


@pytest.fixture
def flat():
    tmpi.stop()
    tmpi.init(device="cpu")
    yield
    tmpi.stop()


def _mesh(shape=(1, N)):
    return Mesh(np.array(jax.devices()[:N]).reshape(shape), AXES)


def _shmap(body, mesh, in_specs, out_specs, *args):
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False))
    placed = [jax.device_put(a, NamedSharding(mesh, s))
              for a, s in zip(args, in_specs)]
    return fn(*placed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rep(a, n=N):
    """A replicated input as the stack [n, ...]."""
    return _t(np.broadcast_to(a, (n,) + a.shape))


def _cols(w, n=N):
    return np.stack([ttp.shard_columns(w, None, n, i) for i in range(n)])


def _rows(w, n=N):
    return np.stack([ttp.shard_rows(w, None, n, i) for i in range(n)])


def _weights(d_in=32, d_hidden=64, d_out=16, seed=0):
    rng = np.random.RandomState(seed)
    w1 = rng.randn(d_in, d_hidden).astype(np.float32) * 0.3
    w2 = rng.randn(d_hidden, d_out).astype(np.float32) * 0.3
    x = rng.randn(4, d_in).astype(np.float32)
    return x, w1, w2


def _attn_weights(B=2, T=6, D=32, H=8, seed=0):
    rng = np.random.RandomState(seed)
    s = np.float32(1.0 / np.sqrt(D))
    x = rng.randn(B, T, D).astype(np.float32)
    wq, wk, wv = (rng.randn(D, D).astype(np.float32) * s for _ in range(3))
    wo = rng.randn(D, D).astype(np.float32) * s
    return x, wq, wk, wv, wo


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# The MLP and the f / g pair
# ---------------------------------------------------------------------------


def test_tp_mlp_matches_jax(flat):
    x, w1, w2 = _weights()

    def body(x, w1l, w2l):
        return jtp.tp_mlp(x, w1l, w2l, AXES)

    want = _shmap(body, _mesh(), (P(), P(None, AXES), P(AXES, None)), P(),
                  x, w1, w2)
    got = ttp.tp_mlp_rank_major(_rep(x), _t(_cols(w1)), _t(_rows(w2)), AXES)
    for r in range(N):
        _close(got[r], want, rtol=2e-5, atol=2e-5)
    _close(got[0], np.tanh(x @ w1) @ w2, rtol=2e-5, atol=2e-5)


def test_tp_composes_with_dp():
    """Model axis ici, data axis dcn on the 2 x 4 grid: each dcn group's
    batch shard through a TP MLP over ici."""
    tmpi.stop()
    tmpi.init(tmpi.Config(dcn_size=2), device="cpu")
    try:
        x, w1, w2 = _weights()

        def body(xb, w1l, w2l):
            return jtp.tp_mlp(xb, w1l, w2l, "ici")

        want = np.asarray(_shmap(
            body, _mesh((2, 4)), (P("dcn"), P(None, "ici"), P("ici", None)),
            P("dcn"), x, w1, w2))
        # Rank (d, i): batch shard d, column / row block i.
        xs = _t(np.stack([x[d * 2:(d + 1) * 2] for d in range(2)
                          for _ in range(4)]))
        w1s = _t(np.concatenate([_cols(w1, 4)] * 2))
        w2s = _t(np.concatenate([_rows(w2, 4)] * 2))
        got = ttp.tp_mlp_rank_major(xs, w1s, w2s, "ici")
        for d in range(2):
            for i in range(4):
                _close(got[d * 4 + i], want[d * 2:(d + 1) * 2], rtol=2e-5,
                       atol=2e-5)
    finally:
        tmpi.stop()


def test_tp_grad_matches_jax(flat):
    x, w1, w2 = _weights()

    def body(x, w1l, w2l):
        def loss(a, b):
            return jnp.sum(jtp.tp_mlp(x, a, b, AXES) ** 2)

        return jax.grad(loss, argnums=(0, 1))(w1l, w2l)

    g1, g2 = _shmap(body, _mesh(), (P(), P(None, AXES), P(AXES, None)),
                    (P(None, AXES), P(AXES, None)), x, w1, w2)
    w1s = _t(_cols(w1)).requires_grad_()
    w2s = _t(_rows(w2)).requires_grad_()
    (ttp.tp_mlp_rank_major(_rep(x), w1s, w2s, AXES) ** 2).sum().backward()
    _close(np.concatenate(list(w1s.grad.numpy()), axis=1), g1, rtol=1e-4,
           atol=1e-5)
    _close(np.concatenate(list(w2s.grad.numpy()), axis=0), g2, rtol=1e-4,
           atol=1e-5)


def test_tp_input_grad_matches_jax(flat):
    """The f operator: every rank's input gradient is the sum of its
    group's cotangents."""
    x, w1, w2 = _weights()

    def body(x, w1l, w2l):
        return jax.grad(lambda xv: jnp.sum(jtp.tp_mlp(xv, w1l, w2l,
                                                      AXES) ** 2))(x)

    gx = _shmap(body, _mesh(), (P(), P(None, AXES), P(AXES, None)), P(),
                x, w1, w2)
    xs = _rep(x).clone().requires_grad_()
    (ttp.tp_mlp_rank_major(xs, _t(_cols(w1)), _t(_rows(w2)), AXES)
     ** 2).sum().backward()
    for r in range(N):
        _close(xs.grad[r], gx, rtol=1e-4, atol=1e-5)


def test_f_g_pair_and_pallas_backend(flat):
    """g sums forward and passes each rank's cotangent through; f passes
    the input through and sums the cotangents; ``backend="pallas"`` (the
    ring's plain version on the CPU) gives the stock route's values."""
    rng = np.random.RandomState(3)
    xs = _t(rng.randn(N, 5).astype(np.float32)).requires_grad_()
    cot = _t(rng.randn(N, 5).astype(np.float32))
    for backend in ("xla", "pallas"):
        xs.grad = None
        y = ttp.g_allreduce_rank_major(xs, AXES, backend=backend)
        _close(y.detach(), xs.detach().sum(0).expand(N, 5), rtol=1e-6,
               atol=1e-6)
        y.backward(cot)
        assert torch.equal(xs.grad, cot)
        xs.grad = None
        y = ttp.f_identity_rank_major(xs, AXES, backend=backend)
        assert torch.equal(y.detach(), xs.detach())
        y.backward(cot)
        _close(xs.grad, cot.sum(0).expand(N, 5), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Attention and the Megatron block
# ---------------------------------------------------------------------------


def _jax_attention(x, wq, wk, wv, wo, H, causal, impl="dense"):
    spec = P(AXES)

    def body(x, wql, wkl, wvl, wol):
        return jtp.tp_attention(x, wql[0], wkl[0], wvl[0], wol[0], AXES,
                                num_heads=H, causal=causal, impl=impl)

    return _shmap(body, _mesh(), (P(), spec, spec, spec, spec), P(), x,
                  _cols(wq), _cols(wk), _cols(wv), _rows(wo))


@pytest.mark.parametrize("causal", [True, False])
def test_tp_attention_matches_jax(flat, causal):
    H = 8
    x, wq, wk, wv, wo = _attn_weights(H=H)
    want = _jax_attention(x, wq, wk, wv, wo, H, causal)
    got = ttp.tp_attention_rank_major(
        _rep(x), _t(_cols(wq)), _t(_cols(wk)), _t(_cols(wv)), _t(_rows(wo)),
        AXES, num_heads=H, causal=causal)
    for r in range(N):
        _close(got[r], want, rtol=2e-4, atol=2e-5)


def test_tp_attention_flash_impl_matches_jax_dense(flat):
    """The port's ``impl="flash"`` (one attention call for every rank's
    heads) against JAX's ``impl="dense"`` on the same shards; an unknown
    impl raises."""
    H = 8
    x, wq, wk, wv, wo = _attn_weights(H=H)
    want = _jax_attention(x, wq, wk, wv, wo, H, True)
    args = (_rep(x), _t(_cols(wq)), _t(_cols(wk)), _t(_cols(wv)),
            _t(_rows(wo)), AXES)
    got = ttp.tp_attention_rank_major(*args, num_heads=H, impl="flash")
    for r in range(N):
        _close(got[r], want, rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="impl"):
        ttp.tp_attention_rank_major(*args, num_heads=H, impl="nope")


def test_tp_attention_errors_match_jax(flat):
    """JAX's four ValueErrors (:133-145), message for message."""
    x, wq, wk, wv, wo = _attn_weights(H=8)
    args = (_rep(x), _t(_cols(wq)), _t(_cols(wk)), _t(_cols(wv)),
            _t(_rows(wo)), AXES)
    with pytest.raises(ValueError, match="must divide by the axis size 8"):
        ttp.tp_attention_rank_major(*args, num_heads=12)
    with pytest.raises(ValueError, match="must divide by local head count"):
        ttp.tp_attention_rank_major(*args, num_heads=24)
    with pytest.raises(ValueError, match="impl must be"):
        ttp.tp_attention_rank_major(*args, num_heads=8, impl="nope")
    with pytest.raises(ValueError, match="window= requires impl='flash'"):
        ttp.tp_attention_rank_major(*args, num_heads=8, window=2)


def _block_inputs(H=8, D=32, F=64):
    x, wq, wk, wv, wo = _attn_weights(H=H, D=D, seed=3)
    rng = np.random.RandomState(4)
    w1 = rng.randn(D, F).astype(np.float32) * np.float32(1.0 / np.sqrt(D))
    w2 = rng.randn(F, D).astype(np.float32) * np.float32(1.0 / np.sqrt(F))
    ln1 = (np.ones(D, np.float32), np.zeros(D, np.float32))
    ln2 = (np.ones(D, np.float32) * 1.1, np.zeros(D, np.float32) + 0.05)
    return x, {"ln1": ln1, "ln2": ln2, "wq": wq, "wk": wk, "wv": wv,
               "wo": wo, "w1": w1, "w2": w2}


def _shards(dense):
    return {k: (_rows(v) if k in ("wo", "w2") else _cols(v))
            for k, v in dense.items() if k[0] == "w"}


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_tp_transformer_block_matches_jax(flat, attn_impl):
    H = 8
    x, dense = _block_inputs(H)
    shards = _shards(dense)
    spec = P(AXES)
    keys = ("wq", "wk", "wv", "wo", "w1", "w2")

    def body(x, ln1s, ln1b, ln2s, ln2b, *ws):
        p = {"ln1": (ln1s, ln1b), "ln2": (ln2s, ln2b)}
        p.update({k: w[0] for k, w in zip(keys, ws)})
        return jtp.tp_transformer_block(x, p, AXES, num_heads=H)

    want = _shmap(body, _mesh(), (P(),) * 5 + (spec,) * 6, P(), x,
                  *dense["ln1"], *dense["ln2"], *(shards[k] for k in keys))
    p = {k: _t(v) for k, v in shards.items()}
    p.update({k: tuple(_t(a) for a in dense[k]) for k in ("ln1", "ln2")})
    got = ttp.tp_transformer_block_rank_major(_rep(x), p, AXES, num_heads=H,
                                              attn_impl=attn_impl)
    for r in range(N):
        _close(got[r], want, rtol=3e-4, atol=3e-5)


def test_tp_block_grads_match_jax(flat):
    """Gradients through both sublayers (the f / g pairs of attention and
    MLP composed) equal JAX's local-shard gradients."""
    H, D, F = 8, 16, 32
    x, wq, wk, wv, wo = _attn_weights(B=2, T=4, D=D, H=H, seed=5)
    rng = np.random.RandomState(6)
    w1 = rng.randn(D, F).astype(np.float32) * np.float32(1.0 / np.sqrt(D))
    w2 = rng.randn(F, D).astype(np.float32) * np.float32(1.0 / np.sqrt(F))
    ln = (np.ones(D, np.float32), np.zeros(D, np.float32))
    spec = P(AXES)
    jln = (jnp.asarray(ln[0]), jnp.asarray(ln[1]))

    def body(wql, wkl, wvl, wol, w1l, w2l):
        p = {"ln1": jln, "ln2": jln, "wq": wql[0], "wk": wkl[0],
             "wv": wvl[0], "wo": wol[0], "w1": w1l[0], "w2": w2l[0]}

        def loss(wq_, w2_):
            p2 = dict(p, wq=wq_[0], w2=w2_[0])
            out = jtp.tp_transformer_block(jnp.asarray(x), p2, AXES,
                                           num_heads=H)
            return jnp.sum(out ** 2)

        return jax.grad(loss, argnums=(0, 1))(wql, w2l)

    g_wq, g_w2 = _shmap(body, _mesh(), (spec,) * 6, (spec, spec),
                        _cols(wq), _cols(wk), _cols(wv), _rows(wo),
                        _cols(w1), _rows(w2))
    p = {"ln1": tuple(map(_t, ln)), "ln2": tuple(map(_t, ln)),
         "wq": _t(_cols(wq)).requires_grad_(), "wk": _t(_cols(wk)),
         "wv": _t(_cols(wv)), "wo": _t(_rows(wo)), "w1": _t(_cols(w1)),
         "w2": _t(_rows(w2)).requires_grad_()}
    out = ttp.tp_transformer_block_rank_major(_rep(x), p, AXES, num_heads=H)
    (out ** 2).sum().backward()
    _close(p["wq"].grad, g_wq, rtol=3e-4, atol=3e-5)
    _close(p["w2"].grad, g_w2, rtol=3e-4, atol=3e-5)
