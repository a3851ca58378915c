"""The port's pipeline schedules (torchmpi_tpu_torch/parallel/pipeline.py,
rank-major) against the JAX package's under ``shard_map`` on the CPU.

Every case of tests/test_pipeline.py but the HLO-size one (it measures
XLA's program, which has no torch counterpart), on the same inputs made
from a seed with numpy, at its tolerances: GPipe and the interleaved
schedule forward and backward over the 8 ranks of ("dcn", "ici"), the
``interleave_stages`` layout, remat equal to plain, the ragged rejection,
composition with DP on the 2 x 4 grid (pp over ici, dp over dcn), and the
3D pp x tp x dp composition of Megatron blocks on a pushed communicator
and on ``Config.mesh_shape``.  In place of the HLO-size case: the
rank-major schedule calls its stage once a tick, ``M + S - 1`` calls,
linear in ``M``.  The process-world forms are held to these in
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
from torchmpi_tpu.parallel import pipeline as jpp
from torchmpi_tpu.parallel import tensor as jtp
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import runtime as truntime
from torchmpi_tpu_torch.parallel import pipeline as tpp
from torchmpi_tpu_torch.parallel import tensor as ttp

torch.set_num_threads(2)

D, MB, M = 16, 2, 6  # width, microbatch, microbatch count
N = 8
AXES = ("dcn", "ici")
SPEC = P(AXES)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """The JAX runtime (flat 1 x 8) for the module; the port's runtime of
    one gloo process is started by each test."""
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


@pytest.fixture
def hier():
    tmpi.stop()
    tmpi.init(tmpi.Config(dcn_size=2), device="cpu")
    yield
    tmpi.stop()


def _mesh(shape=(1, N), axes=AXES):
    return Mesh(np.array(jax.devices()[:N]).reshape(shape), axes)


def _shmap(body, mesh, in_specs, out_specs, *args):
    specs = tuple({k: s for k in a} if isinstance(a, dict) else s
                  for a, s in zip(args, in_specs))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                           out_specs=out_specs, check_vma=False))
    placed = [jax.tree.map(lambda v, s=s: jax.device_put(
        v, NamedSharding(mesh, s)), a) if isinstance(a, dict) else
        jax.device_put(a, NamedSharding(mesh, s))
        for a, s in zip(args, in_specs)]
    return fn(*placed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rep(a, n=N):
    return _t(np.broadcast_to(a, (n,) + a.shape))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _stages(S, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(S, D, D).astype(np.float32) * np.float32(1 / np.sqrt(D))
    b = rng.randn(S, D).astype(np.float32) * np.float32(0.1)
    return W, b


def _jstage(params, x):
    W, b = params
    return jnp.tanh(x @ W + b)


def _tstage(params, x):
    """One stage on the stacks: W [n, D, D], b [n, D], x [n, mb, D]."""
    W, b = params
    return torch.tanh(torch.matmul(x, W) + b[:, None, :])


def _sequential(W, b, x):
    for s in range(W.shape[0]):
        x = np.tanh(x @ W[s] + b[s])
    return x


def _jax_run(schedule, W, b, xs, backward=False, remat=False):
    """JAX's schedule over the 8 ranks of (dcn, ici): the replicated
    output, or the local-shard gradients of the last stage's sum of
    squares."""
    def apply(Wl, bl, xs, **kw):
        if schedule == "gpipe":
            return jpp.gpipe_apply(_jstage, (Wl[0], bl[0]), xs, AXES, **kw)
        return jpp.interleaved_apply(_jstage, (Wl[0], bl[0]), xs, AXES, **kw)

    if not backward:
        return _shmap(apply, _mesh(), (SPEC, SPEC, P()), P(), W, b, xs)

    def body(Wl, bl, xs):
        def loss(Wl_, bl_):
            out = apply(Wl_, bl_, xs, broadcast_out=False, remat=remat)
            return jtp.g_allreduce(jnp.sum(out ** 2), AXES)

        return jax.grad(loss, argnums=(0, 1))(Wl, bl)

    return _shmap(body, _mesh(), (SPEC, SPEC, P()), (SPEC, SPEC), W, b, xs)


def _port_run(schedule, W, b, xs, backward=False, remat=False):
    """The port's rank-major schedule on the same stacks: the output
    [n, M, ...], or the gradients of the last stage's sum of squares."""
    fn = (tpp.gpipe_apply_rank_major if schedule == "gpipe"
          else tpp.interleaved_apply_rank_major)
    Wt, bt = _t(W), _t(b)
    if not backward:
        return fn(_tstage, (Wt, bt), _rep(xs), AXES)
    Wt.requires_grad_()
    bt.requires_grad_()
    out = fn(_tstage, (Wt, bt), _rep(xs), AXES, broadcast_out=False,
             remat=remat)
    (out ** 2).sum().backward()
    return Wt.grad, bt.grad


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def test_gpipe_matches_jax(flat):
    W, b = _stages(N)
    xs = np.random.RandomState(1).randn(M, MB, D).astype(np.float32)
    want = _jax_run("gpipe", W, b, xs)
    got = _port_run("gpipe", W, b, xs)
    expect = np.stack([_sequential(W, b, xs[m]) for m in range(M)])
    for r in range(N):
        _close(got[r], want, rtol=2e-5, atol=2e-5)
    _close(got[0], expect, rtol=2e-5, atol=2e-5)


def test_gpipe_backward_matches_jax(flat):
    W, b = _stages(N, seed=2)
    xs = np.random.RandomState(3).randn(M, MB, D).astype(np.float32)
    gW_ref, gb_ref = _jax_run("gpipe", W, b, xs, backward=True)
    gW, gb = _port_run("gpipe", W, b, xs, backward=True)
    _close(gW, gW_ref, rtol=2e-4, atol=2e-5)
    _close(gb, gb_ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_rank_major_stage_calls_linear_in_microbatches(flat, schedule):
    """The rank-major schedule calls its stage once a tick on the whole
    stack: ``V M + S - 1`` calls, linear in ``M`` (the port's counterpart
    of JAX's HLO-size case, where a scan keeps the program constant)."""
    S = N
    V = 1 if schedule == "gpipe" else 2
    W, b = _stages(S * V, seed=20)
    if V > 1:
        W, b = tpp.interleave_stages(W, S), tpp.interleave_stages(b, S)
    calls = []

    def stage(params, x):
        calls.append(x.shape)
        return _tstage(params, x)

    fn = (tpp.gpipe_apply_rank_major if schedule == "gpipe"
          else tpp.interleaved_apply_rank_major)
    counts = {}
    for m in (8, 80):
        calls.clear()
        xs = np.zeros((m, MB, D), np.float32)
        fn(stage, (_t(W), _t(b)), _rep(xs), AXES)
        counts[m] = len(calls)
        assert all(c == (N, MB, D) for c in calls)
    assert counts == {8: V * 8 + S - 1, 80: V * 80 + S - 1}


# ---------------------------------------------------------------------------
# The interleaved schedule
# ---------------------------------------------------------------------------


def test_interleave_stages_layout():
    L, S = 16, 8
    W = np.arange(L * 3).reshape(L, 3).astype(np.float32)
    for leaf in (W, _t(W)):
        out = tpp.interleave_stages(leaf, S)
        assert tuple(out.shape) == (S, L // S, 3)
        np.testing.assert_array_equal(np.asarray(out),
                                      jpp.interleave_stages(W, S))
        for d in range(S):
            for v in range(L // S):
                np.testing.assert_array_equal(np.asarray(out[d, v]),
                                              W[v * S + d])
    with pytest.raises(ValueError, match="divisible"):
        tpp.interleave_stages(np.zeros((7, 3)), S)


def test_interleaved_matches_jax(flat):
    # 16 logical stages on 8 ranks (V=2), 16 microbatches (two groups).
    S, L, Mi = 8, 16, 16
    W, b = _stages(L, seed=6)
    xs = np.random.RandomState(7).randn(Mi, MB, D).astype(np.float32)
    Wi, bi = tpp.interleave_stages(W, S), tpp.interleave_stages(b, S)
    want = _jax_run("interleaved", Wi, bi, xs)
    got = _port_run("interleaved", Wi, bi, xs)
    expect = np.stack([_sequential(W, b, xs[m]) for m in range(Mi)])
    for r in range(N):
        _close(got[r], want, rtol=2e-5, atol=2e-5)
    _close(got[0], expect, rtol=2e-5, atol=2e-5)


def test_interleaved_v1_equals_gpipe(flat):
    S, Mi = 8, 8
    W, b = _stages(S, seed=8)
    xs = np.random.RandomState(9).randn(Mi, MB, D).astype(np.float32)
    a = _port_run("gpipe", W, b, xs)
    c = _port_run("interleaved", W[:, None], b[:, None], xs)
    _close(c, a, rtol=1e-6, atol=1e-6)
    _close(a[0], _jax_run("interleaved", W[:, None], b[:, None], xs),
           rtol=1e-6, atol=1e-6)


def test_interleaved_backward_matches_jax(flat):
    S, L, Mi = 8, 16, 8
    W, b = _stages(L, seed=10)
    xs = np.random.RandomState(11).randn(Mi, MB, D).astype(np.float32)
    Wi, bi = tpp.interleave_stages(W, S), tpp.interleave_stages(b, S)
    gW_ref, gb_ref = _jax_run("interleaved", Wi, bi, xs, backward=True)
    gW, gb = _port_run("interleaved", Wi, bi, xs, backward=True)
    _close(gW, gW_ref, rtol=2e-4, atol=2e-5)
    _close(gb, gb_ref, rtol=2e-4, atol=2e-5)


def test_interleaved_rejects_ragged_microbatches(flat):
    S = 8
    W, b = _stages(16, seed=12)
    Wi, bi = tpp.interleave_stages(W, S), tpp.interleave_stages(b, S)
    xs = np.zeros((6, MB, D), np.float32)  # 6 % 8 != 0
    with pytest.raises(ValueError, match="M % S"):
        tpp.interleaved_apply_rank_major(_tstage, (_t(Wi), _t(bi)), _rep(xs),
                                         AXES)
    with pytest.raises(ValueError, match="M % S"):
        _jax_run("interleaved", Wi, bi, xs)


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_remat_grads_equal_plain(flat, schedule):
    """Rematerialized stages give the plain gradients, and JAX's."""
    S = 8
    L = S if schedule == "gpipe" else 16
    W, b = _stages(L, seed=13)
    xs = np.random.RandomState(14).randn(8, MB, D).astype(np.float32)
    if schedule == "interleaved":
        W, b = tpp.interleave_stages(W, S), tpp.interleave_stages(b, S)
    plain = _port_run(schedule, W, b, xs, backward=True)
    remat = _port_run(schedule, W, b, xs, backward=True, remat=True)
    for p, r in zip(plain, remat):
        _close(r, p, rtol=1e-5, atol=1e-6)
    for p, j in zip(plain, _jax_run(schedule, W, b, xs, backward=True,
                                    remat=True)):
        _close(p, j, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# Composition with DP (2 x 4: pp over ici, dp over dcn)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_composes_with_dp(hier, schedule):
    S = 4
    L, Mi = (S, M) if schedule == "gpipe" else (8, 4)
    W, b = _stages(L, seed=4 if schedule == "gpipe" else 15)
    xs = np.random.RandomState(5 if schedule == "gpipe" else 16).randn(
        2, Mi, MB, D).astype(np.float32)
    if schedule == "interleaved":
        Wl, bl = tpp.interleave_stages(W, S), tpp.interleave_stages(b, S)
    else:
        Wl, bl = W, b
    jfn = jpp.gpipe_apply if schedule == "gpipe" else jpp.interleaved_apply

    def body(Wl_, bl_, xg):
        return jfn(_jstage, (Wl_[0], bl_[0]), xg[0], "ici")[None]

    want = np.asarray(_shmap(body, _mesh((2, 4)), (P("ici"), P("ici"),
                                                   P("dcn")), P("dcn"),
                             Wl, bl, xs))
    # Rank (d, i): stage i's parameters, dp stream d.
    tfn = (tpp.gpipe_apply_rank_major if schedule == "gpipe"
           else tpp.interleaved_apply_rank_major)
    got = tfn(_tstage, (_t(np.concatenate([Wl] * 2)),
                        _t(np.concatenate([bl] * 2))),
              _t(np.repeat(xs, 4, axis=0)), "ici")
    expect = np.stack([np.stack([_sequential(W, b, xs[g, m])
                                 for m in range(Mi)]) for g in range(2)])
    for d in range(2):
        for i in range(4):
            _close(got[d * 4 + i], want[d], rtol=2e-5, atol=2e-5)
            _close(got[d * 4 + i], expect[d], rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# 3D: pipeline stages of Megatron blocks, pp x tp x dp
# ---------------------------------------------------------------------------


def _run_3d(jax_mesh3):
    """The 3D composition (JAX :376-447): stages over pp, TP blocks over
    tp, batch streams over dp on (pp=2, tp=2, dp=2); JAX's on ``jax_mesh3``
    against the port's rank-major stack of the current communicator, both
    against the dense sequential oracle."""
    S, n_tp, n_dp = 2, 2, 2
    H, Dm, F, mb, Mi, T = 2, 8, 16, 2, 2, 4
    rng = np.random.RandomState(17)

    def dense_block(seed):
        r = np.random.RandomState(seed)
        s = np.float32(1.0 / np.sqrt(Dm))
        return {
            "wq": r.randn(Dm, Dm).astype(np.float32) * s,
            "wk": r.randn(Dm, Dm).astype(np.float32) * s,
            "wv": r.randn(Dm, Dm).astype(np.float32) * s,
            "wo": r.randn(Dm, Dm).astype(np.float32) * s,
            "w1": r.randn(Dm, F).astype(np.float32) * s,
            "w2": r.randn(F, Dm).astype(np.float32) * np.float32(
                1 / np.sqrt(F)),
        }

    blocks = [dense_block(100 + s) for s in range(S)]
    xs = rng.randn(n_dp, Mi, mb, T, Dm).astype(np.float32)

    def shards(key, w):
        fn = ttp.shard_rows if key in ("wo", "w2") else ttp.shard_columns
        return np.stack([fn(w, None, n_tp, i) for i in range(n_tp)])

    staged = {k: np.stack([shards(k, blk[k]) for blk in blocks])
              for k in blocks[0]}          # [S, n_tp, ...]
    jlnp = (jnp.ones(Dm), jnp.zeros(Dm))

    def jstage(pv, x):
        p = {"ln1": jlnp, "ln2": jlnp}
        p.update({k: v[0, 0] for k, v in pv.items()})
        return jtp.tp_transformer_block(x, p, "tp", num_heads=H)

    def body(staged_local, xg):
        return jpp.gpipe_apply(jstage, staged_local, xg[0], "pp")[None]

    wspec = P("pp", "tp")
    want = np.asarray(_shmap(body, jax_mesh3, (wspec, P("dp")), P("dp"),
                             staged, xs))

    # Rank r = (pp, tp, dp) row-major: stage pp's tp block, stream dp.
    order = [(s, t, d) for s in range(S) for t in range(n_tp)
             for d in range(n_dp)]
    tparams = {k: _t(np.stack([v[s, t] for s, t, _ in order]))
               for k, v in staged.items()}
    tlnp = (torch.ones(Dm), torch.zeros(Dm))

    def tstage(pv, x):
        p = dict(pv, ln1=tlnp, ln2=tlnp)
        return ttp.tp_transformer_block_rank_major(x, p, "tp", num_heads=H)

    got = tpp.gpipe_apply_rank_major(
        tstage, tparams, _t(np.stack([xs[d] for _, _, d in order])), "pp")
    for r, (_, _, d) in enumerate(order):
        _close(got[r], want[d], rtol=3e-4, atol=3e-5)
    jax_dense = np.stack([np.stack([_dense_3d(blocks, xs[g, m], H)
                                    for m in range(Mi)])
                          for g in range(n_dp)])
    _close(want, jax_dense, rtol=3e-4, atol=3e-5)


def _dense_3d(blocks, x, H):
    """The sequential oracle: each dense block in order (unit LN)."""
    from torchmpi_tpu.parallel.sequence import reference_attention

    def ln(h):
        mu = h.mean(-1, keepdims=True)
        var = ((h - mu) ** 2).mean(-1, keepdims=True)
        return (h - mu) / np.sqrt(var + 1e-6)

    for blk in blocks:
        B, T_, D_ = x.shape
        Dh = D_ // H
        hx = ln(x)
        q, k, v = (jnp.asarray((hx @ blk[w]).reshape(B, T_, H, Dh))
                   for w in ("wq", "wk", "wv"))
        ctx = np.asarray(reference_attention(q, k, v, causal=True))
        x = x + ctx.reshape(B, T_, D_) @ blk["wo"]
        gelu = np.asarray(jax.nn.gelu(jnp.asarray(ln(x) @ blk["w1"]),
                                      approximate=False))
        x = x + gelu @ blk["w2"]
    return x


def test_3d_pp_tp_dp_composition(flat):
    """On a pushed communicator (the reference's communicator split) of
    the world, on both sides."""
    shape = {"pp": 2, "tp": 2, "dp": 2}
    with jmpi.communicator("3d", shape=shape) as mesh3:
        with truntime.communicator("3d", shape=shape) as comm:
            assert comm.shape(N) == shape
            _run_3d(mesh3)
    assert truntime.current_communicator_name() == "world"


def test_3d_pp_tp_dp_on_first_class_mesh():
    """On the init-level N-D world (``Config(mesh_shape=...)``) on both
    sides: no communicator pushes."""
    shape = {"pp": 2, "tp": 2, "dp": 2}
    jmpi.stop()
    tmpi.stop()
    mesh3 = jmpi.init(jmpi.Config(mesh_shape=shape))
    tmpi.init(tmpi.Config(mesh_shape=shape), device="cpu")
    try:
        assert truntime.world_shape(N) == shape
        _run_3d(mesh3)
    finally:
        tmpi.stop()
        jmpi.stop()
        jmpi.init(jmpi.Config(dcn_size=1))
