"""The port's dcn wire codecs and error feedback (torchmpi_tpu_torch/
compress.py, gradsync / zero ``residuals``) against the JAX package on the
CPU; JAX's tests/test_compress.py is the spec.

- ``encode`` / ``decode`` bitwise against JAX's (jitted, as its
  collectives run them) for bf16, int8 and fp8 (torch's float8_e4m3fn cast
  against ml_dtypes'), the all-zero bucket included; the numpy host twins
  bitwise against JAX's; ``validate_wire``, ``wire_nbytes_of``,
  ``expected_shards``.
- The error-feedback gradient sync (``synchronize_gradients_rank_major``),
  its overlapped form and the ZeRO-1 / ZeRO-3 legs, rank-major n = 8 as
  dcn 2 x ici 4, against JAX's under ``shard_map`` on the 2 x 4 mesh, over
  three steps: on inputs whose sums are exact in any order (small integers
  times a power of two) both sides quantize the same values to the same
  payloads, and the synced values and residuals agree to a few ulps (XLA
  fuses the decode's multiply and add, ROADMAP queue C note 19); on
  general seeded inputs, within one quantum (the scale) per element.
- The residual state checked (``ResidualMismatchError``), an explicit
  ``backend=`` / ``compress=`` raising, a sub-floor leg passing its
  residual through, a flat grid degrading, error feedback beating
  single-shot quantization over steps.
- With ``dcn_compress="off"`` the codec module is never imported (a
  subprocess).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu import compress as jc
from torchmpi_tpu.parallel import gradsync as jgs
from torchmpi_tpu.parallel import zero as jzero
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import compress as tc
from torchmpi_tpu_torch import fusion as tfusion
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import selector as tsel
from torchmpi_tpu_torch.parallel import gradsync as tgs
from torchmpi_tpu_torch.parallel import zero as tzero

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
AXES = ("dcn", "ici")


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """The JAX runtime on its 2 x 4 world mesh and the port's runtime (CPU,
    a world of one) factoring rank-major stacks as dcn 2, both with the
    int8 codec and no floor."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=2, dcn_compress="int8",
                          dcn_compress_min_bytes=0))
    tmpi.init(device="cpu", dcn_size=2, dcn_compress="int8",
              dcn_compress_min_bytes=0)
    yield
    tmpi.stop()
    jmpi.stop()


def _exact(shape, seed, dtype=np.float32):
    """Small integers times 1/8: every sum of a few is exact."""
    r = np.random.RandomState(seed)
    return (r.randint(-40, 40, size=shape) * 0.125).astype(dtype)


def _general(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _put(x, mesh):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(AXES)))


def _quantum(rank_major: np.ndarray) -> float:
    """The largest int8 scale of any rank's ici-scattered shard of a
    rank-major [8, L] float stack (a bound on one quantum)."""
    x = rank_major.reshape(2, 4, -1).astype(np.float32).sum(1)
    return float(np.abs(x).max()) / 127.0


def _ulps(got, want, ref: float, k: int = 4):
    """|got - want| within k ulps of the magnitude ``ref``."""
    tol = k * float(np.spacing(np.float32(ref)))
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= tol, (diff.max(), tol)


# ---------------------------------------------------------------------------
# The codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("zeros", [False, True])
def test_encode_decode_bitwise_vs_jax(codec, zeros):
    x = (np.zeros(4096, np.float32) if zeros
         else _general((4096,), 3) * np.float32(7.5))
    jq, js = jax.jit(lambda v: jc.encode(v, codec))(x)
    tq, ts = tc.encode(torch.from_numpy(x), codec)
    jbits = np.asarray(jq).view(np.uint8 if codec != "bf16" else np.uint16)
    tbits = tq.view(torch.uint8 if codec != "bf16"
                    else torch.int16).numpy().view(jbits.dtype)
    np.testing.assert_array_equal(tbits, jbits)
    if js is None:
        assert ts is None
    else:
        assert np.float32(js) == np.float32(ts)
    jd = np.asarray(jax.jit(lambda q, s: jc.decode(q, s))(jq, js))
    td = tc.decode(tq, ts).numpy()
    np.testing.assert_array_equal(td, jd)
    if zeros:
        assert not td.any()


def test_fp8_cast_rounds_as_ml_dtypes():
    """torch's float32 -> float8_e4m3fn cast against ml_dtypes' on every
    float32 in [-448, 448] at 2^-10 steps and on the ties between adjacent
    e4m3 values: the same bits (round half to even)."""
    grid = np.arange(-448 * 1024, 448 * 1024 + 1, dtype=np.float64) / 1024
    e4 = np.unique(grid.astype(ml_dtypes.float8_e4m3fn).astype(np.float32))
    ties = ((e4[1:] + e4[:-1]) / 2).astype(np.float32)
    x = np.concatenate([grid.astype(np.float32), ties])
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_host_twins_match_jax(codec):
    x = _general((1000,), 4) * np.float32(3.0)
    jq, js = jc.host_encode(x, codec)
    tq, ts = tc.host_encode(x, codec)
    np.testing.assert_array_equal(tq, jq)
    assert (js is None and ts is None) or np.float32(js) == np.float32(ts)
    np.testing.assert_array_equal(tc.host_decode(tq, ts),
                                  jc.host_decode(jq, js))


def test_validate_wire_and_sizes_match_jax():
    for v in (None, "none", "off", "", "BF16", " int8 ", "fp8"):
        assert tc.validate_wire(v) == jc.validate_wire(v)
    for bad, allowed in (("int4", tc.CODECS), ("int8", ("bf16",))):
        with pytest.raises(ValueError, match="unknown compression") as e:
            tc.validate_wire(bad, allowed=allowed, site="s")
        with pytest.raises(ValueError) as f:
            jc.validate_wire(bad, allowed=allowed, site="s")
        assert str(e.value) == str(f.value)
    for codec in tc.CODECS:
        for n in (0, 1, 1000):
            assert tc.wire_nbytes_of(n, codec) == jc.wire_nbytes_of(n, codec)
    assert tc.expected_shards([10, 8, 1], 4) == jc.expected_shards(
        [10, 8, 1], 4)
    # gradsync_compress goes through the same validation.
    with pytest.raises(ValueError, match="allowed: bf16 or none"):
        tgs.synchronize_gradients_rank_major([torch.ones(2, 2)],
                                             compress="int8")


# ---------------------------------------------------------------------------
# Error-feedback gradient sync
# ---------------------------------------------------------------------------


def _jax_ef_sync(grads, res, op="mean"):
    mesh = jmpi.world_mesh()

    def body(g, rs):
        synced, new = jgs.synchronize_gradients(
            [a[0] for a in g], AXES, op=op, residuals=rs,
            dcn_compress="int8")
        return [s[None] for s in synced], new

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(AXES), P(AXES)),
                          out_specs=(P(AXES), P(AXES)), check_vma=False))
    out, new = f([_put(g, mesh) for g in grads],
                 [_put(np.asarray(r), mesh) for r in res])
    return [np.asarray(o) for o in out], [np.asarray(r) for r in new]


SHAPES = [(33,), (16, 24)]


@pytest.mark.parametrize("inputs", ["exact", "general"])
def test_ef_sync_matches_jax(inputs):
    """Three EF syncs, each with new per-rank gradients, the residuals
    threaded on both sides."""
    make = _exact if inputs == "exact" else _general
    template = [np.zeros(s, np.float32) for s in SHAPES]
    j_res = jgs.init_dcn_residuals(template, AXES)
    t_res = tgs.init_dcn_residuals([torch.from_numpy(t) for t in template],
                                   n=N)
    assert [tuple(r.shape) for r in t_res] == [r.shape for r in j_res]
    for step in range(3):
        grads = [make((N,) + s, 10 * step + i) for i, s in enumerate(SHAPES)]
        want, j_res = _jax_ef_sync(grads, j_res)
        stacks = [torch.from_numpy(g.copy()) for g in grads]
        got, t_res = tgs.synchronize_gradients_rank_major(
            stacks, residuals=t_res, dcn_compress="int8")
        flat = np.concatenate([g.reshape(N, -1) for g in grads], 1)
        for g, w in zip(got, want):
            if inputs == "exact":
                _ulps(g.numpy(), w, np.abs(flat).sum(0).max() / N)
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=_quantum(flat))
        for r, w in zip(t_res, j_res):
            if inputs == "exact":
                _ulps(r.numpy(), w, np.abs(flat.reshape(2, 4, -1).sum(
                    1)).max())
            else:
                np.testing.assert_allclose(r.numpy(), w, rtol=0,
                                           atol=_quantum(flat))
        assert any(float(r.abs().max()) > 0 for r in t_res)


def test_ef_sync_mixed_dtypes_one_bucket_each():
    """A float32 and a bfloat16 leaf: one bucket (and one residual) per
    dtype group, each against JAX's."""
    grads = [_exact((N, 40), 1), _exact((N, 64), 2).astype(
        ml_dtypes.bfloat16)]
    template = [g[0] for g in grads]
    j_res = jgs.init_dcn_residuals([jnp.asarray(t) for t in template], AXES)
    t_res = tgs.init_dcn_residuals(
        [torch.from_numpy(grads[0][0]),
         torch.from_numpy(grads[1][0].astype(np.float32)).bfloat16()], n=N)
    assert len(t_res) == 2
    want, _ = _jax_ef_sync(grads, j_res)
    stacks = [torch.from_numpy(grads[0].copy()),
              torch.from_numpy(grads[1].astype(np.float32)).bfloat16()]
    got, _ = tgs.synchronize_gradients_rank_major(stacks, residuals=t_res)
    _ulps(got[0].numpy(), want[0], 40.0)
    np.testing.assert_allclose(got[1].float().numpy(),
                               want[1].astype(np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


def test_ef_wrong_state_and_knobs_raise():
    stacks = [torch.ones(N, 64, 32)]
    with pytest.raises(tc.ResidualMismatchError, match="bucket layout"):
        tgs.synchronize_gradients_rank_major(
            stacks, residuals=[torch.zeros(N, 4)] * 3)
    good = tgs.init_dcn_residuals([torch.ones(64, 32)], n=N)
    for kw, match in (({"backend": "xla"}, "backend="),
                      ({"compress": "bf16"}, "compress="),
                      ({"barrier": True}, "barrier=")):
        with pytest.raises(ValueError, match=match):
            tgs.synchronize_gradients_rank_major(stacks, residuals=good,
                                                 **kw)
    with pytest.raises(ValueError, match="no DCN codec"):
        tgs.synchronize_gradients_rank_major(stacks, residuals=good,
                                             dcn_compress="off")


def test_ef_sub_floor_passes_the_residual_through():
    """A dcn shard below ``dcn_compress_min_bytes`` crosses uncompressed:
    the stock sum, and the residual state handed back as it came."""
    grads = _general((N, 64, 32), 6)
    res = [torch.full((N, 512), 0.5)]
    tmpi.set_config(dcn_compress_min_bytes=1 << 20)
    try:
        got, out = tgs.synchronize_gradients_rank_major(
            [torch.from_numpy(grads.copy())], op="sum", residuals=res)
    finally:
        tmpi.set_config(dcn_compress_min_bytes=0)
    assert out[0] is res[0]
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(grads.sum(0), grads.shape),
                               rtol=1e-5, atol=1e-5)


def test_ef_flat_grid_degrades():
    tsel._warned_fallbacks.clear()
    x = _general((4, 40), 8)
    res = tgs.init_dcn_residuals([torch.zeros(40)], n=4)
    tmpi.set_config(dcn_size=None)
    try:
        with pytest.warns(RuntimeWarning, match="flat world"):
            got, out = tgs.synchronize_gradients_rank_major(
                [torch.from_numpy(x.copy())], op="sum", residuals=res)
    finally:
        tmpi.set_config(dcn_size=2)
    assert out is res
    assert torch.equal(got[0], tmpi.allreduce_rank_major(torch.from_numpy(x)))


def test_ef_beats_single_shot_over_steps():
    """JAX test_compress.py :226: the running mean of the EF syncs of one
    gradient converges to the exact value; single-shot quantization (the
    residual never kept) keeps its bias."""
    base = np.random.RandomState(4).randn(N, 256).astype(np.float32)
    base[:, :4] *= 100.0
    exact = base.mean(0)
    res = tgs.init_dcn_residuals([torch.zeros(256)], n=N)
    zero = tgs.init_dcn_residuals([torch.zeros(256)], n=N)
    ef, ss = 0.0, 0.0
    steps = 6
    for _ in range(steps):
        a, res = tgs.synchronize_gradients_rank_major(
            [torch.from_numpy(base.copy())], residuals=res)
        b, _ = tgs.synchronize_gradients_rank_major(
            [torch.from_numpy(base.copy())], residuals=zero)
        ef = ef + a[0][0].numpy()
        ss = ss + b[0][0].numpy()
    ef_err = np.abs(ef / steps - exact).mean()
    ss_err = np.abs(ss / steps - exact).mean()
    assert ef_err < 0.5 * ss_err, (ef_err, ss_err)


# ---------------------------------------------------------------------------
# The overlapped form
# ---------------------------------------------------------------------------


def test_ef_overlap_matches_jax():
    """``make_overlapped_grad_fn(_rank_major)(residuals=True)`` against
    JAX's on exact inputs: two firing buckets (w, then b), three steps."""
    r = np.random.RandomState(3)
    w = (r.randint(-4, 4, size=(16, 8)) * 0.25).astype(np.float32)
    b = (r.randint(-4, 4, size=(8,)) * 0.25).astype(np.float32)
    mesh = jmpi.world_mesh()

    def jloss(p, x):
        return jnp.sum((x @ p["w"] + p["b"]) ** 2) * 0.125

    params = {"b": jnp.asarray(b), "w": jnp.asarray(w)}
    jvag = jgs.make_overlapped_grad_fn(jloss, params, AXES, residuals=True,
                                       max_bytes=256)
    j_res = jgs.init_overlap_dcn_residuals(params, AXES, max_bytes=256)
    f = jax.jit(shard_map(lambda p, rs, x: jvag(p, rs, x[0]), mesh=mesh,
                          in_specs=(P(), P(AXES), P(AXES)),
                          out_specs=(P(), (P(), P(AXES))), check_vma=False))

    def tloss(leaves, x):
        tb, tw = leaves
        return ((x @ tw + tb) ** 2).sum() * 0.125

    tparams = [torch.from_numpy(b), torch.from_numpy(w)]
    tvag = tgs.make_overlapped_grad_fn_rank_major(
        tloss, tparams, N, residuals=True, max_bytes=256)
    t_res = tgs.init_overlap_dcn_residuals(tparams, max_bytes=256, n=N)
    assert [tuple(x.shape) for x in t_res] == [x.shape for x in j_res]
    for step in range(3):
        x = (r.randint(-4, 4, size=(N, 4, 16)) * 0.5).astype(np.float32)
        _, (jg, j_res) = f(params, j_res, _put(x, mesh))
        _, (stacks, t_res) = tvag(tparams, t_res,
                                  torch.from_numpy(x.reshape(N * 4, 16)))
        ref = float(np.abs(np.asarray(jg["w"])).max()) * N
        _ulps(stacks[0][0].numpy(), np.asarray(jg["b"]), ref)
        _ulps(stacks[1][0].numpy(), np.asarray(jg["w"]), ref)
        for tr, jr in zip(t_res, j_res):
            _ulps(tr.numpy(), np.asarray(jr), ref)
    with pytest.raises(tc.ResidualMismatchError, match="overlap bucket"):
        tvag(tparams, [torch.zeros(N, 3)] * 2,
             torch.zeros(N * 4, 16))


# ---------------------------------------------------------------------------
# ZeRO-1 / ZeRO-3
# ---------------------------------------------------------------------------


def _zero_inputs(seed):
    r = np.random.RandomState(seed)
    params = {"b": (r.randint(-8, 8, size=(30,)) * 0.5).astype(np.float32),
              "w": (r.randint(-8, 8, size=(16, 9)) * 0.5).astype(np.float32)}
    grads = [_exact((N, 30), seed + 1), _exact((N, 16, 9), seed + 2)]
    return params, grads


@pytest.mark.parametrize("level", [1, 3])
def test_ef_zero_matches_jax(level):
    """Two EF ZeRO steps (SGD, lr 0.5): the parameters (or shards) and the
    residuals against JAX's ``zero.update`` / ``update3`` with
    ``dcn_residuals``; the shards land dcn-major.  The first step's inputs
    are exact (a few ulps apart); the second adds residuals that are
    already an ulp apart, and one ulp can move a payload across a rounding
    boundary, so it is held within one quantum per element."""
    params, grads0 = _zero_inputs(1)
    mesh = jmpi.world_mesh()
    jtx, ttx = optax.sgd(0.5), toptim.sgd(0.5)
    j_res = jzero.init_dcn_residuals(params, AXES)
    tparams = [torch.from_numpy(params["b"]), torch.from_numpy(params["w"])]
    t_res = tzero.init_dcn_residuals(tparams, n=N)
    assert [tuple(x.shape) for x in t_res] == [x.shape for x in j_res]
    spec = tzero.flat_spec(tparams, n_shards=N)
    jspec = jzero.flat_spec(params, AXES)
    jp, tp = params, tparams
    if level == 3:
        jp = jzero.shard_params(params, AXES)
        tp = tzero.shard_params_rank_major(tparams, N)
    j_opt = jax.jit(shard_map(lambda q: jtx.init(q), mesh=mesh,
                              in_specs=P(AXES) if level == 3 else P(),
                              out_specs=P(AXES), check_vma=False))(jp)
    t_opt = ttx.init(tp if level == 3 else
                     tzero.shard_params_rank_major(tparams, N))

    def body(p, g, s, rs):
        g = {"b": g[0][0], "w": g[1][0]}
        if level == 3:
            return jzero.update3(p, g, s, jtx, AXES, spec=jspec,
                                 dcn_residuals=rs)
        return jzero.update(p, g, s, jtx, AXES, dcn_residuals=rs)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(
        P(AXES) if level == 3 else P(), P(AXES), P(AXES), P(AXES)),
        out_specs=(P(AXES) if level == 3 else P(), P(AXES), P(AXES)),
        check_vma=False))
    for step in range(2):
        grads = [g * (step + 1) for g in grads0]
        jp, j_opt, j_res = f(jp, [_put(g, mesh) for g in grads], j_opt,
                             j_res)
        flats = tfusion.group_flats([torch.from_numpy(g) for g in grads],
                                    spec)
        q = _quantum(flats[0].numpy())

        def close(got, want, ref):
            if step == 0:
                _ulps(got, want, ref)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=q)

        if level == 3:
            tp, t_opt, t_res = tzero.update3_rank_major(
                tp, flats, t_opt, ttx, spec=spec, dcn_residuals=t_res)
            close(tp.numpy(), np.asarray(jp).reshape(N, -1), 64.0)
        else:
            tp, t_opt, t_res = tzero.update_rank_major(
                tp, flats, t_opt, ttx, dcn_residuals=t_res)
            close(tp[0].numpy(), np.asarray(jp["b"]), 64.0)
            close(tp[1].numpy(), np.asarray(jp["w"]), 64.0)
        for tr, jr in zip(t_res, j_res):
            close(tr.numpy(), np.asarray(jr), 64.0)


def test_ef_zero_presynced_passes_residuals():
    params, grads = _zero_inputs(2)
    tparams = [torch.from_numpy(params["b"]), torch.from_numpy(params["w"])]
    ttx = toptim.sgd(0.5)
    spec = tzero.flat_spec(tparams, n_shards=N)
    res = [r + 3.0 for r in tzero.init_dcn_residuals(tparams, n=N)]
    flats = tfusion.group_flats([torch.from_numpy(g) for g in grads], spec)
    out = tzero.update_rank_major(tparams, flats, ttx.init(
        tzero.shard_params_rank_major(tparams, N)), ttx, presynced=True,
        dcn_residuals=res)
    assert len(out) == 3 and out[2] is res


def test_codec_module_never_imported_when_off():
    """JAX's discipline (compress.py docstring): the two-level verbs, the
    syncs and the recipes with ``dcn_compress="off"`` never import the
    codec module."""
    code = textwrap.dedent("""
        import sys, torch
        import torchmpi_tpu_torch as mpi
        from torchmpi_tpu_torch.parallel import gradsync, zero
        mpi.init(device="cpu", dcn_size=2)
        xs = torch.randn(4, 1000)
        mpi.allreduce_rank_major(xs, backend="hierarchical")
        gradsync.synchronize_gradients_rank_major([xs.clone()],
                                                  backend="hierarchical")
        gradsync.synchronize_gradients_rank_major([xs.clone()],
                                                  backend="pallas")
        ps = [torch.randn(10)]
        spec = zero.flat_spec(ps, n_shards=4)
        zero.update_rank_major(ps, [torch.randn(4, spec.groups[0].padded)],
                               (), mpi.optim.sgd(0.1))
        mpi.stop()
        assert "torchmpi_tpu_torch.compress" not in sys.modules
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]
