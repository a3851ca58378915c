"""The port's two-level (dcn x ici) verbs (torchmpi_tpu_torch/parallel/
hierarchical.py, the "hierarchical" backend, the two-level "pallas" route
of ops/ring.py) against the JAX package on the CPU.

- The six hierarchical verbs, rank-major n = 8 as dcn 2 x ici 4
  (``Config(dcn_size=2)``), against JAX's eager verbs with
  ``backend="hierarchical"`` on its 2 x 4 world mesh: bitwise for gather,
  scatter, allgather, broadcast, max / min and int32 sums; float sums
  within rtol 1e-6 (the two sides add in other orders).
- The chunk-pipelined allreduce bitwise to the unchunked one; the chunk
  count and its clamp at the codec floor (JAX hierarchical.py :160-177),
  held against JAX's int8 hierarchical allreduce on inputs whose sums are
  exact in any order (small integers times a power of two): the same
  payloads, the decoded sums within two ulps (ROADMAP queue C note 19).
- The flat grid: "hierarchical" warns once per (op, backend) and runs the
  stock route.
- The two-level "pallas" route (ROADMAP queue B variant 3) against JAX's
  ring in interpret mode on the 2 x 4 mesh (ring over ici, dcn outside):
  allreduce, reduce-scatter and all-gather, bitwise for float32 and int32,
  ring chunks within 12 KB.
- The in-axis sub-stacks of the rank-major verbs (``axis_names``) against
  JAX's in-axis verbs over one mesh axis.
- A small BatchNorm DP recipe step (ResNet-20, 4 ranks as 2 x 2) with
  ``backend="hierarchical"`` against JAX's within the recipe tests' 1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu import recipes as jrecipes
from torchmpi_tpu.models import ResNet20 as JResNet20
from torchmpi_tpu.ops import ring as jring
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import recipes
from torchmpi_tpu_torch import selector as tsel
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import ResNet20, layers
from torchmpi_tpu_torch.ops import ring as tring
from torchmpi_tpu_torch.parallel import hierarchical as thier

torch.set_num_threads(2)

N = 8
DCN = 2


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """The JAX runtime on its 2 x 4 world mesh and the port's runtime (CPU,
    gloo, a world of one) factoring rank-major stacks as dcn 2; the JAX
    ring in interpret mode."""
    if not hasattr(pltpu, "InterpretParams"):
        pytest.skip("pallas TPU interpreter unavailable on this jax")
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=DCN))
    tmpi.init(device="cpu", dcn_size=DCN)
    jring.set_interpret(pltpu.InterpretParams())
    yield
    jring.set_interpret(None)
    tmpi.stop()
    jmpi.stop()


def configure(**kw):
    jmpi.set_config(**kw)
    tmpi.set_config(**kw)


def _data(shape, dtype, seed=0, n=N):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return rng.randint(-1000, 1000, size=(n,) + shape).astype(np.int32)
    return rng.randn(*((n,) + shape)).astype(np.float32)


def _pair(verb, x, **kw):
    """(port, JAX) of rank-major ``verb`` on ``x`` under "hierarchical"."""
    got = getattr(tmpi, f"{verb}_rank_major")(torch.from_numpy(x),
                                              backend="hierarchical", **kw)
    want = np.asarray(getattr(jmpi, verb)(x, backend="hierarchical", **kw))
    return got.numpy(), want


@pytest.mark.parametrize("verb,kw,dtype", [
    ("allreduce", {"op": "sum"}, np.int32),
    ("allreduce", {"op": "max"}, np.float32),
    ("allreduce", {"op": "min"}, np.float32),
    ("allreduce", {"op": "sum"}, np.float32),
    ("allreduce", {"op": "mean"}, np.float32),
    ("broadcast", {"root": 5}, np.float32),
    ("reduce", {"root": 6, "op": "sum"}, np.int32),
    ("reduce", {"root": 1, "op": "max"}, np.float32),
    ("allgather", {}, np.float32),
    ("gather", {"root": 3}, np.float32),
    ("scatter", {"root": 6}, np.int32),
], ids=lambda v: v if isinstance(v, str) else None)
def test_hier_verbs_match_jax(verb, kw, dtype):
    x = _data((16, 12), dtype, seed=len(verb) + len(kw))
    got, want = _pair(verb, x, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == np.float32 and kw.get("op") in ("sum", "mean"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("verb", ["gather", "scatter"])
def test_chain_gather_scatter_match_jax(verb):
    """At or above ``chunk_bytes`` JAX takes its chain gather / scatter over
    the two levels (:245, :272); the port's data is the same."""
    configure(chunk_bytes=1024)
    try:
        got, want = _pair(verb, _data((64, 8), np.float32, seed=3), root=2)
    finally:
        configure(chunk_bytes=4 * 1024 * 1024)
    np.testing.assert_array_equal(got, want)


def test_chunked_equals_unchunked():
    """Chunks cut each rank's 2 ici-scattered KB down to 256 bytes (8
    chunks); every element folds in the same order, so the bits do not
    move; the JAX chunked allreduce agrees to float32 rounding."""
    x = torch.randn(N, 2048, generator=torch.Generator().manual_seed(1))
    tmpi.set_config(dcn_chunk_bytes=0)
    whole = tmpi.allreduce_rank_major(x, backend="hierarchical")
    configure(dcn_chunk_bytes=256)
    try:
        assert thier.chunk_count(2048, 4, 4) == 8
        chunked = tmpi.allreduce_rank_major(x, backend="hierarchical")
        want = np.asarray(jmpi.allreduce(x.numpy(), backend="hierarchical"))
    finally:
        configure(dcn_chunk_bytes=4 * 1024 * 1024)
    assert torch.equal(chunked, whole)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-6, atol=1e-6)


def test_chunk_count_clamp_at_codec_floor():
    """A codec floor of 512 bytes clamps 16 chunks of a 4 KB shard to 8
    (each leg keeps its floor).  On sums exact in any order both sides
    quantize the same shards to the same payloads and scales; their
    decoded sums then differ by ulps (XLA contracts JAX's
    ``q0 * s0 + q1 * s1`` into a fused multiply-add on the CPU, ROADMAP
    queue C note 19; two ulps of the largest sum bound it), far below the
    quantum (the scale, ~0.4 here) that another chunking would move an
    element by."""
    configure(dcn_chunk_bytes=256, dcn_compress="int8",
              dcn_compress_min_bytes=512)
    try:
        assert thier.chunk_count(4096, 4, 4) == 16
        assert thier.chunk_count(4096, 4, 4, "int8") == 8
        rng = np.random.RandomState(5)
        x = (rng.randint(-64, 64, size=(N, 4096)) * 0.25).astype(np.float32)
        got, want = _pair("allreduce", x, op="sum")
    finally:
        configure(dcn_chunk_bytes=4 * 1024 * 1024, dcn_compress="off",
                  dcn_compress_min_bytes=64 * 1024)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2 * ulp, np.abs(got - want).max()
    assert not np.array_equal(got, x.sum(0, keepdims=True).repeat(N, 0))


def test_flat_grid_warns_once_and_runs_stock():
    tsel._warned_fallbacks.clear()
    x = torch.arange(24.0).reshape(4, 6)
    tmpi.set_config(dcn_size=None)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            a = tmpi.allreduce_rank_major(x, backend="hierarchical")
            b = tmpi.allreduce_rank_major(x, backend="hierarchical")
            tmpi.set_config(hierarchical=True, custom_min_bytes=0)
            c = tmpi.broadcast_rank_major(x, root=1)
    finally:
        tmpi.set_config(dcn_size=DCN, hierarchical=False,
                        custom_min_bytes=64 * 1024)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 2 and "flat world" in msgs[0]
    assert "broadcast_rank_major" in msgs[1]
    assert torch.equal(a, tmpi.allreduce_rank_major(x, backend="xla"))
    assert torch.equal(b, a)
    assert torch.equal(c, x[1].expand(4, 6))


@pytest.mark.parametrize("verb", ["allreduce", "reduce_scatter",
                                  "allgather"])
def test_process_world_of_one_ring_under_dcn(verb):
    """The process world of one under ``dcn_size=2`` (this module's
    runtime): the "pallas" ring of one member returns this rank's data, as
    with no topology set; the grid factors the rank-major stacks only."""
    x = torch.arange(24.0).reshape(8, 3)
    got = getattr(tmpi, verb)(x, backend="pallas")
    assert torch.equal(got, x[None] if verb == "allgather" else x)


def test_config_hierarchical_picks_the_backend():
    """``Config.hierarchical`` routes over ``Config.backend`` (JAX
    collectives.py :305-315): the same bits as an explicit backend."""
    x = torch.randn(N, 300, generator=torch.Generator().manual_seed(2))
    tmpi.set_config(hierarchical=True, backend="pallas", custom_min_bytes=0)
    try:
        impl = tsel.select("allreduce_rank_major", ranks=N)
        assert impl.func is thier.hier_allreduce_rank_major
        assert impl.keywords == {"n_dcn": DCN}
        got = tmpi.allreduce_rank_major(x)
    finally:
        tmpi.set_config(hierarchical=False, backend="xla",
                        custom_min_bytes=64 * 1024)
    assert torch.equal(got, tmpi.allreduce_rank_major(
        x, backend="hierarchical"))


def _jax_ring(verb, x, *args):
    """``verb`` of JAX's ring under shard_map on the 2 x 4 world mesh."""
    mesh = jmpi.world_mesh()
    axes = ("dcn", "ici")
    fn = getattr(jring, f"ring_{verb}")

    def body(xs):
        return fn(xs[0], axes, *args)[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P(axes),
                          out_specs=P(axes), check_vma=False))
    return np.asarray(f(jax.device_put(jnp.asarray(x),
                                       NamedSharding(mesh, P(axes)))))


@pytest.mark.parametrize("verb,dtype,length", [
    ("allreduce", np.float32, 2048), ("allreduce", np.int32, 3000),
    ("reduce_scatter", np.float32, 4096), ("reduce_scatter", np.int32, 2048),
    ("all_gather", np.float32, 1000), ("all_gather", np.int32, 512),
])
def test_two_level_pallas_matches_jax_ring(verb, dtype, length):
    """Queue B variant 3: the ring over each node's 4 ici ranks, the dcn
    level folded around it, bitwise to JAX's ring (interpret mode) on the
    2 x 4 mesh; the kernel launches once per node on the card (the plain
    rows here, counted by the plain calls)."""
    x = _data((length,), dtype, seed=length)
    t = torch.from_numpy(x)
    calls = []
    plain = dict(tring.WRAPPERS)
    try:
        for name, fn in plain.items():
            tring.WRAPPERS[name] = (lambda f, nm: lambda *a: (
                calls.append((nm, a[0].shape[0])), f(*a))[1])(fn, name)
        got = {"allreduce": tring.ring_allreduce,
               "reduce_scatter": tring.ring_reduce_scatter,
               "all_gather": tring.ring_all_gather}[verb](t, n_dcn=DCN)
    finally:
        tring.WRAPPERS.update(plain)
    want = _jax_ring(verb, x)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    assert len(calls) == DCN and all(m == N // DCN for _, m in calls)


@pytest.mark.parametrize("verb,axis,kw", [
    ("allreduce", "ici", {}), ("allreduce", "dcn", {}),
    ("allgather", "ici", {}), ("reduce_scatter", "dcn", {}),
    ("broadcast", "ici", {"root": 2}), ("gather", "dcn", {"root": 1}),
])
def test_rank_major_sub_axis_matches_jax_in_axis(verb, axis, kw):
    """``axis_names="ici"`` / ``"dcn"`` on a rank-major stack: each group of
    that axis on its own, as JAX's in-axis verb over one mesh axis of the
    2 x 4 mesh (int32, bitwise)."""
    x = _data((8, 3), np.int32, seed=7)
    got = getattr(tmpi, f"{verb}_rank_major")(torch.from_numpy(x),
                                              axis_names=axis, **kw)
    mesh = jmpi.world_mesh()
    jfn = getattr(jmpi.collectives, f"{verb}_in_axis")

    def body(xs):
        return jfn(xs[0], axis, **kw)[None]

    axes = ("dcn", "ici")
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P(axes),
                          out_specs=P(axes), check_vma=False))
    want = np.asarray(f(jax.device_put(jnp.asarray(x),
                                       NamedSharding(mesh, P(axes)))))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bn_recipe_hierarchical_matches_jax():
    """ResNet-20, 4 ranks as dcn 2 x ici 2, a global batch of 8, two SGD
    steps with ``backend="hierarchical"`` (the gradient buckets and the
    BatchNorm statistics on the two-level allreduce) against JAX's recipe on
    a 2 x 2 mesh: losses, parameters and statistics within 1e-4."""
    n = 4
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(2, 2), ("dcn", "ici"))
    jm = JResNet20()
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jtx = optax.sgd(0.1, momentum=0.9)
    j_step = jrecipes.make_bn_dp_train_step(jm, jtx, mesh=mesh,
                                            backend="hierarchical",
                                            donate=False)
    jp, jo, js = jrecipes.replicate_bn_state(
        v["params"], jtx.init(v["params"]), v["batch_stats"], mesh=mesh)
    model = ResNet20(device="cpu")
    model.load_state_dict(tweights.from_flax_cnn(
        jax.tree.map(np.asarray, dict(v)), model))
    ttx = toptim.sgd(0.1, momentum=0.9)
    params, stats = recipes.bn_state(model)
    opt = [ttx.init(p) for p in params]
    t_step = recipes.make_bn_dp_train_step_rank_major(
        model, ttx, n, backend="hierarchical")
    rng = np.random.RandomState(0)
    for i in range(2):
        x = rng.rand(2 * n, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, size=2 * n).astype(np.int32)
        jp, jo, js, jl = j_step(jp, jo, js, x, y)
        params, opt, stats, tl = t_step(
            params, opt, stats, torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = tweights.from_flax_cnn(
        {"params": jax.tree.map(np.asarray, jp),
         "batch_stats": jax.tree.map(np.asarray, js)}, model)
    for (name, _), got in zip(model.named_parameters(), params):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name, got in zip(layers.batch_stats_names(model), stats):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_config_fields_and_grid_match_jax(monkeypatch):
    """The six topology / two-level fields: JAX's names, defaults and
    environment variables; a rank-major grid factors n as JAX's world mesh
    factors its devices, with its messages."""
    from torchmpi_tpu import runtime as jruntime
    from torchmpi_tpu_torch import runtime as truntime

    fields = ("dcn_size", "ici_size", "hierarchical", "dcn_chunk_bytes",
              "dcn_compress", "dcn_compress_min_bytes")
    for f in fields:
        assert getattr(tmpi.Config(), f) == getattr(jmpi.Config(), f), f
    env = {"TORCHMPI_TPU_DCN_SIZE": "2", "TORCHMPI_TPU_ICI_SIZE": "4",
           "TORCHMPI_TPU_HIERARCHICAL": "1",
           "TORCHMPI_TPU_DCN_CHUNK_BYTES": "12345",
           "TORCHMPI_TPU_DCN_COMPRESS": "fp8",
           "TORCHMPI_TPU_DCN_COMPRESS_MIN_BYTES": "77"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = tmpi.Config.from_env(), jmpi.Config.from_env()
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f
    devices = jax.devices()
    for dcn, ici in ((2, None), (None, 4), (2, 4), (3, None), (None, 3),
                     (2, 2)):
        want = None
        try:
            m = jruntime._build_world_mesh(jmpi.Config(dcn_size=dcn,
                                                       ici_size=ici),
                                           devices)
            want = (int(m.shape["dcn"]), int(m.shape["ici"]))
        except ValueError as e:
            want = str(e)
        try:
            got = truntime._factor(len(devices), dcn, ici)
        except ValueError as e:
            got = str(e)
        assert got == want, (dcn, ici)
