"""The port's collective planner (torchmpi_tpu_torch/planner.py) on the CPU.

The cases of ``tests/test_planner.py`` but its telemetry and
pushed-communicator ones (ROADMAP queue A, items 10 and 1): a hit on the
same structure with other values, a new plan for a new shape or dtype,
re-plans on a ``set_config`` (epoch, backend, ``fuse_max_bytes``), a
re-registered implementation, ``clear_cache`` and a grid change; planned
results bit for bit equal to ``planner.set_enabled(False)`` on the eager
(rank-major), process-world, in-axis tree, gradsync, overlap and ZeRO
paths; ``describe`` rows.  The gradsync, overlap and ZeRO results are also
held against the JAX package's on the same seeded inputs, at the
tolerances of tests/test_torch_overlap.py and tests/test_torch_zero.py.
Under ``backend="auto"`` a gradient sync equals, bitwise, the same sync
under the explicit backend the plan chose for each bucket.  The runtime is
a world of one gloo process (stacks of 8 ranks rank-major).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from torchmpi_tpu import fusion as jfusion
from torchmpi_tpu.parallel import gradsync as jgs, zero as jzero
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import fusion, optim, planner, selector, tuning
from torchmpi_tpu_torch.parallel import gradsync, zero
from torchmpi_tpu_torch.tuning import autoselect
from torchmpi_tpu_torch.utils import metrics

from _torch_world import module_group

torch.set_num_threads(2)
N = 8


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture()
def planned(request):
    kw = getattr(request, "param", {})
    tmpi.stop()
    tmpi.init(device="cpu", **kw)
    planner.reset_stats()
    yield
    planner.set_enabled(True)
    tmpi.stop()


def rank_major(elems=32, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(N, elems, generator=g).to(dtype)


def mixed_tree(seed=0, lead=()):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(*lead, 8, 4, generator=g),
            "b": torch.randn(*lead, 8, 4, generator=g).to(torch.bfloat16),
            "c": torch.randn(*lead, 8, 2, generator=g)}


def _unplanned(fn, *args, **kw):
    prev = planner.set_enabled(False)
    try:
        return fn(*args, **kw)
    finally:
        planner.set_enabled(prev)


def _same(a, b) -> bool:
    la, lb = tmpi._tree.leaves(a), tmpi._tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Hit / miss and replay
# ---------------------------------------------------------------------------


def test_eager_hit_on_same_structure_different_values(planned):
    x1, x2 = rank_major(seed=1), rank_major(seed=2)
    out1 = tmpi.allreduce_rank_major(x1)
    st = planner.stats()
    assert st["misses"] == 1 and st["hits"] == 0
    out2 = tmpi.allreduce_rank_major(x2)
    st = planner.stats()
    assert st["misses"] == 1 and st["hits"] == 1
    assert torch.allclose(out1[0], x1.sum(0), rtol=1e-5)
    assert torch.allclose(out2[0], x2.sum(0), rtol=1e-5)


def test_eager_new_shape_or_dtype_is_new_plan(planned):
    tmpi.allreduce_rank_major(rank_major(32))
    tmpi.allreduce_rank_major(rank_major(64))
    tmpi.allreduce_rank_major(rank_major(32, torch.float16))
    assert planner.stats()["misses"] == 3


EAGER_CASES = [
    ("allreduce", {}), ("allreduce", {"op": "mean"}),
    ("allreduce", {"backend": "pallas"}), ("broadcast", {"root": 2}),
    ("reduce", {"root": 5, "op": "max"}), ("reduce_scatter", {}),
    ("reduce_scatter", {"backend": "pallas"}), ("allgather", {}),
    ("allgather", {"backend": "pallas"}), ("gather", {"root": 1}),
    ("scatter", {"root": 3}), ("sendreceive", {"src": 2, "dst": 6}),
    ("alltoall", {}), ("allreduce", {"backend": "host"}),
    ("allreduce", {"axis_names": "ici"}),
    ("allreduce", {"axis_names": "dcn", "backend": "pallas"}),
    ("allreduce", {"backend": "hierarchical"}),
]


@pytest.mark.parametrize("planned", [{"dcn_size": 2}], indirect=True)
def test_eager_bitwise_vs_unplanned(planned):
    x = rank_major(48)
    for verb, kw in EAGER_CASES:
        fn = getattr(tmpi, f"{verb}_rank_major")
        planned_out = fn(x, **kw)
        assert _same(planned_out, _unplanned(fn, x, **kw)), (verb, kw)
        assert _same(planned_out, fn(x, **kw)), (verb, kw)  # the replay
    assert planner.stats()["hits"] == len(EAGER_CASES)


def test_async_rank_major_rides_the_plan(planned):
    x = rank_major(64)
    for kw in ({}, {"backend": "pallas"}):
        h = tmpi.async_.allreduce(x, **kw)
        assert _same(h.wait(), _unplanned(tmpi.allreduce_rank_major, x,
                                          **kw))
    rows = [r for r in planner.describe() if r["kind"] == "eager"]
    assert sorted(r["backend"] for r in rows) == ["pallas", "xla"]


def test_in_axis_plan_reuse(planned):
    tree = mixed_tree()
    r1 = tmpi.allreduce_in_axis(tree, ("dcn", "ici"))
    assert planner.stats()["misses"] == 1
    r2 = tmpi.allreduce_in_axis(mixed_tree(), ("dcn", "ici"))
    st = planner.stats()
    assert st["misses"] == 1 and st["hits"] == 1
    assert _same(r1, r2)


def test_in_axis_bitwise_vs_unplanned(planned):
    tree = mixed_tree()
    x = torch.randn(16, 3)
    for verb, kw in (("allreduce", {"op": "sum"}),
                     ("allreduce", {"op": "mean"}),
                     ("broadcast", {"root": 0}), ("reduce", {"root": 0}),
                     ("reduce_scatter", {}), ("allgather", {}),
                     ("alltoall", {})):
        fn = getattr(tmpi, f"{verb}_in_axis")
        for arg in (tree, x):
            for axes in (None, "ici"):
                got = fn(arg, axes, **kw)
                assert _same(got, _unplanned(fn, arg, axes, **kw)), verb
                assert _same(got, fn(arg, axes, **kw)), verb
    for verb, kw in (("allreduce", {}), ("reduce_scatter", {}),
                     ("allgather", {})):
        fn = getattr(tmpi, verb)
        assert _same(fn(x, **kw), _unplanned(fn, x, **kw))


def test_eager_and_in_axis_entry_points_share_the_table(planned):
    x = rank_major()
    tmpi.allreduce_rank_major(x)
    tmpi.allreduce_in_axis(mixed_tree(), ("dcn", "ici"))
    tmpi.allreduce(x[0])
    kinds = {r["kind"] for r in planner.describe()}
    assert {"eager", "in_axis-fused", "world"} <= kinds
    planner.reset_stats()
    tmpi.allreduce_rank_major(x)
    tmpi.allreduce_in_axis(mixed_tree(), ("dcn", "ici"))
    tmpi.allreduce(x[0])
    assert planner.stats()["misses"] == 0


# ---------------------------------------------------------------------------
# Invalidation: config epoch, backend, fuse bytes, registry, clear_cache,
# grid
# ---------------------------------------------------------------------------


def test_set_config_bumps_epoch_and_replans(planned):
    x = rank_major()
    tmpi.allreduce_rank_major(x)
    e0 = tmpi.config_epoch()
    planner.reset_stats()
    tmpi.set_config(custom_min_bytes=128)
    assert tmpi.config_epoch() == e0 + 1
    tmpi.allreduce_rank_major(x)
    assert planner.stats()["misses"] == 1


@pytest.mark.parametrize("planned", [{"dcn_size": 2}], indirect=True)
def test_set_config_backend_switch_replans(planned):
    x = rank_major()
    tmpi.allreduce_rank_major(x)
    assert [r["backend"] for r in planner.describe()] == ["xla"]
    tmpi.set_config(backend="hierarchical", custom_min_bytes=0)
    out = tmpi.allreduce_rank_major(x)
    assert [r["backend"] for r in planner.describe()] == ["hierarchical"]
    assert torch.allclose(out[0], x.sum(0), rtol=1e-5)


def test_set_config_fuse_bytes_replans(planned):
    tree = mixed_tree()

    def launches():
        tmpi.allreduce_in_axis(tree, ("dcn", "ici"))
        (row,) = planner.describe()
        return row["launches"]

    assert launches() == 2  # two dtype groups, fused
    tmpi.set_config(fuse_max_bytes=0)
    assert launches() == 3  # per leaf: the fused plan is gone
    tmpi.set_config(fuse_max_bytes=32 * 1024 * 1024)
    assert launches() == 2


def test_selector_reregister_strands_stale_plans(planned):
    x = rank_major()
    tmpi.allreduce_rank_major(x)
    planner.reset_stats()
    impl = selector.available("allreduce_rank_major")["xla"]
    selector.register("allreduce_rank_major", "xla", impl)
    out = tmpi.allreduce_rank_major(x)
    assert planner.stats()["misses"] == 1
    assert torch.allclose(out[0], x.sum(0), rtol=1e-5)


def test_clear_cache_is_the_invalidation_point(planned):
    tmpi.allreduce_rank_major(rank_major())
    assert planner.stats()["entries"] == 1
    tmpi.collectives.clear_cache()
    assert planner.stats()["entries"] == 0
    assert planner.stats()["invalidations"] >= 1


def test_grid_change_invalidates():
    tmpi.stop()
    tmpi.init(device="cpu", dcn_size=1)
    x = rank_major()
    try:
        tmpi.allreduce_rank_major(x, backend="hierarchical")
        assert planner.stats()["entries"] >= 1
        assert planner.describe()[0]["topology"] == "1x8"
    finally:
        tmpi.stop()
    assert planner.stats()["entries"] == 0
    tmpi.init(device="cpu", dcn_size=2)
    try:
        planner.reset_stats()
        out = tmpi.allreduce_rank_major(x, backend="hierarchical")
        assert planner.stats()["misses"] == 1
        (row,) = planner.describe()
        assert (row["topology"], row["backend"]) == ("2x4", "hierarchical")
        assert torch.allclose(out[0], x.sum(0), rtol=1e-5)
        tmpi.set_config(dcn_size=4)  # a new grid, the same stack
        tmpi.allreduce_rank_major(x, backend="hierarchical")
        assert planner.stats()["misses"] == 2
        assert planner.describe()[-1]["topology"] == "4x2"
    finally:
        tmpi.stop()


# ---------------------------------------------------------------------------
# gradsync, overlap and ZeRO consumers
# ---------------------------------------------------------------------------


def _jax_sync(grads, **kw):
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    fn = jax.jit(shard_map(
        lambda g: jgs.synchronize_gradients(g, ("dp",), **kw), mesh=mesh,
        in_specs=P("dp"), out_specs=P("dp"), check_vma=False))
    return [np.asarray(a, np.float32) for a in fn(grads)]


@pytest.mark.parametrize("n_buckets", [1, 3])
def test_gradsync_bucketed_planned_bitwise(planned, n_buckets):
    rng = np.random.RandomState(n_buckets)
    grads = [rng.randn(N, 4096).astype(np.float32),
             rng.randn(N, 513).astype(np.float32),
             rng.randn(N, 7, 3).astype(np.float32)]

    def run():
        stacks = [torch.from_numpy(g.copy()) for g in grads]
        gradsync.synchronize_gradients_rank_major(stacks, op="mean",
                                                  n_buckets=n_buckets)
        return stacks

    got = run()
    assert any(r["kind"] == "gradsync" for r in planner.describe())
    assert _same(got, _unplanned(run))
    planner.reset_stats()
    assert _same(got, run())
    assert planner.stats()["misses"] == 0
    want = _jax_sync(grads, op="mean", n_buckets=n_buckets)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_fused_process_world_planned_bitwise(planned):
    params = [torch.randn(10, 3), torch.randn(7).to(torch.bfloat16),
              torch.randn(5)]
    for p in params:
        p.grad = p.detach() * 3
    before = [p.grad.clone() for p in params]
    gradsync.synchronize_gradients(params, op="sum")
    gradsync.synchronize_parameters(params)
    assert all(torch.equal(p.grad, b) for p, b in zip(params, before))
    kinds = sorted(r["kind"] for r in planner.describe())
    assert kinds == ["gradsync", "gradsync"]
    again = [p.grad.clone() for p in params]
    _unplanned(gradsync.synchronize_gradients, params, op="sum")
    assert all(torch.equal(p.grad, b) for p, b in zip(params, again))


MIXED = [((32,), torch.float32), ((8, 32), torch.float32),
         ((32, 32), torch.bfloat16), ((32, 4), torch.float32)]


def _mixed():
    rng = np.random.RandomState(0)
    arrs = [rng.randn(*s).astype(np.float32) for s, _ in MIXED]
    return arrs, [torch.from_numpy(a).to(d) for a, (_, d) in zip(arrs, MIXED)]


def _mixed_loss(leaves, x, y):
    b1, w1, w2, w3 = leaves
    h = torch.tanh(x @ w1 + b1)
    h = torch.tanh(h.to(torch.bfloat16) @ w2)
    return ((h.to(torch.float32) @ w3 - y) ** 2).mean()


def test_overlap_decision_planned(planned):
    arrs, params = _mixed()
    x = torch.from_numpy(np.random.RandomState(0).rand(N * 8, 8)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).rand(N * 8, 4)
                         .astype(np.float32))

    def run():
        return gradsync.make_overlapped_grad_fn_rank_major(
            _mixed_loss, params, N, max_bytes=1024)(params, x, y)

    l1, g1 = run()
    assert any(r["kind"] == "overlap" for r in planner.describe())
    (row,) = [r for r in planner.describe() if r["kind"] == "overlap"]
    assert row["launches"] == 4
    misses = planner.stats()["misses"]
    l2, g2 = run()
    assert planner.stats()["misses"] == misses
    l3, g3 = _unplanned(run)
    assert _same(g1, g2) and _same(g1, g3)
    # Against JAX's overlapped schedule on the same tree and batch.
    jtree = {"l1": {"b": jnp.asarray(arrs[0]), "w": jnp.asarray(arrs[1])},
             "l2": {"w": jnp.asarray(arrs[2], jnp.bfloat16)},
             "l3": {"w": jnp.asarray(arrs[3])}}

    def jloss(p, xb, yb):
        h = jnp.tanh(xb @ p["l1"]["w"] + p["l1"]["b"])
        h = jnp.tanh(h.astype(jnp.bfloat16) @ p["l2"]["w"])
        return jnp.mean((h.astype(jnp.float32) @ p["l3"]["w"] - yb) ** 2)

    mesh = Mesh(np.array(jax.devices()), ("dp",))
    _, jg = jax.jit(shard_map(
        lambda p, xb, yb: jgs.make_overlapped_grad_fn(
            jloss, p, ("dp",), max_bytes=1024)(p, xb, yb), mesh=mesh,
        in_specs=(P(), P("dp"), P("dp")), out_specs=(P(), P()),
        check_vma=False))(jtree, x.numpy(), y.numpy())
    want = [jg["l1"]["b"], jg["l1"]["w"], jg["l2"]["w"], jg["l3"]["w"]]
    for st, w in zip(g1, want):
        np.testing.assert_allclose(st[0].float().numpy(),
                                   np.asarray(w, np.float32), rtol=2e-2,
                                   atol=2e-2)


SHAPES = [(16, 12), (12,), (10, 4), (3,)]


def test_zero_update_planned_bitwise(planned):
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [rng.randn(4, *s).astype(np.float32) for s in SHAPES]
    tparams = [torch.from_numpy(p) for p in params]
    ttx, jtx = optim.sgd(0.1, momentum=0.9), optax.sgd(0.1, momentum=0.9)

    def run():
        spec = zero.flat_spec(tparams, n_shards=4)
        flats = fusion.group_flats([torch.from_numpy(g) for g in grads],
                                   spec)
        return zero.update_rank_major(tparams, flats,
                                      zero.init_rank_major(tparams, ttx, 4),
                                      ttx)

    p1, s1 = run()
    assert any(r["kind"] == "flatspec" for r in planner.describe())
    p2, s2 = _unplanned(run)
    assert _same(p1, p2) and _same(s1.trace, s2.trace)
    spec = zero.flat_spec(tparams, n_shards=4)
    jspec = jfusion.FusedSpec(params, 4)
    assert (spec.padded, spec.shard) == (jspec.padded, jspec.shard)
    # Against JAX's ZeRO-1 update on 4 devices (the stock routes).
    axes = ("dp",)
    mesh = Mesh(np.array(jax.devices()[:4]), axes)
    state = jzero.init(params, jtx, axes, mesh=mesh)
    sspecs = jzero.specs_like(state, axes)
    jp, _ = jax.jit(shard_map(
        lambda p, s, g: jzero.update(p, g, s, jtx, axes), mesh=mesh,
        in_specs=(P(), sspecs, P(axes)), out_specs=(P(), sspecs),
        check_vma=False))(params, state, grads)
    for got, want in zip(p1, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# "auto": per-bucket routes, replayed bitwise
# ---------------------------------------------------------------------------


def test_auto_gradsync_equals_per_bucket_explicit_backends(tmp_path,
                                                           monkeypatch):
    """The first sync measures each bucket's key (stubbed timings: the ring
    wins the large buckets, the stock route the small one); the sync then
    equals, bitwise, the same sync under each bucket's chosen backend."""
    def fake_measure(step, iters=1, rounds=3, fence=None):
        step()
        return metrics.TimedResult(fake_measure.times.pop(0))

    # Measured in bucket order, candidates sorted: hierarchical is not
    # eligible on this flat grid, so "pallas" then "xla" a key.
    fake_measure.times = [[0.1] * 4, [1.0] * 4,   # float32 b13: pallas
                          [1.0] * 4, [0.9] * 4]   # bfloat16 b10: xla
    monkeypatch.setattr(autoselect.measure, "measure", fake_measure)
    tmpi.stop()
    tmpi.init(tmpi.Config(backend="auto",
                          tuning_plan_path=str(tmp_path / "p.json"),
                          fuse_max_bytes=16 * 1024), device="cpu")
    try:
        tuning.reset_measurement_count()
        rng = np.random.RandomState(5)
        # One float32 group in two buckets of 3000 (one key, b13), one
        # bfloat16 group in one bucket (b10).
        base = [torch.from_numpy(rng.randn(N, 6000).astype(np.float32)),
                torch.from_numpy(rng.randn(N, 600).astype(np.float32))
                .to(torch.bfloat16)]

        def fresh():
            return [t.clone() for t in base]

        stacks = fresh()
        gradsync.synchronize_gradients_rank_major(stacks, op="mean")
        assert tuning.measurement_count() == 2
        (row,) = [r for r in planner.describe() if r["kind"] == "gradsync"]
        assert row["backends"] == ["pallas", "pallas", "xla"]
        spec = fusion.FusedSpec([t[0] for t in base])
        impls = [selector.select("allreduce_rank_major", b, ranks=N)
                 for b in row["backends"]]
        ref = fresh()
        fusion.fused_allreduce_rank_major_(ref, spec=spec, impls=impls,
                                           op="mean")
        assert _same(stacks, ref)
        again = fresh()
        gradsync.synchronize_gradients_rank_major(again, op="mean")
        assert _same(again, ref) and tuning.measurement_count() == 2
        unplanned = fresh()
        _unplanned(gradsync.synchronize_gradients_rank_major, unplanned,
                   op="mean")
        assert _same(unplanned, ref)
    finally:
        tmpi.stop()


# ---------------------------------------------------------------------------
# describe rows
# ---------------------------------------------------------------------------


def test_plan_rows_carry_no_unported_layer(planned):
    tmpi.allreduce_rank_major(rank_major())
    (row,) = planner.describe()
    assert (row["obs"], row["faults"], row["guard"], row["watchdog"],
            row["analysis"]) == (False, False, False, False, "off")


def test_describe_rows_shape(planned):
    tmpi.allreduce_rank_major(rank_major())
    (row,) = planner.describe()
    for field in ("kind", "op", "backend", "backends", "nbytes", "launches",
                  "epoch", "build_ms", "hits", "staged", "obs", "faults",
                  "analysis", "topology"):
        assert field in row
    assert (row["kind"], row["op"], row["backend"], row["nbytes"],
            row["launches"], row["topology"]) == ("eager", "allreduce",
                                                  "xla", 128, 1, "1x8")
