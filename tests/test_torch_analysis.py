"""The trace-time collective analysis of the port (torchmpi_tpu_torch.analysis)
against the JAX package's (tests/test_analysis.py), case for case.

Every JAX case has one counterpart here, under its name with ``torch_``
before it, JAX's ``slow`` one kept ``slow``.  A counterpart program is
JAX's rewritten for the port: rank-major stacks of 8 ranks under a pushed
communicator of axis "i" (JAX's ``axis_env=[("i", 8)]``), the port's verbs
for JAX's primitives (``analysis.OP_MAP``: psum is allreduce; pmax has no
port verb, and the counterpart uses allgather over the same axis), an
``if`` / ``elif`` for a ``cond`` / ``switch``, a Python loop for a
``scan``.  Where a case holds findings, both checkers run on the two
programs and the sets of (rule, severity, mapped op, axes) must be equal
(:func:`_keys`).  JAX's own D1 case fails in the reference (ROADMAP queue
C note 3); there the port is held to the finding JAX's test asserts.  A
recording sees only the branch its process takes, so where JAX counts a
collective inside a branch, the counterpart's rank 0 takes it.

Beyond JAX's cases: the clean bill of ``data_parallel_step``.  The S1 /
S2 cases, the tool's, ``plan_tool``'s and the hook on the port's own
paths are in tests/test_torch_analysis_tool.py.  The runtime is a world
of one gloo process.
"""

import warnings

import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

import torchmpi_tpu as mpi
from torchmpi_tpu import analysis as janalysis
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import analysis, collectives, fusion, runtime
from torchmpi_tpu_torch.parallel import gradsync
from torchmpi_tpu_torch.parallel import zero as tzero

from _torch_world import module_group

torch.set_num_threads(2)

# JAX's programs and shapes.
AXIS_ENV = [("i", 8)]
VEC = jax.ShapeDtypeStruct((512,), jnp.float32)      # 2 KB
BIG = jax.ShapeDtypeStruct((32768,), jnp.float32)    # 128 KB >= cutover
# The port's: rank-major stacks of 8 ranks under the communicator "i".
COMM = {"i": 8}
TVEC = torch.zeros(8, 512)
TBIG = torch.zeros(8, 32768)
ar = tmpi.allreduce_rank_major
ag = tmpi.allgather_rank_major

_SLICE_OPS = ("dynamic_update_slice", "dynamic_slice", "scatter",
              "index_put", "index_copy", "slice_scatter", "select_scatter",
              "index", "index_select")


def _op(op: str) -> str:
    if op in _SLICE_OPS:
        return "slice"
    return analysis.OP_MAP.get(op) or op


def _keys(findings):
    """The comparable part of a finding list: (rule, severity, the op
    mapped to the port's verb, axes)."""
    return {(f.rule, f.severity, _op(f.op), tuple(f.axes))
            for f in findings}


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture(autouse=True)
def rt():
    tmpi.stop()
    tmpi.init(device="cpu")
    analysis.reset_captured()
    yield
    analysis.reset_captured()
    tmpi.stop()


# ---------------------------------------------------------------------------
# D1: collective under a rank-derived branch
# ---------------------------------------------------------------------------


def _port_d1(xs):
    r = runtime.rank()
    if r == 0:
        xs = ar(xs, axis_names="i")
    return xs


def test_torch_d1_fires_on_rank_divergent_cond():
    # JAX's case fails in the reference (note 3): the port is held to
    # what JAX's test asserts.
    found = analysis.check(_port_d1, TVEC, comm=COMM)
    assert "D1" in _rules(found)
    d1 = [f for f in found if f.rule == "D1"][0]
    assert d1.severity == analysis.ERROR
    assert _op("psum") == d1.op == "allreduce" and d1.axes == ("i",)
    assert "test_torch_analysis.py" in d1.source


def test_torch_d1_near_miss_data_dependent_cond():
    def jax_ok(x):
        return lax.cond(x.sum() > 0, lambda u: lax.psum(u, "i"),
                        lambda u: lax.psum(2.0 * u, "i"), x)

    def ok(xs):
        if xs.sum() > 0:
            return ar(xs, axis_names="i")
        return ar(2.0 * xs, axis_names="i")

    want = janalysis.check(jax_ok, VEC, axis_env=AXIS_ENV)
    got = analysis.check(ok, TVEC, comm=COMM)
    assert "D1" not in _rules(got)
    assert _keys(got) == _keys(want)


def test_torch_d1_taint_flows_through_arithmetic():
    def jax_bad(x):
        r = (lax.axis_index("i") * 3 + 1) % 2
        return lax.cond(r == 0, lambda u: lax.psum(u, "i"),
                        lambda u: u, x)

    def bad(xs):
        # Rank 0's (0 * 3 + 1) % 2 is 1: it takes the branch.
        r = (runtime.rank() * 3 + 1) % 2
        if r == 1:
            xs = ar(xs, axis_names="i")
        return xs

    got = analysis.check(bad, TVEC, comm=COMM)
    assert "D1" in _rules(got)
    assert _keys(got) == _keys(janalysis.check(jax_bad, VEC,
                                               axis_env=AXIS_ENV))


# ---------------------------------------------------------------------------
# D2: unbound axis name
# ---------------------------------------------------------------------------


def test_torch_d2_fires_via_trace_error():
    def bad(xs):
        return ar(xs, axis_names="ghost")

    found = analysis.check(bad, TVEC, comm=COMM)
    assert _rules(found) == ["D2"]
    assert found[0].severity == analysis.ERROR
    assert "test_torch_analysis.py" in found[0].source
    assert _keys(found) == _keys(janalysis.check(
        lambda x: lax.psum(x, "ghost"), VEC, axis_env=AXIS_ENV))


def test_torch_d2_structural_walk_flags_unbound_axes():
    # Record with both axes bound, then re-check the stream as if only
    # "i" were: the rule itself must flag the "j" collective.
    def jax_f(x):
        return lax.psum(x, "i") + lax.psum(x, "j")

    def f(xs):
        return ar(xs, axis_names="i") + ar(xs, axis_names="j")

    _, rec = analysis.record(f, TVEC, comm={"i": 4, "j": 2})
    found = analysis.check_events(rec.events, records=rec.records,
                                  bound_axes=["i"])
    d2 = [x for x in found if x.rule == "D2"]
    assert len(d2) == 1 and d2[0].axes == ("j",)
    closed, records = janalysis.trace_fn(jax_f, VEC,
                                         axis_env=[("i", 4), ("j", 2)])
    assert _keys(found) == _keys(janalysis.check_jaxpr(
        closed, records=records, bound_axes=["i"]))


def test_torch_d2_trace_error_respects_rules_subset():
    # With D2 excluded the raise stays loud, as JAX's trace failure does.
    def bad(xs):
        return ar(xs, axis_names="ghost")

    with pytest.raises(NameError):
        janalysis.check(lambda x: lax.psum(x, "ghost"), VEC,
                        axis_env=AXIS_ENV, rules=("P1",))
    with pytest.raises(collectives.UnboundAxisError):
        analysis.check(bad, TVEC, comm=COMM, rules=("P1",))


def test_torch_d2_near_miss_bound_axis():
    got = analysis.check(lambda xs: ar(xs, axis_names="i"), TVEC,
                         comm=COMM)
    assert "D2" not in _rules(got)
    assert _keys(got) == _keys(janalysis.check(
        lambda x: lax.psum(x, "i"), VEC, axis_env=AXIS_ENV))


# ---------------------------------------------------------------------------
# D3: mixed collective ordering across branches
# ---------------------------------------------------------------------------


def test_torch_d3_fires_on_mixed_branch_order():
    def jax_bad(x):
        def b0(u):
            return lax.psum(u, "i") + lax.pmax(u, "i")

        def b1(u):
            return lax.pmax(u, "i") + lax.psum(u, "i")

        return lax.cond(x.sum() > 0, b0, b1, x)

    def bad(xs):
        def b0(u):
            return ar(u, axis_names="i") + ag(u, axis_names="i")[:, 0]

        def b1(u):
            return ag(u, axis_names="i")[:, 0] + ar(u, axis_names="i")

        if xs.sum() > 0:
            out = b0(xs)
        else:
            out = b1(xs)
        return out

    found = analysis.check(bad, TVEC, comm=COMM, rules=("D3",))
    assert _rules(found) == ["D3"]
    assert found[0].severity == analysis.WARNING
    assert _keys(found) == _keys(janalysis.check(
        jax_bad, VEC, axis_env=AXIS_ENV, rules=("D3",)))


def test_torch_d3_catches_non_adjacent_branch_reorder():
    # An if / elif / else chain is one site: a one-collective middle
    # branch must not mask a b0-vs-b2 reordering.
    def jax_bad(x):
        def b0(u):
            return lax.psum(u, "i") + lax.pmax(u, "i")

        def b1(u):
            return lax.psum(u, "i")

        def b2(u):
            return lax.pmax(u, "i") + lax.psum(u, "i")

        return lax.switch(jnp.int32(x.sum()) % 3, [b0, b1, b2], x)

    def bad(xs):
        k = int(xs.sum()) % 3
        if k == 0:
            return ar(xs, axis_names="i") + ag(xs, axis_names="i")[:, 0]
        elif k == 1:
            return ar(xs, axis_names="i")
        else:
            return ag(xs, axis_names="i")[:, 0] + ar(xs, axis_names="i")

    found = analysis.check(bad, TVEC, comm=COMM, rules=("D3",))
    assert _rules(found) == ["D3"]
    assert _keys(found) == _keys(janalysis.check(
        jax_bad, VEC, axis_env=AXIS_ENV, rules=("D3",)))


def test_torch_d3_near_miss_same_order():
    def jax_ok(x):
        def branch(u):
            return lax.psum(u, "i") + lax.pmax(u, "i")

        return lax.cond(x.sum() > 0, branch,
                        lambda u: branch(2.0 * u), x)

    def ok(xs):
        def branch(u):
            return ar(u, axis_names="i") + ag(u, axis_names="i")[:, 0]

        if xs.sum() > 0:
            out = branch(xs)
        else:
            out = branch(2.0 * xs)
        return out

    assert janalysis.check(jax_ok, VEC, axis_env=AXIS_ENV,
                           rules=("D3",)) == []
    assert analysis.check(ok, TVEC, comm=COMM, rules=("D3",)) == []


# ---------------------------------------------------------------------------
# P1: per-leaf launches that bypassed fusion
# ---------------------------------------------------------------------------


def _per_leaf(xss):
    return [ar(xs, axis_names="i") for xs in xss]


def test_torch_p1_fires_on_many_small_launches():
    k = analysis.P1_MIN_COUNT
    found = analysis.check(_per_leaf, [TVEC] * k, comm=COMM, rules=("P1",))
    assert _rules(found) == ["P1"]
    assert found[0].severity == analysis.WARNING
    assert _keys(found) == _keys(janalysis.check(
        lambda xs: [lax.psum(x, "i") for x in xs], [VEC] * k,
        axis_env=AXIS_ENV, rules=("P1",)))


def test_torch_p1_near_miss_below_count():
    k = analysis.P1_MIN_COUNT - 1
    assert janalysis.check(lambda xs: [lax.psum(x, "i") for x in xs],
                           [VEC] * k, axis_env=AXIS_ENV,
                           rules=("P1",)) == []
    assert analysis.check(_per_leaf, [TVEC] * k, comm=COMM,
                          rules=("P1",)) == []


def test_torch_p1_near_miss_fused_path(flat_runtime):
    # The fused in-axis allreduce of a many-leaf tree issues bucket
    # launches, not one per leaf: P1 stays quiet on both sides.
    mesh = flat_runtime
    jtree = {f"w{k}": jnp.ones((256,)) for k in range(16)}

    def jstep(t):
        body = lambda tt: mpi.collectives.allreduce_in_axis(  # noqa: E731
            tt, ("dcn", "ici"))
        return shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(t)

    tree = {f"w{k}": torch.ones(256) for k in range(16)}
    assert janalysis.check(jstep, jtree, rules=("P1",)) == []
    assert analysis.check(
        lambda t: collectives.allreduce_in_axis(t, ("dcn", "ici")), tree,
        rules=("P1",)) == []
    _, rec = analysis.record(
        lambda t: collectives.allreduce_in_axis(t, ("dcn", "ici")), tree)
    assert rec.events and all(e.fused for e in rec.events)


# ---------------------------------------------------------------------------
# P2: payload below the cutover / plan bucket floor
# ---------------------------------------------------------------------------


def test_torch_p2_fires_below_cutover():
    found = analysis.check(lambda xs: ar(xs, axis_names="i"), TVEC,
                           comm=COMM, rules=("P2",))
    assert _rules(found) == ["P2"]
    assert found[0].severity == analysis.INFO
    assert found[0].nbytes == 2048
    want = janalysis.check(lambda x: lax.psum(x, "i"), VEC,
                           axis_env=AXIS_ENV, rules=("P2",))
    assert _keys(found) == _keys(want) and want[0].nbytes == 2048


def test_torch_p2_near_miss_above_cutover_and_scalar():
    def f(xs):
        return ar(xs, axis_names="i")

    assert janalysis.check(lambda x: lax.psum(x, "i"), BIG,
                           axis_env=AXIS_ENV, rules=("P2",)) == []
    assert analysis.check(f, TBIG, comm=COMM, rules=("P2",)) == []
    # Scalar-ish payloads (loss reductions) are exempt by design.
    assert analysis.check(f, torch.zeros(8, 2), comm=COMM,
                          rules=("P2",)) == []


# ---------------------------------------------------------------------------
# C1: fused / ZeRO layout invariants
# ---------------------------------------------------------------------------


def _jax_zero_rs_step(mesh, spec):
    from torchmpi_tpu.parallel import zero

    def inner(p):
        g = jax.tree.map(jnp.ones_like, p)
        g_shard, _, _ = zero._reduce_scatter_grads(
            g, ("dcn", "ici"), spec=spec, params=None, op="sum",
            backend=None, compress=None)
        return g_shard

    def step(p):
        return shard_map(inner, mesh=mesh, in_specs=P(),
                         out_specs=P(("dcn", "ici")), check_vma=False)(p)

    return step


def _port_params():
    return [torch.ones(16, 4), torch.ones(16)]


def _port_zero_step(spec):
    """ZeRO's gradient leg of 8 ranks over ``spec`` (a ZeRO-3 update of
    the [8, shard] stack), the counterpart of JAX's in-step
    reduce-scatter."""
    good = tzero.flat_spec(_port_params(), n_shards=8)
    tx = tmpi.optim.sgd(0.1)

    def step(p_shards):
        flats, _ = fusion.rank_major_buffers(good, 8, device="cpu")
        for f in flats:
            f.fill_(1.0)
        return tzero.update3_rank_major(p_shards, flats, tx.init(p_shards),
                                        tx, spec=spec)

    return step


def test_torch_c1_fires_on_stale_zero_spec(flat_runtime):
    # A spec built for 4 ranks (a smaller communicator, or a stale
    # checkpointed layout) over 8: refused at the leg, before the
    # reduce-scatter launches.
    jparams = {"w": jnp.ones((16, 4)), "b": jnp.ones((16,))}
    want = janalysis.check(_jax_zero_rs_step(
        flat_runtime, mpi.fusion.FusedSpec(jparams, 4)), jparams,
        rules=("C1",))
    stale = fusion.FusedSpec(_port_params(), 4, max_bytes=0)
    found = analysis.check(_port_zero_step(stale),
                           torch.zeros(8, stale.shard), rules=("C1",))
    assert _rules(found) == ["C1"]
    assert found[0].severity == analysis.ERROR
    assert "8 devices" in found[0].message
    assert _keys(found) == _keys(want)


def test_torch_c1_near_miss_correct_zero_spec(flat_runtime):
    from torchmpi_tpu.parallel import zero

    jparams = {"w": jnp.ones((16, 4)), "b": jnp.ones((16,))}
    good = zero.flat_spec(jparams, ("dcn", "ici"), mesh=flat_runtime)
    assert janalysis.check(_jax_zero_rs_step(flat_runtime, good), jparams,
                           rules=("C1",)) == []
    spec = tzero.flat_spec(_port_params(), n_shards=8)
    assert analysis.check(_port_zero_step(spec), torch.zeros(8, spec.shard),
                          rules=("C1",)) == []


def test_torch_c1_fires_on_broken_barrier_chain():
    # Unit-level: a fuse_tree record whose bucket chain misses a
    # transition is an error, in both packages' rules.
    from torchmpi_tpu.analysis.rules import RuleContext as JCtx
    from torchmpi_tpu.analysis.rules import run_rules as jrun

    rec = dict(kind="fuse_tree", op="allreduce", axes=("ici",),
               source="x.py:1", spec_leaves=4, tree_leaves=4,
               spec_dtypes=["float32"] * 4, tree_dtypes=["float32"] * 4,
               spec_sizes=[8, 8, 8, 8], tree_sizes=[8, 8, 8, 8],
               n_launches=3, barrier=True, barrier_links=1)
    ctx = analysis.RuleContext(events=[], records=[rec],
                               config=tmpi.Config())
    found = analysis.run_rules(ctx, rules=("C1",))
    assert _rules(found) == ["C1"]
    assert _keys(found) == _keys(jrun(JCtx(events=[], records=[rec],
                                           config=mpi.Config()),
                                      rules=("C1",)))
    rec["barrier_links"] = 2  # complete chain: near-miss
    assert analysis.run_rules(ctx, rules=("C1",)) == []


def test_torch_c1_gradsync_barrier_chain_is_complete(flat_runtime):
    # The real bucketed, chained gradient sync satisfies its own
    # invariant (the chain spans every dtype group's buckets).
    mesh = flat_runtime
    grads = {"a": jnp.ones((4096,), jnp.float32),
             "b": jnp.ones((4096,), jnp.bfloat16),
             "c": jnp.ones((512,), jnp.float32)}

    def jstep(g):
        def inner(gt):
            return mpi.nn.synchronize_gradients(
                gt, ("dcn", "ici"), n_buckets=3, barrier=True)

        return shard_map(inner, mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(g)

    assert janalysis.check(jstep, grads, rules=("C1",)) == []
    stacks = [torch.ones(8, 4096), torch.ones(8, 4096, dtype=torch.bfloat16),
              torch.ones(8, 512)]
    tmpi.set_config(gradsync_barrier=True)
    _, rec = analysis.record(
        lambda s: gradsync.synchronize_gradients_rank_major(
            s, n_buckets=3, barrier=True), stacks)
    (fr,) = [r for r in rec.records if r["kind"] == "fuse_tree"]
    assert fr["barrier"] and fr["n_launches"] > 1
    assert analysis.check(
        lambda s: gradsync.synchronize_gradients_rank_major(
            s, n_buckets=3, barrier=True), stacks, rules=("C1",)) == []


# ---------------------------------------------------------------------------
# C2: dcn compression / layout consistency (the two-level grid, dcn 2)
# ---------------------------------------------------------------------------


def _jax_hier_step(mesh, op):
    from torchmpi_tpu.parallel import hierarchical as H

    def step(x):
        return shard_map(lambda v: H.hier_allreduce(v, ("dcn", "ici"),
                                                    op=op),
                         mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(x)

    return step


def _port_hier(op):
    return lambda xs: tmpi.allreduce_rank_major(xs, op=op,
                                                backend="hierarchical")


def _codec(min_bytes):
    mpi.set_config(dcn_compress="int8", dcn_compress_min_bytes=min_bytes)
    tmpi.set_config(dcn_size=2, dcn_compress="int8",
                    dcn_compress_min_bytes=min_bytes)


def test_torch_c2_fires_on_non_sum_compressed_op(hier_runtime):
    _codec(0)
    try:
        want = janalysis.check(_jax_hier_step(hier_runtime, "max"),
                               jnp.ones((4096,), jnp.float32),
                               rules=("C2",))
        found = analysis.check(_port_hier("max"), torch.ones(8, 4096),
                               rules=("C2",))
        assert _rules(found) == ["C2"]
        assert found[0].severity == analysis.ERROR
        assert "non-sum" in found[0].message
        assert _keys(found) == _keys(want)
    finally:
        mpi.set_config(dcn_compress="off")


def test_torch_c2_info_on_below_floor_payload(hier_runtime):
    _codec(1 << 20)
    try:
        want = janalysis.check(_jax_hier_step(hier_runtime, "sum"),
                               jnp.ones((4096,), jnp.float32),
                               rules=("C2",))
        found = analysis.check(_port_hier("sum"), torch.ones(8, 4096),
                               rules=("C2",))
        assert _rules(found) == ["C2"]
        assert found[0].severity == analysis.INFO
        assert "dcn_compress_min_bytes" in found[0].message
        assert _keys(found) == _keys(want)
    finally:
        mpi.set_config(dcn_compress="off")


def _jax_ef_step(mesh, res_spec):
    def step(g, rs):
        def inner(gt, rl):
            return mpi.nn.synchronize_gradients(gt, ("dcn", "ici"),
                                                residuals=rl)

        return shard_map(inner, mesh=mesh, in_specs=(P(), res_spec),
                         out_specs=(P(), res_spec), check_vma=False)(g, rs)

    return step


def _port_ef(stacks, residuals):
    return gradsync.synchronize_gradients_rank_major(stacks,
                                                     residuals=residuals)


def test_torch_c2_info_on_below_floor_ef_leg(hier_runtime):
    # The error-feedback legs honour the same floor as the plain
    # two-level leg and leave the same C2 info.
    _codec(1 << 20)
    try:
        from torchmpi_tpu.parallel import gradsync as jgs

        grads = {"w": jnp.ones((64, 32), jnp.float32)}
        res = jgs.init_dcn_residuals(grads, ("dcn", "ici"))
        want = janalysis.check(_jax_ef_step(hier_runtime, P(("dcn", "ici"))),
                               grads, res, rules=("C2",))
        stacks = [torch.ones(8, 64, 32)]
        tres = gradsync.init_dcn_residuals([torch.ones(64, 32)], n=8,
                                           device="cpu")
        found = analysis.check(_port_ef, stacks, tres, rules=("C2",))
        assert _rules(found) == ["C2"]
        assert found[0].severity == analysis.INFO
        assert "dcn_compress_min_bytes" in found[0].message
        assert _keys(found) == _keys(want)
    finally:
        mpi.set_config(dcn_compress="off")


def test_torch_c2_near_miss_clean_compressed_leg(hier_runtime):
    _codec(0)
    try:
        assert janalysis.check(_jax_hier_step(hier_runtime, "sum"),
                               jnp.ones((4096,), jnp.float32),
                               rules=("C2",)) == []
        assert analysis.check(_port_hier("sum"), torch.ones(8, 4096),
                              rules=("C2",)) == []
        _, rec = analysis.record(_port_hier("sum"), torch.ones(8, 4096))
        assert [r["codec"] for r in rec.records
                if r["kind"] == "dcn_compress"] == ["int8"]
    finally:
        mpi.set_config(dcn_compress="off")


def test_torch_c2_fires_on_residual_structure_mismatch(hier_runtime):
    # The EF sync raises on a wrong residual layout; the analysis still
    # gives the C2 finding (the record comes before the raise), and
    # refuses before any dcn leg launches.
    _codec(0)
    try:
        grads = {"w": jnp.ones((64, 32), jnp.float32)}
        bad_res = [jnp.zeros((8, 4), jnp.float32)] * 2
        want = janalysis.check(_jax_ef_step(hier_runtime, P()), grads,
                               bad_res, rules=("C2",))
        found = analysis.check(_port_ef, [torch.ones(8, 64, 32)],
                               [torch.zeros(8, 4)] * 2, rules=("C2",))
        assert _rules(found) == ["C2"]
        assert found[0].severity == analysis.ERROR
        assert "residual" in found[0].message
        assert _keys(found) == _keys(want)
    finally:
        mpi.set_config(dcn_compress="off")


def test_torch_c2_near_miss_correct_residual_state(hier_runtime):
    from torchmpi_tpu.parallel import gradsync as jgs

    _codec(0)
    try:
        grads = {"w": jnp.ones((64, 32), jnp.float32)}
        res = jgs.init_dcn_residuals(grads, ("dcn", "ici"))
        assert janalysis.check(_jax_ef_step(hier_runtime,
                                            P(("dcn", "ici"))),
                               grads, res, rules=("C2",)) == []
        tres = gradsync.init_dcn_residuals([torch.ones(64, 32)], n=8,
                                           device="cpu")
        assert analysis.check(_port_ef, [torch.ones(8, 64, 32)], tres,
                              rules=("C2",)) == []
    finally:
        mpi.set_config(dcn_compress="off")


# ---------------------------------------------------------------------------
# Reach: nested calls, loops, branches (JAX: pjit / shard_map / scan / cond)
# ---------------------------------------------------------------------------


def test_torch_walk_recurses_through_pjit_shard_map_scan_cond(flat_runtime):
    mesh = flat_runtime

    def jinner(v):
        r = lax.axis_index("ici")

        def body(carry, x):
            y = lax.cond(r == 0, lambda u: lax.psum(u, "ici"),
                         lambda u: u, x)
            return carry + y.sum(), y

        s, _ = lax.scan(body, 0.0, v.reshape(4, -1))
        return s

    def jstep(x):
        return jax.jit(shard_map(jinner, mesh=mesh, in_specs=P(),
                                 out_specs=P(), check_vma=False))(x)

    def step(xs):
        return inner(xs)

    def inner(xs):
        r = collectives.axis_index("ici")

        def body(chunk):
            if r == 0:
                chunk = ar(chunk, axis_names="ici")
            return chunk.sum()

        return sum(body(c) for c in xs.chunk(4, dim=1))

    want = janalysis.check(jstep, jnp.ones((64,)), rules=("D1",))
    found = analysis.check(step, torch.ones(8, 64), rules=("D1",),
                           sources=[step, inner])
    assert _rules(found) == ["D1"]
    assert "(body)" in found[0].source
    assert _keys(found) == _keys(want)


def test_torch_events_capture_nbytes_dtype_axes():
    closed, _ = janalysis.trace_fn(
        lambda x: lax.psum(x, "i"),
        jax.ShapeDtypeStruct((64,), jnp.bfloat16), axis_env=AXIS_ENV)
    (jev,) = janalysis.trace_events(closed, bound_axes=["i"])
    _, rec = analysis.record(lambda xs: ar(xs, axis_names="i"),
                             torch.zeros(8, 64, dtype=torch.bfloat16),
                             comm=COMM)
    (ev,) = rec.events
    assert (ev.primitive, ev.axes, ev.nbytes, ev.dtype) == \
        (_op(jev.primitive), jev.axes, jev.nbytes, jev.dtype) == \
        ("allreduce", ("i",), 128, "bfloat16")


# ---------------------------------------------------------------------------
# assert_clean + runtime hook
# ---------------------------------------------------------------------------


def test_torch_assert_clean_raises_with_findings_listed():
    with pytest.raises(AssertionError, match="D1"):
        analysis.assert_clean(_port_d1, TVEC, comm=COMM)


def test_torch_assert_clean_passes_and_returns_quiet_findings():
    found = analysis.assert_clean(lambda xs: ar(xs, axis_names="i"), TVEC,
                                  comm=COMM)
    assert _rules(found) == ["P2"]  # info comes back, not raised
    assert _keys(found) == _keys(janalysis.assert_clean(
        lambda x: lax.psum(x, "i"), VEC, axis_env=AXIS_ENV))


def test_torch_check_once_error_mode_raises():
    ran = []

    def bad(xs):
        ran.append(1)
        return _port_d1(xs)

    with pytest.raises(analysis.AnalysisError, match="D1"):
        analysis.check_once("unit", bad, TVEC, mode="error", comm=COMM,
                            sources=[bad, _port_d1])
    assert any(f.rule == "D1" for f in analysis.captured_findings())
    assert ran == []  # refused before the call


def test_torch_config_rejects_unknown_analysis_mode():
    tmpi.stop()
    with pytest.raises(ValueError, match="analysis"):
        tmpi.init(tmpi.Config(analysis="loud"), device="cpu")
    tmpi.init(device="cpu")
    with pytest.raises(ValueError, match="analysis"):
        tmpi.set_config(analysis="loud")


def test_torch_analysis_mode_normalization(monkeypatch):
    # Boolean-ish and case-variant spellings normalize identically for
    # the env and an explicit Config value.
    tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_ANALYSIS", "1")
    tmpi.init(tmpi.Config(), device="cpu")
    assert tmpi.config().analysis == "warn"
    tmpi.stop()
    monkeypatch.delenv("TORCHMPI_TPU_ANALYSIS")
    tmpi.init(tmpi.Config(analysis="WARN"), device="cpu")
    assert tmpi.config().analysis == "warn"
    tmpi.set_config(analysis="off")


def test_torch_error_mode_rechecks_on_retry():
    # A retried call with the same shapes must re-raise, never run the
    # flagged program (the signature is cached only on a passing check).
    ran = []

    def bad(xs):
        ran.append(1)
        if runtime.rank() == 0:
            xs = ar(xs)
        return xs

    wrapped = analysis.wrap_step(bad, label="retry", mode="error")
    for _ in range(2):
        with pytest.raises(analysis.AnalysisError):
            wrapped(torch.ones(8, 8))
    assert ran == []


class _Five(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ws = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.ones(256)) for _ in range(5)])


def test_torch_runtime_hook_checks_once_per_signature():
    tmpi.stop()
    tmpi.init(tmpi.Config(analysis="warn"), device="cpu")
    model = _Five()

    def loss_fn(m, xb):
        # Five separate sub-cutover allreduces: a P1 warning the hook
        # must surface (warn mode) without failing the run.
        outs = [collectives.allreduce_in_axis(p.detach())
                for p in m.ws]
        return sum((p * o).sum() for p, o in zip(m.ws, outs)) + xb.sum()

    dp = gradsync.data_parallel_step(model, torch.optim.SGD(
        model.parameters(), lr=0.1), loss_fn)
    xb = torch.ones(8, 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        dp(xb)
        n1 = len([x for x in w if "analysis" in str(x.message)])
        dp(xb)  # same signature: no re-check
        n2 = len([x for x in w if "analysis" in str(x.message)])
    assert n1 == 1 and n2 == 1
    assert any(f.rule == "P1" for f in analysis.captured_findings())


# ---------------------------------------------------------------------------
# Clean bill: the library's own recipes
# ---------------------------------------------------------------------------


def _tiny_bn_model():
    import flax.linen as fnn

    class TinyBN(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            x = x.reshape((x.shape[0], -1))
            x = fnn.Dense(32)(x)
            x = fnn.BatchNorm(use_running_average=not train,
                              momentum=0.9)(x)
            return fnn.Dense(10)(x)

    return TinyBN()


def _port_bn_model():
    from torchmpi_tpu_torch.models import ResNet20

    return ResNet20(device="cpu")


def _port_batch():
    g = torch.Generator().manual_seed(0)
    return (torch.rand(8, 3, 32, 32, generator=g),
            torch.randint(0, 10, (8,), generator=g))


def test_torch_recipes_replicated_step_clean_bill(flat_runtime):
    from torchmpi_tpu import recipes as jrecipes

    model = _tiny_bn_model()
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8, 8, 1)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.sgd(0.1)
    dp = jrecipes.make_bn_dp_train_step(model, tx, mesh=flat_runtime,
                                        donate=False)
    want = janalysis.assert_clean(dp.jitted, params, tx.init(params), stats,
                                  jnp.zeros((8, 8, 8, 1)),
                                  jnp.zeros((8,), jnp.int32))
    pm = _port_bn_model()
    ptx = tmpi.optim.sgd(0.1)
    step = tmpi.recipes.make_bn_dp_train_step_rank_major(pm, ptx, 2)
    pp, ps = tmpi.recipes.bn_state(pm)
    found = analysis.assert_clean(step, pp, [ptx.init(p) for p in pp], ps,
                                  *_port_batch(), label="bn_dp_replicated")
    assert not analysis.has_errors(found) and not analysis.has_errors(want)
    assert {f.rule for f in found} <= {"P2"}


def test_torch_recipes_zero1_step_clean_bill(flat_runtime):
    from torchmpi_tpu import recipes as jrecipes
    from torchmpi_tpu.parallel import zero

    model = _tiny_bn_model()
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8, 8, 1)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.sgd(0.1)
    zp = jrecipes.make_bn_dp_train_step(model, tx, mesh=flat_runtime,
                                        donate=False, zero=1)
    want = janalysis.assert_clean(zp.jitted, params,
                                  zero.init(params, tx, mesh=flat_runtime),
                                  stats, jnp.zeros((8, 8, 8, 1)),
                                  jnp.zeros((8,), jnp.int32))
    pm = _port_bn_model()
    ptx = tmpi.optim.sgd(0.1)
    step = tmpi.recipes.make_bn_dp_train_step_rank_major(pm, ptx, 2, zero=1)
    pp, ps = tmpi.recipes.bn_state(pm)
    found = analysis.assert_clean(step, pp, tzero.init_rank_major(pp, ptx, 2),
                                  ps, *_port_batch(), label="bn_dp_zero1")
    assert not analysis.has_errors(found) and not analysis.has_errors(want)
    assert {f.rule for f in found} <= {"P2"}


def test_torch_data_parallel_step_clean_bill():
    """``data_parallel_step`` and its rank-major form under the hook:
    nothing to report on a plain model."""
    model = torch.nn.Linear(64, 64)

    def loss_fn(m, xb):
        return m(xb).square().mean()

    tmpi.set_config(analysis="error")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    xb = torch.ones(8, 64)
    gradsync.data_parallel_step(model, opt, loss_fn)(xb)
    gradsync.data_parallel_step_rank_major(model, opt, loss_fn, 4)(xb)
    assert not [f for f in analysis.captured_findings()
                if f.severity != "info"]
