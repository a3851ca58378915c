"""The port's telemetry hooks against the JAX package's.

The same call sequence runs through the JAX package on the forced
8-device CPU mesh (``Config(dcn_size=1, obs=...)``) and through the port
on rank-major stacks of 8 in a world of one gloo process; the registry
snapshots (names, labels and values) and the flight events (``ev`` /
``op`` / ``nbytes`` / ``backend``) must agree.  Time-valued histograms
(plan build seconds, async wait seconds, tuning medians) agree in name,
labels and count only.  Spec: JAX ``tests/test_obs.py`` :292, :329,
:342, :370, :409, :433, :445, :462, :487 and :533.

Where the two differ by design, the comparison says so: JAX counts its
in-axis, fusion, gradsync and ZeRO hooks when a jitted program is traced,
the port on every call (ROADMAP queue C note 31), so the parity cases run
ONE step, and a second check holds the port's counts after N steps to N
times one step's.  The JAX data-parallel step syncs inside the program,
through ``allreduce_in_axis``; the port's rank-major step syncs the fused
stacks directly, so it has no in-axis call to count.
"""

import importlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from _torch_world import module_group
from torchmpi_tpu_torch import obs as tobs
from torchmpi_tpu_torch.obs import tool
from torchmpi_tpu_torch.parallel import gradsync

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Histograms of times: their buckets and sums are the host's clock.
TIMED = ("tm_plan_build_seconds", "tm_async_wait_seconds",
         "tm_tuning_measured_us")


@pytest.fixture(scope="module", autouse=True)
def _group():
    with module_group():
        yield


@pytest.fixture()
def both(tmp_path):
    """Both runtimes up with obs "trace", each dumping into its own
    directory; both registries and rings reset."""
    from torchmpi_tpu import obs as jobs

    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, obs="trace",
                          obs_dir=str(tmp_path / "jax")))
    tmpi.init(tmpi.Config(dcn_size=1, obs="trace",
                          obs_dir=str(tmp_path / "port")), device="cpu")
    jobs.reset()
    tobs.reset()
    yield jobs, tobs, tmp_path
    for o in (jobs, tobs):
        o.deactivate()
        o.reset()
    tmpi.stop()
    jmpi.stop()


def _norm(snap, names=None):
    """A snapshot as {(name, labels): value}; timed histograms by count."""
    out = {}
    for r in snap:
        if names is not None and r["name"] not in names:
            continue
        key = (r["name"], tuple(sorted(r["labels"].items())))
        if r["kind"] == "counter":
            out[key] = r["value"]
        elif r["name"] in TIMED:
            out[key] = ("count", r["count"])
        else:
            out[key] = (r["buckets"], r["count"], r["sum"])
    return out


def _events(o, evs=None):
    """The flight ring as (ev, op, nbytes, backend), optionally only the
    event types ``evs``."""
    return [(e[2], e[3], e[4], e[5]) for e in o.recorder().events()
            if evs is None or e[2] in evs]


def _x(shape=(8, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Eager collectives, the dump, set_config
# ---------------------------------------------------------------------------


def test_eager_collective_records_and_dump(both, capsys):
    jobs, tobs_, tmp_path = both
    x = _x()
    jmpi.allreduce(x)
    jmpi.allreduce(x, backend="host")
    jmpi.barrier()
    xt = torch.from_numpy(x)
    tmpi.allreduce_rank_major(xt)
    tmpi.allreduce_rank_major(xt, backend="host")
    tmpi.barrier()
    reg = tobs_.registry()
    assert reg.counter("tm_collectives_total", op="allreduce",
                       backend="host", mesh="dcn:1,ici:8",
                       dtype="float32", nbytes_bucket="b4") == 1
    assert _norm(reg.snapshot()) == _norm(jobs.registry().snapshot())
    assert _events(tobs_) == _events(jobs)
    assert [e[0] for e in _events(tobs_)] == [
        "plan", "eager", "eager_done", "plan", "eager", "eager_done",
        "barrier", "barrier_done"]
    # Trace mode: each dispatch names its user call site (this file).
    eager = [e for e in tobs_.recorder().events() if e[2] == "eager"]
    assert all("test_torch_obs_hooks.py:" in e[6] for e in eager)
    paths = tobs_.dump()
    assert len(paths) == 2
    assert tool.main(["dump"] + paths) == 0
    capsys.readouterr()
    meta, records = tool.load_jsonl(paths[1])
    assert meta["stream"] == "flight"
    assert [r["seq"] for r in records] == list(range(8))


def test_process_world_verbs_record_eager_edges(both):
    """The port's process-world verbs (the JAX package's eager verbs
    across processes) record the same edges, labelled by the process
    world's grid; in-axis calls record ``tm_inaxis_calls_total``
    instead."""
    _, tobs_, _ = both
    x = torch.ones(4, 3)
    tmpi.allreduce(x)
    tmpi.broadcast(x, root=0)
    tmpi.allreduce_in_axis(x)
    reg = tobs_.registry()
    assert reg.counter("tm_collectives_total", op="allreduce",
                       backend="xla", mesh="dcn:1,ici:1", dtype="float32",
                       nbytes_bucket="b5") == 1
    assert reg.counter_total("tm_collectives_total") == 2
    assert reg.counter("tm_inaxis_calls_total", op="allreduce",
                       axes="dcn,ici", nbytes_bucket="b5") == 1
    assert [e[0] for e in _events(tobs_, ("eager", "eager_done"))] == [
        "eager", "eager_done", "eager", "eager_done"]


def test_set_config_obs_off_stops_recording(both):
    jobs, tobs_, _ = both
    for mpi, mk, o in ((jmpi, np.ones, jobs),
                       (tmpi, torch.ones, tobs_)):
        ar = (mpi.allreduce if mpi is jmpi
              else tmpi.allreduce_rank_major)
        ar(mk((8, 2), dtype=np.float32 if mk is np.ones
              else torch.float32))
        assert o.registry().counter_total("tm_collectives_total") == 1
        mpi.set_config(obs="off")
        assert not o.active()
        ar(mk((8, 4), dtype=np.float32 if mk is np.ones
              else torch.float32))
        assert o.registry().counter_total("tm_collectives_total") == 1
        mpi.set_config(obs="trace")
        ar(mk((8, 8), dtype=np.float32 if mk is np.ones
              else torch.float32))
        assert o.registry().counter_total("tm_collectives_total") == 2
    assert _norm(tobs_.registry().snapshot()) == \
        _norm(jobs.registry().snapshot())


def test_obs_config_normalizes_and_validates(both):
    _, tobs_, _ = both
    tmpi.set_config(obs="1")
    assert tmpi.runtime.config().obs == "metrics" and tobs_.active()
    with pytest.raises(ValueError, match="metrics|trace"):
        tmpi.set_config(obs="loud")
    tmpi.set_config(obs_ring_size=16)
    assert tobs_.recorder().size == 16
    tmpi.stop()
    with pytest.raises(ValueError, match="off|metrics|trace"):
        tmpi.init(tmpi.Config(obs="sometimes"), device="cpu")
    # A re-init that opts out turns the previous session's layer off.
    tmpi.init(tmpi.Config(obs="off"), device="cpu")
    assert not tobs_.active()


# ---------------------------------------------------------------------------
# In-axis, fusion, gradsync, ZeRO, the step builder
# ---------------------------------------------------------------------------


def test_in_axis_fusion_gradsync_records(both):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jobs, tobs_, _ = both
    mesh = jmpi.runtime.current_mesh()
    axes = tuple(mesh.axis_names)
    tree = {"a": np.ones((8, 4), np.float32), "b": np.ones((8, 2),
                                                         np.float32)}

    def body(t):
        t = jmpi.collectives.allreduce_in_axis(t, axes)
        return jmpi.nn.synchronize_gradients(t, axes, op="sum")

    jax.jit(shard_map(body, mesh=mesh, in_specs=(P(axes),),
                      out_specs=P(axes), check_vma=False))(tree)
    # The port in its world of one process: the same per-rank tree.
    t = {"a": torch.ones(1, 4), "b": torch.ones(1, 2)}
    t = tmpi.allreduce_in_axis(t, axes)
    gradsync.synchronize_gradient_tensors([t["a"], t["b"]], op="sum")
    names = ("tm_fusion_trees_total", "tm_fusion_leaves_total",
             "tm_fusion_buckets_total", "tm_fusion_wire_bytes_total",
             "tm_fusion_bytes_saved_total", "tm_gradsync_rounds_total",
             "tm_gradsync_buckets_total", "tm_step_builds_total")
    assert _norm(tobs_.registry().snapshot(), names) == \
        _norm(jobs.registry().snapshot(), names)
    reg = tobs_.registry()
    assert reg.counter("tm_inaxis_calls_total", op="allreduce",
                       axes=",".join(axes), nbytes_bucket="b4") == 1
    assert reg.counter_total("tm_fusion_trees_total") == 2
    assert reg.counter_total("tm_gradsync_rounds_total") == 1


def _lin():
    g = torch.Generator().manual_seed(0)
    m = torch.nn.Linear(5, 3, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.randn(3, 5, generator=g))
    return m


def test_zero_and_step_builder_records(both):
    import jax
    import jax.numpy as jnp
    import optax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jobs, tobs_, _ = both
    mesh = jmpi.runtime.current_mesh()
    axes = tuple(mesh.axis_names)
    jzero = jmpi.parallel.zero
    params = {"w": jnp.ones((5, 3), jnp.float32)}
    tx = optax.sgd(0.1)
    opt_state = jzero.init(params, tx, mesh=mesh)
    params_r = jmpi.nn.synchronize_parameters(params, mesh=mesh)

    def step(p, s):
        g = jax.tree.map(jnp.ones_like, p)
        return jzero.update(p, g, s, tx, axes, op="mean")

    sspecs = jzero.specs_like(opt_state, axes)
    jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), sspecs),
                      out_specs=(P(), sspecs), check_vma=False))(
        params_r, opt_state)

    def dp_body(p, batch):
        return jmpi.nn.synchronize_gradients(
            jax.tree.map(jnp.ones_like, p), axes)

    dp = jmpi.nn.data_parallel_step(dp_body, mesh=mesh, batch_argnums=(1,),
                                    donate_argnums=())
    dp(params_r, np.ones((8, 2), np.float32))

    # The port: one ZeRO-1 update of 8 rank-major ranks, and one step of
    # the rank-major data-parallel builder.
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.parallel import zero as tzero

    p = [torch.ones(5, 3)]
    ttx = optim.sgd(0.1)
    state = tzero.init_rank_major(p, ttx, 8)
    spec = tzero.flat_spec(p, n_shards=8)
    flats = [torch.ones(8, g.padded) for g in spec.groups]
    tzero.update_rank_major(p, flats, state, ttx, op="mean")
    model = _lin()
    tstep = gradsync.data_parallel_step_rank_major(
        model, torch.optim.SGD(model.parameters(), lr=0.1),
        lambda m, x, y: ((m(x) - y) ** 2).mean(), 8)
    tstep(torch.ones(16, 5), torch.zeros(16, 3))
    names = ("tm_zero_sync_rounds_total", "tm_zero_groups_total",
             "tm_step_builds_total")
    assert _norm(tobs_.registry().snapshot(), names) == \
        _norm(jobs.registry().snapshot(), names)
    reg = tobs_.registry()
    assert reg.counter("tm_step_builds_total",
                       label="data_parallel_step") == 1
    assert _events(tobs_, ("step",)) == _events(jobs, ("step",))


def test_port_counts_every_step(both):
    """ROADMAP queue C note 31: the port counts its step's hooks on every
    call, so N steps count N times one step's (JAX counts the trace)."""
    _, tobs_, _ = both
    model = _lin()
    step = gradsync.data_parallel_step_rank_major(
        model, torch.optim.SGD(model.parameters(), lr=0.1),
        lambda m, x, y: ((m(x) - y) ** 2).mean(), 4, backend="pallas")
    x, y = torch.ones(8, 5), torch.zeros(8, 3)
    step(x, y)
    one = _norm(tobs_.registry().snapshot())
    for _ in range(2):
        step(x, y)
    three = _norm(tobs_.registry().snapshot())
    builds = ("tm_step_builds_total", (("label", "data_parallel_step"),))
    plans = [k for k in one if k[0] in ("tm_plan_miss_total",
                                        "tm_plan_build_seconds")]
    for key, v in one.items():
        if key == builds or key in plans:
            assert three[key] == v, key  # built once, planned once
        elif key[0] == "tm_plan_hit_total":
            continue
        elif isinstance(v, tuple):
            assert three[key][1] == 3 * v[1], key
        else:
            assert three[key] == 3 * v, key
    assert three[("tm_gradsync_rounds_total",
                  (("compressed", "none"), ("op", "mean")))] == 3
    steps = _events(tobs_, ("step",))
    assert [e[2] for e in steps] == [0, 1, 2]


def test_overlap_schedule_events_order(both):
    """The overlapped sync's flight events: bucket k's launch before
    bucket k + 1's grads (JAX's overlap invariant)."""
    _, tobs_, _ = both
    params = [torch.randn(64, 64), torch.randn(64), torch.randn(32, 64)]
    vag = gradsync.make_overlapped_grad_fn_rank_major(
        lambda leaves, x: sum((w.sum() * x.sum()) for w in leaves),
        params, 4, max_bytes=16 << 10)
    vag(params, torch.ones(8, 3))
    evs = [(e[3], e[4]) for e in tobs_.recorder().events()
           if e[2] == "overlap"]
    total = len(evs) // 2
    assert total >= 2
    assert evs == [(s, k) for k in range(total)
                   for s in ("grads", "launch")]
    assert tobs_.registry().counter(
        "tm_gradsync_rounds_total", op="mean", compressed="none") == 1


# ---------------------------------------------------------------------------
# Planner, tuning, selector, dcn legs
# ---------------------------------------------------------------------------


def test_plan_counters_and_flight_event(both):
    jobs, tobs_, _ = both
    x = _x((8, 16))
    for _ in range(3):
        jmpi.allreduce(x)
        tmpi.allreduce_rank_major(torch.from_numpy(x))
    names = ("tm_plan_hit_total", "tm_plan_miss_total",
             "tm_plan_build_seconds")
    assert _norm(tobs_.registry().snapshot(), names) == \
        _norm(jobs.registry().snapshot(), names)
    assert tobs_.registry().counter("tm_plan_hit_total", op="allreduce",
                                    kind="eager") == 2
    assert [e for e in _events(tobs_) if e[0] == "plan"] == \
        [("plan", "allreduce", 0, "eager")]


def test_tuning_records(both, tmp_path):
    import jax.numpy as jnp

    from torchmpi_tpu import tuning as jtuning
    from torchmpi_tpu_torch import selector, tuning

    jobs, tobs_, _ = both
    mesh = jmpi.runtime.current_mesh()
    jtuning.configure(str(tmp_path / "j.json"), rounds=1)
    tuning.configure(str(tmp_path / "t.json"))
    try:
        for _ in range(2):
            jtuning.resolve_eager("allreduce", 4096, np.float32, mesh,
                                  lambda b: jnp.zeros(8))
            tuning.resolve_eager("allreduce", 4096, torch.float32,
                                 selector.grid_of(8, "cpu"),
                                 lambda b: torch.zeros(8),
                                 impl_op="allreduce_rank_major")
    finally:
        jtuning.reset()
        tuning.reset()
    reg = tobs_.registry()
    assert reg.counter("tm_tuning_plan_lookups_total", event="measured",
                       op="allreduce") == 1
    assert reg.counter("tm_tuning_plan_lookups_total", event="hit",
                       op="allreduce") == 1
    assert "tm_tuning_measured_us" in reg.names()
    names = ("tm_tuning_plan_lookups_total",)
    assert _norm(reg.snapshot(), names) == \
        _norm(jobs.registry().snapshot(), names)


def test_selector_fallback_counter(both):
    """A requested backend degraded by the selector (hierarchical on a
    flat world) counts ``tm_selector_fallback_total``, as JAX's does."""
    from torchmpi_tpu_torch import selector

    _, tobs_, _ = both
    selector._warned_fallbacks.clear()
    with pytest.warns(RuntimeWarning):
        tmpi.allreduce_rank_major(torch.ones(8, 4), backend="hierarchical")
    tmpi.allreduce_rank_major(torch.ones(8, 5), backend="hierarchical")
    assert tobs_.registry().counter(
        "tm_selector_fallback_total", op="allreduce_rank_major",
        backend="hierarchical") == 2


def test_dcn_legs_count_wire_bytes(both):
    """The two-level allreduce's dcn legs (``compress.note_leg``, JAX
    ``compress.py:244-256``): uncompressed legs count their payload as
    wire bytes; an int8 leg its quantized payload plus the scale."""
    _, tobs_, _ = both
    tmpi.set_config(dcn_size=2, custom_min_bytes=0)
    x = torch.randn(8, 1024)
    tmpi.allreduce_rank_major(x, backend="hierarchical")
    reg = tobs_.registry()
    # One chunk a rank: 1024 / 4 ici ranks = 256 float32 = 1 KiB.
    assert reg.counter("tm_dcn_legs_total", op="allreduce",
                       codec="none") == 1
    assert reg.counter("tm_dcn_wire_bytes_total", op="allreduce",
                       codec="none") == 1024
    tmpi.set_config(dcn_compress="int8", dcn_compress_min_bytes=0)
    tmpi.allreduce_rank_major(x, backend="hierarchical")
    assert reg.counter("tm_dcn_payload_bytes_total", op="allreduce",
                       codec="int8") == 1024
    assert reg.counter("tm_dcn_wire_bytes_total", op="allreduce",
                       codec="int8") == 256 + 4


# ---------------------------------------------------------------------------
# Async handles, the logger, the parameter server
# ---------------------------------------------------------------------------


def test_async_handle_records_wait_hist(both):
    jobs, tobs_, _ = both
    x = np.ones((8, 64), np.float32)
    h = jmpi.async_.allreduce(x, backend="host")
    h.wait()
    hs = [jmpi.async_.allreduce(x) for _ in range(2)]
    jmpi.wait_all(hs)
    xt = torch.ones(8, 64)
    h = tmpi.async_.allreduce(xt, backend="host")
    h.wait()
    h.wait()  # a second wait of a done handle records nothing more
    hs = [tmpi.async_.allreduce(xt) for _ in range(2)]
    tmpi.wait_all(hs)
    reg = tobs_.registry()
    # 3 creates, 3 waits and the batch's one wait_all.
    assert reg.counter_total("tm_async_handles_total") == 7
    hist = [r for r in reg.snapshot()
            if r.get("name") == "tm_async_wait_seconds"]
    assert sum(r["count"] for r in hist) == 2
    assert any(r["labels"].get("op") == "wait_all" for r in hist)
    evs = [e for e in tobs_.recorder().events() if e[2] == "async"]
    assert {e[6] for e in evs} == {"create", "wait"}
    names = ("tm_async_handles_total", "tm_async_wait_seconds",
             "tm_collectives_total", "tm_collective_bytes_total")
    assert _norm(reg.snapshot(), names) == \
        _norm(jobs.registry().snapshot(), names)
    # The staged handle's edges come from its worker thread, in either
    # order against the caller's events in JAX: the same events, and in
    # the port the create first.
    got = _events(tobs_, ("async", "eager", "eager_done"))
    assert sorted(got) == sorted(_events(jobs, ("async", "eager",
                                                "eager_done")))
    assert got[0][0] == "async" and got[1][0] == "eager"


def test_peer_timeout_carries_the_flight_tail(both):
    """``PeerTimeoutError`` names the last flight event (JAX
    ``faults/policy.py:72-94``)."""
    from torchmpi_tpu_torch import collectives

    _, tobs_, _ = both
    tmpi.allreduce_rank_major(torch.ones(8, 3))
    never = collectives.AsyncHandle(future=_Never(), device="cpu",
                                    op="allreduce")
    with pytest.raises(collectives.PeerTimeoutError,
                       match="last flight event #2 eager_done:allreduce"):
        never.wait(timeout_s=0.01)


class _Never:
    def done(self):
        return False


def test_metrics_logger_feeds_registry(both, tmp_path):
    from torchmpi_tpu.utils import metrics as jmetrics
    from torchmpi_tpu_torch.utils import metrics

    jobs, tobs_, _ = both
    for m, name in ((jmetrics, "j.jsonl"), (metrics, "t.jsonl")):
        lg = m.MetricsLogger(str(tmp_path / name), name="steps")
        lg.log(step=0, loss=1.0)
        lg.log(step=1, loss=0.5)
    assert tobs_.registry().counter("tm_log_records_total",
                                    logger="steps") == 2
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) == 2
    names = ("tm_log_records_total",)
    assert _norm(tobs_.registry().snapshot(), names) == \
        _norm(jobs.registry().snapshot(), names)


def test_ps_stats_and_wait_edge(both):
    from torchmpi_tpu_torch import parameterserver

    _, tobs_, _ = both
    template = {"w": torch.zeros(64)}
    ps = parameterserver.init(template, num_shards=2)
    try:
        ps.send(template, rule="add").wait()
        s1 = ps.stats()
        assert s1["ops"] >= 1
        s2 = ps.stats()
        assert all(s2[k] >= s1[k] for k in s1)
        reg = tobs_.registry()
        assert reg.counter_total("tm_ps_ops_total") >= s1["ops"]
        assert reg.counter_total("tm_ps_bytes_in_total") > 0
        done = [e for e in tobs_.recorder().events()
                if e[2] == "ps_wait_done"]
        assert done and done[-1][4] == 2  # the handle's shard futures
    finally:
        ps.shutdown()


# ---------------------------------------------------------------------------
# Off mode never imports the layer; two processes' dumps blame the
# injected divergence
# ---------------------------------------------------------------------------


def test_off_mode_never_imports_obs():
    code = (
        "import sys, torch\n"
        "import torchmpi_tpu_torch as mpi\n"
        "mpi.init(device='cpu')\n"
        "xs = torch.ones(4, 8)\n"
        "mpi.allreduce_rank_major(xs)\n"
        "mpi.allreduce_rank_major(xs, backend='host')\n"
        "mpi.allreduce(torch.ones(3))\n"
        "mpi.allreduce_in_axis({'a': torch.ones(2), 'b': torch.ones(3)})\n"
        "h = mpi.async_.allreduce(xs); h.wait()\n"
        "m = torch.nn.Linear(3, 2)\n"
        "step = mpi.nn.data_parallel_step_rank_major(\n"
        "    m, torch.optim.SGD(m.parameters(), lr=0.1),\n"
        "    lambda m, x, y: ((m(x) - y) ** 2).mean(), 2)\n"
        "step(torch.ones(4, 3), torch.zeros(4, 2))\n"
        "from torchmpi_tpu_torch.utils import metrics\n"
        "metrics.MetricsLogger().log(step=0)\n"
        "mpi.barrier()\n"
        "mpi.stop()\n"
        "assert 'torchmpi_tpu_torch.obs' not in sys.modules, 'obs imported'\n"
        "print('OFF-MODE-OK')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TORCHMPI_TPU_OBS")}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OFF-MODE-OK" in out.stdout


_WORKER = r"""
import os, sys
import torch
import torchmpi_tpu_torch as mpi

rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mpi.init(mpi.Config(obs="metrics", obs_dir=out_dir), device="cpu",
         init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
x = torch.full((4,), float(rank))
for _ in range(3):
    mpi.allreduce(x)
if rank == 1:
    # The injected rank-divergent collective: rank 1 launches one more
    # than rank 0 ever issues.  The barrier would wedge it with rank 0
    # gone, so it is recorded, not run: what a hung gang's ring shows.
    from torchmpi_tpu_torch import obs
    obs.record_eager("broadcast", 16, "xla", mpi.runtime.world_communicator())
from torchmpi_tpu_torch import obs
paths = obs.dump()
print(f"CHECK rank={rank} dumped={len(paths)}", flush=True)
"""


def test_two_process_blame_identifies_injected_divergence(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=_REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i}:\n{out}"
        assert f"CHECK rank={i} dumped=2" in out, out
    flights = sorted(str(f) for f in tmp_path.glob("flight_host*.jsonl"))
    assert len(flights) == 2
    out = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.obs.tool", "blame",
         *flights], capture_output=True, text=True, cwd=_REPO, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "continued past" in out.stdout and "broadcast" in out.stdout
    metrics_files = sorted(str(f) for f in
                           tmp_path.glob("metrics_host*.jsonl"))
    agg = tool.aggregate(metrics_files)
    assert sum(r["value"] for r in agg
               if r["name"] == "tm_collectives_total") == 7
    # The JAX package's tool reads the port's dumps the same way.
    spec = importlib.util.spec_from_file_location(
        "_jax_obs_tool", os.path.join(_REPO, "scripts", "obs_tool.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    assert jtool.aggregate(metrics_files) == agg
