"""The per-op backend table and the tuning rounds (``Config.backend_per_op``,
``Config.tuning_rounds``) on the CPU, against the JAX package.

``selector.config_backend`` is held to JAX's ``collectives._config_backend``
(a pure function) on the same tables, configs and ops, for both of the
port's forms of a verb; ``runtime._validate_backend_per_op`` raises where
JAX's raises, for the same bad tables, and keeps a private copy.  A per-op
entry bypasses the size cutover; a per-op ``"auto"`` arms the tuning plans
as ``backend="auto"`` does (JAX ``test_per_op_auto_table``); the rounds
reach the measurement; a ``set_config(backend_per_op=...)`` replays no
stale plan.  The new fields' env pickups are JAX's; ``use_accelerator=False``
brings the runtime up on the CPU.  The runtime is a world of one gloo
process.
"""

import dataclasses

import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import collectives as jcollectives
from torchmpi_tpu import runtime as jruntime
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import planner, runtime, selector, tuning
from torchmpi_tpu_torch.tuning import measure

from _torch_world import module_group

torch.set_num_threads(2)
N = 4


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture()
def rt():
    tmpi.stop()
    tmpi.init(device="cpu")
    planner.reset_stats()
    yield
    tmpi.stop()


TABLES = [None, {}, {"allreduce": "pallas"},
          {"allreduce": "auto", "broadcast": "xla"},
          {"broadcast": "hierarchical", "reduce_scatter": "pallas"}]
CONFIGS = [dict(backend="xla", hierarchical=False),
           dict(backend="auto", hierarchical=False),
           dict(backend="pallas", hierarchical=True)]


@pytest.mark.parametrize("table", TABLES, ids=lambda t: str(t))
def test_config_backend_matches_jax(table):
    for kw in CONFIGS:
        jcfg = jmpi.Config(backend_per_op=table, **kw)
        tcfg = tmpi.Config(backend_per_op=table, **kw)
        for op in ("allreduce", "broadcast", "reduce_scatter", "allgather",
                   "alltoall"):
            want = jcollectives._config_backend(op, jcfg)
            assert selector.config_backend(op, tcfg) == want, (op, kw)
            # A verb's entry covers its rank-major form too.
            assert selector.config_backend(f"{op}_rank_major",
                                           tcfg) == want, (op, kw)


BAD = [{"all_reduce": "hierarchical"}, {"allreduce": "nccl"},
       {"broadcast": "pallas"}, {"alltoall": "hierarchical"},
       {"allreduce_rank_major": "xla"}]
GOOD = [{"allreduce": "pallas"}, {"allreduce": "auto"},
        {"broadcast": "hierarchical", "sendreceive": "xla"}]


@pytest.mark.parametrize("table", BAD + GOOD, ids=lambda t: str(t))
def test_validation_matches_jax(table):
    def outcome(fn):
        try:
            return fn(table)
        except ValueError as e:
            return ("ValueError", "backend_per_op" in str(e))

    jmpi.stop()
    want = outcome(jruntime._validate_backend_per_op)
    got = outcome(runtime._validate_backend_per_op)
    assert got == want
    if table in BAD:
        assert got == ("ValueError", True)
    else:
        assert got == table and got is not table


def test_validation_on_init_and_set_config(rt):
    with pytest.raises(ValueError, match="unknown collective"):
        tmpi.set_config(backend_per_op={"all_reduce": "hierarchical"})
    with pytest.raises(ValueError, match="no\\s+implementation"):
        tmpi.set_config(backend_per_op={"broadcast": "pallas"})
    tmpi.stop()
    with pytest.raises(ValueError):
        tmpi.init(device="cpu", backend_per_op={"all_reduce": "xla"})
    with pytest.raises(ValueError):
        tmpi.init(tmpi.Config(backend_per_op={"allreduce": "nccl"}),
                  device="cpu")
    assert not runtime.is_initialized()


def test_caller_dict_not_aliased(rt):
    table = {"allreduce": "hierarchical"}
    tmpi.set_config(backend_per_op=table)
    table["allreduce"] = "pallas"  # the caller's mutation must not leak in
    assert tmpi.config().backend_per_op == {"allreduce": "hierarchical"}
    tmpi.stop()
    cfg = tmpi.Config(backend_per_op={"allreduce": "pallas"})
    tmpi.init(cfg, device="cpu")
    cfg.backend_per_op["allreduce"] = "xla"
    assert tmpi.config().backend_per_op == {"allreduce": "pallas"}


def test_per_op_entry_bypasses_cutover(rt):
    """A per-op entry is deliberate: the size cutover must not discard it
    (JAX ``test_backend_per_op_bypasses_cutover_and_validates``); other
    verbs keep the Config's backend and its cutover."""
    tmpi.set_config(backend="pallas", custom_min_bytes=1 << 30)
    impls = selector.available("allreduce_rank_major")
    assert selector.select("allreduce_rank_major", nbytes=16,
                           ranks=N) is impls["xla"]
    tmpi.set_config(backend_per_op={"allreduce": "pallas"})
    assert selector.select("allreduce_rank_major", nbytes=16,
                           ranks=N) is impls["pallas"]
    assert selector.select("allgather_rank_major", nbytes=16, ranks=N) \
        is selector.available("allgather_rank_major")["xla"]
    xs = torch.rand(N, 4, generator=torch.Generator().manual_seed(0))
    ring = tmpi.allreduce_rank_major(xs)
    assert torch.equal(ring, tmpi.allreduce_rank_major(xs,
                                                       backend="pallas"))
    rows = [r["backends"] for r in planner.describe()
            if r["kind"] == "eager" and r["op"] == "allreduce"]
    assert rows == [["pallas"], ["pallas"]]  # per-op, then per-call


def test_per_op_auto_table(tmp_path):
    """backend_per_op={"allreduce": "auto"} routes just that verb through
    the tuning plans (JAX ``test_per_op_auto_table``)."""
    tmpi.stop()
    tmpi.init(tmpi.Config(backend="xla", backend_per_op={"allreduce": "auto"},
                          tuning_plan_path=str(tmp_path / "p.json")),
              device="cpu")
    try:
        assert tuning.is_active()
        before = tuning.measurement_count()
        xs = torch.rand(N, 64, generator=torch.Generator().manual_seed(1))
        tmpi.allreduce_rank_major(xs)
        assert tuning.measurement_count() == before + 1
        tmpi.broadcast_rank_major(xs, root=0)  # not auto: static
        assert tuning.measurement_count() == before + 1
        assert runtime._tuning_auto_active(tmpi.config())
        tmpi.set_config(backend_per_op=None)
        assert not runtime._tuning_auto_active(tmpi.config())
    finally:
        tmpi.stop()


def test_tuning_rounds_reach_measure(tmp_path, monkeypatch):
    seen = []
    real = measure.measure

    def spy(step, iters=1, rounds=measure.ROUNDS, **kw):
        seen.append(rounds)
        return real(step, iters=iters, rounds=rounds, **kw)

    monkeypatch.setattr(measure, "measure", spy)
    monkeypatch.setenv("TORCHMPI_TPU_TUNING_ROUNDS", "2")
    cfg = tmpi.Config.from_env(backend="auto",
                               tuning_plan_path=str(tmp_path / "p.json"))
    assert cfg.tuning_rounds == 2
    assert tmpi.Config().tuning_rounds == measure.ROUNDS == 9
    tmpi.stop()
    tmpi.init(cfg, device="cpu")
    try:
        tmpi.allreduce_rank_major(torch.rand(N, 64))
        assert seen and set(seen) == {2}
        entry = next(iter(tuning.plan().entries.values()))
        assert entry.rounds == 2
        seen.clear()
        tmpi.set_config(tuning_rounds=3)
        tmpi.allreduce_rank_major(torch.rand(N, 2048))
        assert seen and set(seen) == {3}
    finally:
        tmpi.stop()


def test_no_stale_plan_after_set_config(rt):
    """The table is part of what a plan was resolved under: the config
    epoch (which every key holds) moves with ``set_config``, so the next
    call re-plans onto the new route."""
    tmpi.set_config(custom_min_bytes=0)
    xs = torch.rand(N, 64, generator=torch.Generator().manual_seed(2))
    tmpi.allreduce_rank_major(xs)
    epoch = runtime.config_epoch()
    rows = [r for r in planner.describe() if r["kind"] == "eager"]
    assert [r["backends"] for r in rows] == [["xla"]]
    tmpi.set_config(backend_per_op={"allreduce": "pallas"})
    assert runtime.config_epoch() == epoch + 1
    assert planner.describe() == []
    tmpi.allreduce_rank_major(xs)
    rows = [r for r in planner.describe() if r["kind"] == "eager"]
    assert [r["backends"] for r in rows] == [["pallas"]]
    tmpi.set_config(backend_per_op={"allreduce": "xla"})
    tmpi.allreduce_rank_major(xs)
    rows = [r for r in planner.describe() if r["kind"] == "eager"]
    assert [r["backends"] for r in rows] == [["xla"]]


@pytest.mark.parametrize("env,field,value", [
    ("TORCHMPI_TPU_USE_ACCELERATOR", "use_accelerator", "0"),
    ("TORCHMPI_TPU_USE_ACCELERATOR", "use_accelerator", "1"),
    ("TORCHMPI_TPU_TUNING_ROUNDS", "tuning_rounds", "4"),
])
def test_new_fields_env_pickup_matches_jax(monkeypatch, env, field, value):
    # Neither package reads a variable for ``use_accelerator``.
    monkeypatch.setenv(env, value)
    assert getattr(tmpi.Config.from_env(), field) == getattr(
        jmpi.Config.from_env(), field)


def test_config_holds_65_of_72_fields():
    jax_fields = {f.name for f in dataclasses.fields(jmpi.Config)}
    port = {f.name: f.default for f in dataclasses.fields(tmpi.Config)}
    assert len(port) == 65 and set(port) <= jax_fields
    # The TPU tile knobs (queue C note 4) and the parameter server's
    # fields that no code reads (ROADMAP "Not to port").
    assert jax_fields - set(port) == {
        "flash_block_q", "flash_block_k", "xent_block_n", "xent_block_v",
        "ps_port", "ps_host", "ps_num_threads"}
    jdef = {f.name: f.default for f in dataclasses.fields(jmpi.Config)}
    for name in ("use_accelerator", "backend_per_op"):
        assert port[name] == jdef[name]
    # The port's rounds default (ROADMAP queue C note 41).
    assert (port["tuning_rounds"], jdef["tuning_rounds"]) == (9, 3)


@pytest.mark.parametrize("how", ["compat_start", "config", "override"])
def test_use_accelerator_false_runs_on_the_cpu(how):
    """``use_accelerator=False`` is the reference's ``mpi.start(withCuda
    =false)``: with no ``device`` argument the runtime comes up on the
    CPU, however the flag arrives."""
    from torchmpi_tpu_torch import compat

    tmpi.stop()
    if how == "compat_start":
        dev = compat.start(use_accelerator=False)
    elif how == "config":
        dev = tmpi.init(tmpi.Config(use_accelerator=False))
    else:
        dev = tmpi.init(use_accelerator=False)
    try:
        assert dev.type == "cpu" and runtime.device().type == "cpu"
        assert runtime.backend_name() == "gloo"
        assert tmpi.config().use_accelerator is False
    finally:
        tmpi.stop()


def test_use_accelerator_records_the_device_and_is_fixed(rt):
    """An explicit ``device`` wins over the flag and is recorded in it;
    ``set_config`` refuses to move the device."""
    assert tmpi.config().use_accelerator is False  # rt: device="cpu"
    tmpi.set_config(use_accelerator=False)
    with pytest.raises(ValueError, match="fixed at init"):
        tmpi.set_config(use_accelerator=True)
    assert tmpi.config().use_accelerator is False
