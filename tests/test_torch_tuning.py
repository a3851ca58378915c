"""The port's tuning plans (torchmpi_tpu_torch/tuning/) against the JAX
package's (torchmpi_tpu/tuning/) on the CPU.

- The cases of ``tests/test_tuning.py`` on the port: plan-file durability,
  fingerprints, ``TimedResult`` and the noise gate, the online
  ``backend="auto"`` lifecycle on rank-major stacks of 8 ranks on a dcn 2 x
  ici 4 grid (a world of one gloo process), and ``plan_tool``.
- Key parity: the port's ``fingerprint`` equals the JAX package's, string
  for string, over (op, nbytes, dtype, dcn x ici, axes); a plan file
  written by either package loads in the other.
- ``noise_gate`` and ``plan_bucket_bytes`` give the JAX package's answers on
  the same inputs.
Where an outcome depends on timings, ``measure.measure`` is stubbed with
fixed ``TimedResult``s.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchmpi_tpu as jmpi
from torchmpi_tpu import tuning as jtuning
from torchmpi_tpu.utils import metrics as jmetrics
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import planner, selector, tuning
from torchmpi_tpu_torch.tuning import PlanCache, PlanEntry, plancache
from torchmpi_tpu_torch.tuning import autoselect, plan_tool
from torchmpi_tpu_torch.utils import metrics

from _torch_world import module_group

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


def entry(backend="pallas", ts=1.0):
    return PlanEntry(backend=backend, source="measured",
                     median_ms={"xla": 1.0, backend: 0.5},
                     jitter_ms={"xla": 0.1, backend: 0.1},
                     rounds=3, timestamp=ts)


# ---------------------------------------------------------------------------
# PlanCache persistence
# ---------------------------------------------------------------------------


def test_plan_roundtrip(tmp_path):
    path = str(tmp_path / "plans.json")
    cache = PlanCache(path)
    cache.put("cpu|dcn:1,ici:8|allreduce|float32|b20", entry())
    assert cache.save()
    back = PlanCache.load(path)
    assert back.degraded_reason is None
    e = back.get("cpu|dcn:1,ici:8|allreduce|float32|b20")
    assert e is not None and e.backend == "pallas"
    assert e.median_ms == {"xla": 1.0, "pallas": 0.5}
    assert e.rounds == 3 and e.source == "measured"


def test_plan_missing_file_is_empty(tmp_path):
    back = PlanCache.load(str(tmp_path / "nope.json"))
    assert back.degraded_reason is None and len(back) == 0


def test_plan_corrupt_degrades_silently(tmp_path):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        f.write("{not json")
    back = PlanCache.load(path)
    assert back.degraded_reason is not None and len(back) == 0


def test_plan_version_mismatch_degrades_silently(tmp_path):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        json.dump({"version": 999, "entries": {"k": {"backend": "xla"}}}, f)
    back = PlanCache.load(path)
    assert back.degraded_reason is not None and len(back) == 0


def test_plan_bad_entry_skipped_not_fatal(tmp_path):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        json.dump({"version": plancache.PLAN_VERSION,
                   "entries": {"good": {"backend": "xla"},
                               "bad": {"no_backend": 1},
                               "worse": "not a dict"}}, f)
    back = PlanCache.load(path)
    assert back.degraded_reason is None
    assert back.get("good") is not None
    assert back.get("bad") is None and back.get("worse") is None


def test_plan_foreign_timestamp_coerced_never_crashes(tmp_path):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        json.dump({"version": plancache.PLAN_VERSION,
                   "entries": {"k": {"backend": "xla", "timestamp": None,
                                     "rounds": "three"}}}, f)
    back = PlanCache.load(path)
    assert back.degraded_reason is None
    assert back.get("k").timestamp == 0.0 and back.get("k").rounds == 0
    back.put("k2", entry())
    assert back.save()


def test_plan_concurrent_writers_merge(tmp_path):
    path = str(tmp_path / "plans.json")
    a = PlanCache(path)
    b = PlanCache(path)
    a.put("key_a", entry("pallas", ts=1.0))
    b.put("key_b", entry("hierarchical", ts=2.0))
    assert a.save()
    assert b.save()
    back = PlanCache.load(path)
    assert back.get("key_a").backend == "pallas"
    assert back.get("key_b").backend == "hierarchical"


def test_plan_conflict_newer_timestamp_wins(tmp_path):
    path = str(tmp_path / "plans.json")
    a = PlanCache(path)
    a.put("k", entry("pallas", ts=100.0))
    assert a.save()
    b = PlanCache(path)
    b.put("k", entry("xla", ts=200.0))
    assert b.save()
    assert PlanCache.load(path).get("k").backend == "xla"
    c = PlanCache(path)
    c.put("k", entry("hierarchical", ts=50.0))
    assert c.save()
    assert PlanCache.load(path).get("k").backend == "xla"


def test_plan_save_unwritable_returns_false():
    cache = PlanCache("/proc/definitely/not/writable/plans.json")
    cache.put("k", entry())
    assert cache.save() is False


def test_plan_prune_and_merge_from():
    a = PlanCache()
    a.put("cpu|x|allreduce|float32|b10", entry(ts=1.0))
    a.put("tpu|y|allreduce|float32|b20", entry(ts=2.0))
    assert a.prune(lambda k, e: k.startswith("tpu")) == 1
    assert list(a.entries) == ["tpu|y|allreduce|float32|b20"]
    b = PlanCache()
    assert b.merge_from(a) == 1


def test_default_plan_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("TORCHMPI_TPU_TUNING_PLAN", raising=False)
    assert plancache.resolve_plan_path() == plancache.DEFAULT_PLAN_PATH
    assert os.path.basename(os.path.dirname(
        plancache.DEFAULT_PLAN_PATH)) == ".tuning_plans_torch"
    assert plancache.DEFAULT_PLAN_PATH != jtuning.DEFAULT_PLAN_PATH
    monkeypatch.setenv("TORCHMPI_TPU_TUNING_PLAN", "/x/env.json")
    assert plancache.resolve_plan_path() == "/x/env.json"
    assert plancache.resolve_plan_path("/x/arg.json") == "/x/arg.json"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plan_files_load_across_packages(tmp_path, writer):
    """A plan file written by one package loads in the other, every field
    of every entry intact."""
    path = str(tmp_path / "plans.json")
    W, R = ((jtuning, tuning) if writer == "jax" else (tuning, jtuning))
    w = W.PlanCache(path)
    for i, b in enumerate(("xla", "pallas", "hierarchical")):
        w.put(f"cpu|dcn:2,ici:4|allreduce|float32|b{10 + i}",
              W.PlanEntry(backend=b, source="measured",
                          median_ms={"xla": 1.0 + i, b: 0.5},
                          jitter_ms={"xla": 0.1, b: 0.05}, rounds=3,
                          timestamp=100.0 + i))
    assert w.save()
    back = R.PlanCache.load(path)
    assert back.degraded_reason is None
    assert {k: e.to_json() for k, e in back.entries.items()} == \
        {k: e.to_json() for k, e in w.entries.items()}


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def test_size_bucket_log2():
    assert tuning.size_bucket(0) == 0
    assert tuning.size_bucket(1) == 0
    assert tuning.size_bucket(1024) == 10
    assert tuning.size_bucket(1025) == 10
    assert tuning.size_bucket(2047) == 10
    assert tuning.size_bucket(2048) == 11
    assert tuning.bucket_bytes(10) == 1024


def test_fingerprint_keys_topology():
    grid = selector.grid_of(8, "cpu", n_dcn=1)
    key = tuning.make_fingerprint("allreduce", 4096, torch.float32, grid)
    assert key == "cpu|dcn:1,ici:8|allreduce|float32|b12"


def test_fingerprint_distinguishes_grid():
    key = tuning.make_fingerprint("allreduce", 4096, torch.float32,
                                  selector.grid_of(8, "cpu", n_dcn=2))
    assert "dcn:2,ici:4" in key


def test_fingerprint_axes_subset_gets_own_key(tmp_path):
    tmpi.init(device="cpu")
    try:
        tuning.configure(str(tmp_path / "p.json"))
        grid = selector.grid_of(8, "cpu", n_dcn=2)
        full = tuning.make_fingerprint("allreduce", 4096, torch.float32,
                                       grid)
        both = tuning.make_fingerprint("allreduce", 4096, torch.float32,
                                       grid, axes=("dcn", "ici"))
        sub = tuning.make_fingerprint("allreduce", 4096, torch.float32,
                                      grid, axes=("dcn",))
        assert both == full
        assert sub != full and "dcn:2" in sub and "ici" not in sub
        rev = tuning.make_fingerprint("allreduce", 4096, torch.float32,
                                      grid, axes=("ici", "dcn"))
        assert rev == full
        tuning.plan().put(full, PlanEntry(backend="pallas", source="manual"))
        assert tuning.plan_lookup("allreduce", 4096, torch.float32, grid,
                                  ("dcn", "ici")) == "pallas"
        assert tuning.plan_lookup("allreduce", 4096, torch.float32, grid,
                                  ("dcn",)) is None
    finally:
        tmpi.stop()
    assert not tuning.is_active()


def _jax_mesh(d, i):
    return Mesh(np.array(jax.devices()[:d * i]).reshape(d, i),
                ("dcn", "ici"))


@pytest.mark.parametrize("d,i", [(1, 1), (1, 2), (1, 8), (2, 2), (2, 4),
                                 (4, 2), (8, 1)])
def test_fingerprint_equals_jax(d, i):
    """String for string, over ops, sizes straddling bucket edges, dtypes
    and axis subsets."""
    jm, grid = _jax_mesh(d, i), selector.grid_of(d * i, "cpu", n_dcn=d)
    dtypes = [(np.float32, torch.float32), (np.int32, torch.int32),
              (jax.numpy.bfloat16, torch.bfloat16),
              (np.float16, torch.float16)]
    for op in ("allreduce", "reduce_scatter", "allgather", "broadcast"):
        for nbytes in (0, 1, 2, 1023, 1024, 65535, 65536, 3 << 20,
                       33_000_998):
            for jd, td in dtypes:
                for axes in (None, ("dcn",), ("ici",), ("ici", "dcn")):
                    want = jtuning.make_fingerprint(op, nbytes, jd, jm,
                                                    axes=axes)
                    got = tuning.make_fingerprint(op, nbytes, td, grid,
                                                  axes=axes)
                    assert got == want, (op, nbytes, td, axes)
    assert tuning.fingerprint.topology(grid) == \
        jtuning.fingerprint.topology(jm)
    assert tuning.fingerprint.topology(grid, axes=("ici",)) == \
        jtuning.fingerprint.topology(jm, axes=("ici",))


def test_nbytes_of():
    """``selector.nbytes_of`` (JAX's, for the tuning keys): a tensor, a tree
    summed over its leaves, 0 for non-tensors."""
    assert selector.nbytes_of(torch.zeros(4, 4)) == 64
    tree = {"a": torch.zeros(2, 3),
            "b": [torch.zeros(5, dtype=torch.float64),
                  torch.zeros(1, dtype=torch.int8)]}
    assert selector.nbytes_of(tree) == 2 * 3 * 4 + 5 * 8 + 1
    assert selector.nbytes_of(None) == 0
    assert selector.nbytes_of(3.5) == 0


# ---------------------------------------------------------------------------
# metrics.timed and the noise gate
# ---------------------------------------------------------------------------


def test_timed_result_is_float_with_spread():
    x = torch.ones(16)
    res = metrics.timed(lambda: x * 2, iters=1, rounds=4)
    assert isinstance(res, float) and isinstance(res, metrics.TimedResult)
    assert len(res.round_times) == 4
    assert float(res) == min(res.round_times)
    assert res.median >= float(res) >= 0.0
    assert res.jitter >= 0.0
    assert metrics.last_round_times == res.round_times


def test_timed_result_median_jitter_math():
    r = metrics.TimedResult([4.0, 1.0, 3.0, 2.0])
    assert float(r) == 1.0
    assert r.median == 2.5
    assert r.jitter == 0.5 * (4.0 - 2.0)


def test_noise_gate_keeps_default_within_noise():
    cands = {"xla": metrics.TimedResult([1.0, 1.1, 1.2, 1.3]),
             "pallas": metrics.TimedResult([0.9, 1.0, 1.1, 1.2])}
    chosen, ev = tuning.noise_gate(cands, "xla")
    assert chosen == "xla" and ev["gated_to_default"]


def test_noise_gate_switches_beyond_noise():
    cands = {"xla": metrics.TimedResult([1.0, 1.0, 1.0, 1.0]),
             "pallas": metrics.TimedResult([0.1, 0.1, 0.1, 0.1])}
    chosen, ev = tuning.noise_gate(cands, "xla")
    assert chosen == "pallas" and ev["delta_ms"] > 0


def test_noise_gate_empty_and_missing_default():
    chosen, _ = tuning.noise_gate({}, "xla")
    assert chosen == "xla"
    chosen, ev = tuning.noise_gate(
        {"pallas": metrics.TimedResult([0.5, 0.5])}, "xla")
    assert chosen == "pallas" and "argmin" in ev["note"]


GATE_CASES = [
    {},
    {"pallas": [0.5, 0.5]},
    {"xla": [1.0, 1.1, 1.2, 1.3], "pallas": [0.9, 1.0, 1.1, 1.2]},
    {"xla": [1.0] * 4, "pallas": [0.1] * 4},
    {"xla": [2.0, 2.1, 1.9], "pallas": [1.5, 1.9, 1.7],
     "hierarchical": [1.2, 3.0, 1.1]},
    {"xla": [0.3, 0.3, 0.31, 0.29, 0.3], "hierarchical": [0.2] * 5},
    {"xla": [1e-4, 2e-4, 3e-4], "pallas": [1e-4, 1e-4, 1e-4]},
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_noise_gate_equals_jax(case):
    rounds = GATE_CASES[case]
    got = tuning.noise_gate(
        {b: metrics.TimedResult(t) for b, t in rounds.items()}, "xla")
    want = jtuning.noise_gate(
        {b: jmetrics.TimedResult(t) for b, t in rounds.items()}, "xla")
    assert got == want


@pytest.mark.parametrize("d,i", [(1, 8), (2, 4)])
def test_plan_bucket_bytes_equals_jax(tmp_path, d, i):
    """No plan, then a plan with entries of other ops, grids and
    platforms: the same bound as the JAX package's, every fallback."""
    jm, grid = _jax_mesh(d, i), selector.grid_of(d * i, "cpu", n_dcn=d)
    fallbacks = (1, 1000, 1 << 20, 3 << 20, 32 << 20, 33 << 20, 1 << 30)
    want = [jtuning.plan_bucket_bytes("allreduce", jm, f) for f in fallbacks]
    assert [tuning.plan_bucket_bytes("allreduce", grid, f)
            for f in fallbacks] == want
    keys = [f"cpu|dcn:{d},ici:{i}|allreduce|float32|b{b}"
            for b in (12, 18, 21, 26)]
    keys += ["cpu|dcn:9,ici:9|allreduce|float32|b19",
             f"cuda|dcn:{d},ici:{i}|allreduce|float32|b22",
             f"cpu|dcn:{d},ici:{i}|broadcast|float32|b23",
             f"cpu|dcn:{d},ici:{i}|allreduce|float32|bxx"]
    for pkg, name in ((jtuning, "j.json"), (tuning, "t.json")):
        c = pkg.PlanCache(str(tmp_path / name))
        for k in keys:
            c.put(k, pkg.PlanEntry(backend="xla"))
        assert c.save()
    jtuning.configure(str(tmp_path / "j.json"))
    tuning.configure(str(tmp_path / "t.json"))
    try:
        want = [jtuning.plan_bucket_bytes("allreduce", jm, f)
                for f in fallbacks]
        got = [tuning.plan_bucket_bytes("allreduce", grid, f)
               for f in fallbacks]
    finally:
        jtuning.reset()
        tuning.reset()
    assert got == want
    assert got[3] == 1 << 21  # the largest measured bucket under 3 MiB


# ---------------------------------------------------------------------------
# Online "auto" lifecycle (rank-major stacks of 8 on a dcn 2 x ici 4 grid)
# ---------------------------------------------------------------------------


@pytest.fixture()
def auto_runtime(tmp_path):
    plan = str(tmp_path / "plans.json")
    tmpi.stop()
    tuning.reset_measurement_count()
    tmpi.init(tmpi.Config(dcn_size=2, backend="auto", tuning_plan_path=plan),
              device="cpu")
    yield selector.grid_of(8, "cpu"), plan
    tmpi.stop()


def rank_major(n=8, elems=1024):
    return torch.stack([torch.full((elems,), float(r)) for r in range(n)])


def test_auto_first_call_measures_then_reuses(auto_runtime):
    grid, plan = auto_runtime
    x = rank_major()
    before = tuning.measurement_count()
    y = tmpi.allreduce_rank_major(x)
    assert torch.equal(y[0], x.sum(0))
    assert tuning.measurement_count() == before + 1
    data = json.load(open(plan))
    assert data["version"] == plancache.PLAN_VERSION
    (key, e), = data["entries"].items()
    assert key == "cpu|dcn:2,ici:4|allreduce|float32|b12"
    assert e["backend"] in ("xla", "hierarchical", "pallas")
    assert set(e["median_ms"]) == {"xla", "hierarchical", "pallas"}
    assert e["rounds"] == tuning.measure.ROUNDS
    tmpi.allreduce_rank_major(x)
    assert tuning.measurement_count() == before + 1
    tmpi.allreduce_rank_major(rank_major(elems=64))
    assert tuning.measurement_count() == before + 2
    assert len(json.load(open(plan))["entries"]) == 2


def test_auto_second_process_zero_remeasurement(auto_runtime):
    grid, plan = auto_runtime
    x = rank_major()
    first = tmpi.allreduce_rank_major(x)
    chosen = tuning.plan().get(list(tuning.plan().entries)[0]).backend
    tmpi.stop()
    tuning.reset_measurement_count()
    tmpi.init(tmpi.Config(dcn_size=2, backend="auto", tuning_plan_path=plan),
              device="cpu")
    y = tmpi.allreduce_rank_major(x)
    assert tuning.measurement_count() == 0
    assert torch.equal(y, first)
    dec = [d for d in tuning.decisions()
           if d.get("event") == "tuning_decision"][-1]
    assert dec["source"] == "plan" and dec["backend"] == chosen


def test_auto_stable_across_runs_via_noise_gate(auto_runtime, monkeypatch):
    """Candidates within noise of each other yield "xla" on every
    re-measurement."""
    def fake_measure(step, iters=1, rounds=3, fence=None):
        step()
        return metrics.TimedResult([1.00, 1.05, 1.10, 1.15])

    monkeypatch.setattr(autoselect.measure, "measure", fake_measure)
    winners = []
    for _ in range(2):
        tmpi.allreduce_rank_major(rank_major())
        key = list(tuning.plan().entries)[0]
        winners.append(tuning.plan().get(key).backend)
        tuning.plan().entries.clear()
        tmpi.collectives.clear_cache()
    assert winners == ["xla", "xla"]


def test_auto_winner_beyond_noise_is_replayed(auto_runtime, monkeypatch):
    """A candidate faster beyond the noise floor wins, and the call's
    output is the winner's (the ring's fold, bitwise)."""
    def fake_measure(step, iters=1, rounds=3, fence=None):
        return metrics.TimedResult(fake_measure.next.pop(0))

    # The candidates in sorted order: hierarchical, pallas, xla.
    fake_measure.next = [[1.0] * 4, [0.1] * 4, [2.0] * 4]
    monkeypatch.setattr(autoselect.measure, "measure", fake_measure)
    x = torch.randn(8, 1000, generator=torch.Generator().manual_seed(3))
    y = tmpi.allreduce_rank_major(x)
    (e,) = tuning.plan().entries.values()
    assert e.backend == "pallas"
    assert torch.equal(y, tmpi.allreduce_rank_major(x, backend="pallas"))


def test_auto_corrupt_plan_falls_back_static(tmp_path):
    plan = str(tmp_path / "plans.json")
    with open(plan, "w") as f:
        f.write("{definitely not json")
    tmpi.stop()
    tmpi.init(tmpi.Config(dcn_size=2, backend="auto", tuning_plan_path=plan),
              device="cpu")
    try:
        before = tuning.measurement_count()
        x = rank_major()
        y = tmpi.allreduce_rank_major(x)
        assert torch.equal(y[0], x.sum(0))
        assert tuning.measurement_count() == before
        with open(plan) as f:
            assert f.read() == "{definitely not json"
    finally:
        tmpi.stop()


def test_auto_plan_hit_bypasses_size_cutover(auto_runtime):
    grid, plan = auto_runtime
    x = rank_major(elems=8)  # 32 B a rank, far below custom_min_bytes
    key = tuning.make_fingerprint("allreduce", 32, torch.float32, grid)
    tuning.plan().put(key, PlanEntry(backend="hierarchical",
                                     source="manual"))
    impl = selector.select("allreduce_rank_major", "auto", nbytes=32,
                           ranks=8, dtype=torch.float32, grid=grid)
    assert selector.name_of("allreduce_rank_major", impl) == "hierarchical"
    y = tmpi.allreduce_rank_major(x)
    assert torch.equal(y[0], x.sum(0))
    assert tuning.measurement_count() == 0
    assert planner.describe()[-1]["backend"] == "hierarchical"


def test_auto_miss_without_provider_degrades_to_xla():
    tmpi.init(device="cpu")
    try:
        impl = selector.select("allreduce_rank_major", "auto",
                               nbytes=1 << 20, ranks=8,
                               dtype=torch.float32,
                               grid=selector.grid_of(8, "cpu"))
        assert impl is selector.available("allreduce_rank_major")["xla"]
    finally:
        tmpi.stop()


def test_auto_in_axis_consults_plan(auto_runtime):
    """A process-world in-axis call replays a plan of its own key (the
    world of one, ``dcn:1,ici:1``) with no measurement."""
    x = torch.arange(128.0)
    key = tuning.make_fingerprint("allreduce", 512, torch.float32,
                                  selector.grid_of(None, "cpu"))
    assert key == "cpu|dcn:1,ici:1|allreduce|float32|b9"
    tuning.plan().put(key, PlanEntry(backend="pallas", source="manual"))
    y = tmpi.allreduce_in_axis(x, ("dcn", "ici"))
    assert torch.equal(y, x)
    assert tuning.measurement_count() == 0
    (row,) = [r for r in planner.describe() if r["kind"] == "world"]
    assert row["backend"] == "pallas"


def test_auto_select_derives_the_call_grid(auto_runtime):
    """Under "auto" with no grid given the selector keys the plan on the
    grid the call spans: a rank-major stack's on its device, else the
    process world's."""
    grid, plan = auto_runtime
    key = tuning.make_fingerprint("allreduce", 1 << 20, torch.float32, grid)
    tuning.plan().put(key, PlanEntry(backend="hierarchical",
                                     source="manual"))
    impl = selector.select("allreduce_rank_major", nbytes=1 << 20, ranks=8,
                           dtype=torch.float32, device="cpu")
    assert selector.name_of("allreduce_rank_major", impl) == "hierarchical"
    world = tuning.make_fingerprint("allreduce", 1 << 20, torch.float32,
                                    selector.grid_of(None, "cpu"))
    tuning.plan().put(world, PlanEntry(backend="pallas", source="manual"))
    impl = selector.select("allreduce", nbytes=1 << 20, dtype=torch.float32,
                           device="cpu")
    assert selector.name_of("allreduce", impl) == "pallas"
    impl = selector.select("allreduce", nbytes=1 << 19, dtype=torch.float32,
                           device="cpu")
    assert selector.name_of("allreduce", impl) == "xla"  # a miss


def test_decisions_surface_through_metrics(auto_runtime, tmp_path):
    log = metrics.MetricsLogger(str(tmp_path / "decisions.jsonl"))
    tuning.set_decision_logger(log)
    try:
        tmpi.allreduce_rank_major(rank_major())
    finally:
        tuning.set_decision_logger(None)
    recs = [r for r in log.records if r.get("event") == "tuning_decision"]
    assert recs and recs[-1]["source"] == "measured"
    assert recs[-1]["backend"] in ("xla", "hierarchical", "pallas")
    assert "evidence" in recs[-1] and "errors" not in recs[-1]
    lines = (tmp_path / "decisions.jsonl").read_text().strip().splitlines()
    assert len(lines) == len(log.records)


def test_plan_path_without_auto_loads_but_logs_inactive(tmp_path):
    plan = str(tmp_path / "plans.json")
    seeded = PlanCache(plan)
    seeded.put("k", entry())
    assert seeded.save()
    tmpi.stop()
    tmpi.init(tmpi.Config(dcn_size=2, backend="xla", tuning_plan_path=plan),
              device="cpu")
    try:
        assert tuning.is_active() and len(tuning.plan()) == 1
        ev = [d for d in tuning.decisions()
              if d.get("event") == "tuning_plan_inactive"]
        assert ev and "auto" in ev[-1]["reason"]
        before = tuning.measurement_count()
        x = rank_major()
        y = tmpi.allreduce_rank_major(x)
        assert torch.equal(y[0], x.sum(0))
        assert tuning.measurement_count() == before
    finally:
        tmpi.stop()


def test_multiprocess_disables_online_measurement(auto_runtime,
                                                  monkeypatch):
    grid, plan = auto_runtime
    monkeypatch.setattr(autoselect, "_multiprocess", lambda: True)
    x = rank_major()
    y = tmpi.allreduce_rank_major(x)
    assert torch.equal(y[0], x.sum(0))
    assert tuning.measurement_count() == 0
    assert not os.path.exists(plan)
    dec = [d for d in tuning.decisions()
           if d.get("event") == "tuning_decision"][-1]
    assert dec["source"] == "fallback" and "multiprocess" in dec["reason"]
    key = tuning.make_fingerprint("allreduce", 4096, torch.float32, grid)
    tuning.plan().put(key, PlanEntry(backend="hierarchical",
                                     source="manual"))
    tmpi.collectives.clear_cache()
    y = tmpi.allreduce_rank_major(x)
    assert torch.equal(y[0], x.sum(0))
    assert tuning.measurement_count() == 0
    assert planner.describe()[-1]["backend"] == "hierarchical"


def test_configure_same_path_keeps_memory_entries(auto_runtime):
    grid, plan = auto_runtime
    key = tuning.make_fingerprint("allreduce", 32, torch.float32, grid)
    tuning.plan().put(key, PlanEntry(backend="hierarchical",
                                     source="manual"))
    tmpi.set_config(chunk_bytes=1 << 20)
    assert tuning.plan().get(key) is not None
    tmpi.set_config(tuning_plan_path=plan + ".other")
    assert tuning.plan().get(key) is None
    assert tuning.plan().path == plan + ".other"


def test_config_tuning_fields_match_jax(monkeypatch):
    assert tmpi.Config().tuning_plan_path == jmpi.Config().tuning_plan_path
    monkeypatch.setenv("TORCHMPI_TPU_TUNING_PLAN", "/x/plans.json")
    monkeypatch.setenv("TORCHMPI_TPU_BACKEND", "auto")
    got, want = tmpi.Config.from_env(), jmpi.Config.from_env()
    for f in ("tuning_plan_path", "backend"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.tuning_plan_path, got.backend) == ("/x/plans.json", "auto")


def test_plan_tool_show_merge_prune(tmp_path, capsys):
    a_path, b_path = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    out = str(tmp_path / "merged.json")
    a = PlanCache(a_path)
    a.put("cpu|dcn:1,ici:8|allreduce|float32|b10", entry("pallas", ts=1.0))
    assert a.save()
    b = PlanCache(b_path)
    b.put("cuda|dcn:1,ici:4|allreduce|float32|b20",
          entry("hierarchical", ts=2.0))
    assert b.save()

    assert plan_tool.main(["show", a_path]) == 0
    assert "pallas" in capsys.readouterr().out

    assert plan_tool.main(["merge", out, a_path, b_path]) == 0
    capsys.readouterr()
    assert len(PlanCache.load(out)) == 2

    assert plan_tool.main(["prune", out, "--drop-match", "cpu|"]) == 0
    capsys.readouterr()
    assert list(PlanCache.load(out).entries) == \
        ["cuda|dcn:1,ici:4|allreduce|float32|b20"]

    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("nope")
    assert plan_tool.main(["show", bad]) == 0
    assert plan_tool.main(["prune", bad]) == 1
