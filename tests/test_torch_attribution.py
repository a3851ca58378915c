"""Step-time attribution of the port (``torchmpi_tpu_torch/obs/
attribution.py`` and ``python -m torchmpi_tpu_torch.obs.tool attribute``)
against the JAX package's (``torchmpi_tpu/obs/attribution.py``,
``scripts/obs_tool.py``; spec JAX ``tests/test_attribution.py``).

The same flight and metrics dumps go through both phase models and must
give the same budgets; the port's holds JAX's assertions (the phases sum
to the window's wall time, host-staged vs device classification, wrapped
rings, histogram clamping, the regressed-phase verdict); the CLI prints
JAX's text; and one real port training run (rank-major data-parallel
steps under ``Config.obs="metrics"``) attributes cleanly through both
tools.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

import torchmpi_tpu_torch as tmpi
from _torch_world import module_group

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
attr = importlib.import_module("torchmpi_tpu_torch.obs.attribution")


def _jax_attr():
    spec = importlib.util.spec_from_file_location(
        "_jax_attribution",
        os.path.join(_REPO, "torchmpi_tpu", "obs", "attribution.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ev(seq, ts, ev, op="", nbytes=0, backend="", detail=""):
    return {"kind": "event", "seq": seq, "ts": ts, "ev": ev, "op": op,
            "nbytes": nbytes, "backend": backend, "detail": detail}


def _hist(name, total, count):
    return {"kind": "hist", "name": name, "labels": {},
            "buckets": {}, "count": count, "sum": total}


def _phase_seconds(budget):
    return {p: budget["phases"][p]["seconds"] for p in budget["phases"]}


def _assert_sums_to_wall(budget):
    secs = sum(v["seconds"] for v in budget["phases"].values())
    assert secs == pytest.approx(budget["wall_s"], rel=1e-9)
    shares = sum(v["share"] for v in budget["phases"].values())
    assert shares == pytest.approx(1.0, rel=1e-9)


# Synthetic rings (each JAX test's), by name: (flight, metrics).
RINGS = {
    "two-windows": ([
        _ev(0, 0.0, "step", "data_parallel_step"),
        _ev(1, 0.1, "eager", "allreduce", 4096, "direct"),
        _ev(2, 0.4, "eager_done", "allreduce", 4096, "direct"),
        _ev(3, 0.5, "eager", "allreduce", 1024, "host_ring"),
        _ev(4, 0.7, "eager_done", "allreduce", 1024, "host_ring"),
        _ev(5, 1.0, "step", "data_parallel_step"),
        _ev(6, 2.0, "step", "data_parallel_step")], []),
    "histograms": ([
        _ev(0, 0.0, "step", "g"),
        _ev(1, 0.2, "plan", "allreduce", 0, "direct", "miss"),
        _ev(2, 0.5, "guard", "allreduce", 0, "", "verified"),
        _ev(3, 1.0, "step", "g")],
        [_hist("tm_plan_build_seconds", 0.4, 2),
         _hist("tm_guard_verify_us", 2e5, 2)]),
    "clamped": ([
        _ev(0, 0.0, "step", "g"),
        _ev(1, 0.2, "plan", "allreduce", 0, "direct", "miss"),
        _ev(2, 0.5, "guard", "allreduce", 0, "", "verified"),
        _ev(3, 1.0, "step", "g")],
        [_hist("tm_plan_build_seconds", 30.0, 2),
         _hist("tm_guard_verify_us", 2e6, 2)]),
    "overlap": ([
        _ev(0, 0.0, "step", "g"),
        _ev(1, 0.1, "eager", "allgather", 512, "host_ring"),
        _ev(2, 0.2, "eager", "allreduce", 4096, "direct"),
        _ev(3, 0.4, "eager_done", "allreduce", 4096, "direct"),
        _ev(4, 0.5, "eager_done", "allgather", 512, "host_ring"),
        _ev(5, 1.0, "step", "g")], []),
    "wrapped": ([
        _ev(10, 0.0, "step", "g"),
        _ev(11, 0.3, "barrier_done", "sync"),
        _ev(12, 0.5, "eager", "allreduce", 64, "direct"),
        _ev(13, 1.0, "step", "g")], []),
    "no-markers": ([
        _ev(0, 1.0, "eager", "allreduce", 64, "direct"),
        _ev(1, 1.4, "eager_done", "allreduce", 64, "direct"),
        _ev(2, 2.0, "eager", "allreduce", 64, "direct"),
        _ev(3, 2.5, "eager_done", "allreduce", 64, "direct")], []),
    "ps-wait": ([
        _ev(0, 0.0, "step", "g"),
        _ev(1, 0.25, "eager", "allreduce", 64, "host"),
        _ev(2, 0.5, "ps_wait_done", "ps", 2),
        _ev(3, 1.0, "step", "g")], []),
}


@pytest.mark.parametrize("ring", list(RINGS))
def test_budget_matches_jax(ring):
    flight, metrics = RINGS[ring]
    got = attr.attribute_host(flight, metrics, host="h0")
    assert got == _jax_attr().attribute_host(flight, metrics, host="h0")
    _assert_sums_to_wall(got)


def test_budget_sums_to_step_wall_time():
    b = attr.attribute_host(*RINGS["two-windows"], host="h0")
    assert b["steps"] == 2
    assert b["wall_s"] == pytest.approx(2.0)
    assert b["step_ms"] == pytest.approx(1000.0)
    secs = _phase_seconds(b)
    assert secs["collective_wait"] == pytest.approx(0.3)
    assert secs["host_staging"] == pytest.approx(0.2)
    assert secs["compile"] == 0.0 and secs["guard_verify"] == 0.0
    assert secs["dispatch_gap"] == pytest.approx(1.5)


def test_histogram_costed_phases_and_clamp():
    flight, metrics = RINGS["histograms"]
    secs = _phase_seconds(attr.attribute_host(flight, metrics, host="h0"))
    assert secs["compile"] == pytest.approx(0.2)
    assert secs["guard_verify"] == pytest.approx(0.1)
    assert secs["dispatch_gap"] == pytest.approx(0.7)
    b2 = attr.attribute_host(*RINGS["clamped"], host="h0")
    assert b2["phases"]["dispatch_gap"]["seconds"] == pytest.approx(0.0)
    assert any("clamped" in n for n in b2["notes"])
    b3 = attr.attribute_host(flight, [], host="h0")
    assert any("under-counted" in n for n in b3["notes"])
    _assert_sums_to_wall(b3)


def test_overlap_wrapped_and_markerless_rings():
    secs = _phase_seconds(attr.attribute_host(*RINGS["overlap"], host="h"))
    assert secs["host_staging"] == pytest.approx(0.4)
    assert secs["collective_wait"] == pytest.approx(0.0)
    b = attr.attribute_host(*RINGS["wrapped"], host="h0")
    assert b["phases"]["collective_wait"]["seconds"] == pytest.approx(0.3)
    assert any("wrapped ring" in n for n in b["notes"])
    assert any("never completed" in n for n in b["notes"])
    b = attr.attribute_host(*RINGS["no-markers"], host="h0")
    assert b["steps"] == 1 and b["wall_s"] == pytest.approx(1.5)
    assert any("whole-ring window" in n for n in b["notes"])
    assert attr.attribute_host([], [], host="h0") is None
    assert attr.attribute_host([{"kind": "meta"}], [], host="h0") is None


def _synthetic_budget(mod, wait_s):
    return mod.attribute_host([
        _ev(0, 0.0, "step", "g"),
        _ev(1, 0.1, "eager", "allreduce", 64, "direct"),
        _ev(2, 0.1 + wait_s, "eager_done", "allreduce", 64, "direct"),
        _ev(3, 1.0, "step", "g")], [], host="h0")


def test_diff_and_aggregate_match_jax():
    jattr = _jax_attr()
    for mod in (attr, jattr):
        before = [_synthetic_budget(mod, 0.1)]
        after = [_synthetic_budget(mod, 0.6)]
        d = mod.diff_budgets(before, after)
        assert d["regressed"] == "collective_wait"
        assert d["deltas"]["collective_wait"] == pytest.approx(0.5)
        assert mod.diff_budgets(before, before)["regressed"] is None
    d = attr.diff_budgets([_synthetic_budget(attr, 0.1)],
                          [_synthetic_budget(attr, 0.6)])
    assert d == jattr.diff_budgets([_synthetic_budget(jattr, 0.1)],
                                   [_synthetic_budget(jattr, 0.6)])
    a = attr.attribute_host([_ev(0, 0.0, "step", "g"),
                             _ev(1, 1.0, "step", "g")], [], host="a")
    b = attr.attribute_host([_ev(0, 0.0, "step", "g"),
                             _ev(1, 0.0, "eager", "allreduce", 64, "direct"),
                             _ev(2, 3.0, "eager_done", "allreduce", 64,
                                 "direct"),
                             _ev(3, 3.0, "step", "g")], [], host="b")
    agg = attr.aggregate_shares([a, b])
    assert agg["collective_wait"] == pytest.approx(0.75)
    assert agg == jattr.aggregate_shares([a, b])


# ---------------------------------------------------------------------------
# The CLI, against the JAX package's
# ---------------------------------------------------------------------------


def _write_dump(dirpath, host, flight, metrics=()):
    os.makedirs(dirpath, exist_ok=True)
    fmeta = {"kind": "meta", "stream": "flight", "host": host,
             "pid": 1, "mode": "metrics", "time": 0.0,
             "ring": 1024, "total": len(flight), "dropped": 0}
    with open(os.path.join(dirpath, f"flight_host{host}.jsonl"), "w") as f:
        for rec in [fmeta] + list(flight):
            f.write(json.dumps(rec) + "\n")
    mmeta = {"kind": "meta", "stream": "metrics", "host": host,
             "pid": 1, "mode": "metrics", "time": 0.0}
    with open(os.path.join(dirpath, f"metrics_host{host}.jsonl"),
              "w") as f:
        for rec in [mmeta] + list(metrics):
            f.write(json.dumps(rec) + "\n")


def _tools(*argv):
    """(port, JAX) results of one tool command, each a subprocess."""
    port = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.obs.tool", *argv],
        capture_output=True, text=True, timeout=120, cwd=_REPO)
    jax_ = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts", "obs_tool.py"),
         *argv], capture_output=True, text=True, timeout=120, cwd=_REPO)
    return port, jax_


def test_tool_attribute_cli(tmp_path):
    d = str(tmp_path / "dump")
    _write_dump(d, "0", [
        _ev(0, 0.0, "step", "g"),
        _ev(1, 0.2, "eager", "allreduce", 64, "direct"),
        _ev(2, 0.6, "eager_done", "allreduce", 64, "direct"),
        _ev(3, 1.0, "step", "g")], [_hist("tm_plan_build_seconds", 0.2, 1)])
    before, after = str(tmp_path / "before"), str(tmp_path / "after")
    for dd, wait in ((before, 0.1), (after, 0.7)):
        _write_dump(dd, "0", [
            _ev(0, 0.0, "step", "g"),
            _ev(1, 0.1, "eager", "allreduce", 64, "direct"),
            _ev(2, 0.1 + wait, "eager_done", "allreduce", 64, "direct"),
            _ev(3, 1.0, "step", "g")])
    port, jax_ = _tools("attribute", d, "--json")
    assert port.returncode == 0, port.stderr[-2000:]
    doc = json.loads(port.stdout)
    assert [b["host"] for b in doc["hosts"]] == ["0"]
    assert doc["aggregate"]["collective_wait"] == pytest.approx(0.4)
    assert port.stdout == jax_.stdout
    port, jax_ = _tools("attribute", d)
    assert port.returncode == 0 and "aggregate:" in port.stdout
    assert port.stdout == jax_.stdout
    port, jax_ = _tools("attribute", "--diff", before, after)
    assert "regressed phase: collective_wait" in port.stdout
    assert port.stdout == jax_.stdout
    port, jax_ = _tools("attribute", str(tmp_path / "empty_dir_missing"))
    assert port.returncode == jax_.returncode != 0


# ---------------------------------------------------------------------------
# A real port run
# ---------------------------------------------------------------------------


def test_attribution_on_real_training_dump(tmp_path):
    """Four rank-major data-parallel steps (4 ranks, the ring's plain
    versions) under obs "metrics": 4 step markers give 3 windows, every
    phase sum the window, and both tools print the same budget."""
    from torchmpi_tpu_torch import obs
    from torchmpi_tpu_torch.parallel import gradsync

    with module_group():
        tmpi.init(tmpi.Config(obs="metrics", obs_dir=str(tmp_path)),
                  device="cpu")
        try:
            obs.reset()
            g = torch.Generator().manual_seed(0)
            model = torch.nn.Sequential(torch.nn.Linear(6, 8),
                                        torch.nn.Tanh(),
                                        torch.nn.Linear(8, 2))
            for p in model.parameters():
                with torch.no_grad():
                    p.copy_(torch.randn(p.shape, generator=g))
            step = gradsync.data_parallel_step_rank_major(
                model, torch.optim.SGD(model.parameters(), lr=0.1),
                lambda m, x, y: ((m(x) - y) ** 2).mean(), 4,
                backend="pallas")
            x = torch.randn(8, 6, generator=g)
            y = torch.randn(8, 2, generator=g)
            for _ in range(4):
                step(x, y)
            reg = obs.registry()
            assert reg.counter("tm_step_builds_total",
                               label="data_parallel_step") == 1
            assert reg.counter_total("tm_gradsync_rounds_total") == 4
            assert reg.counter_total("tm_collectives_total") == 4
            obs.dump(str(tmp_path))
        finally:
            obs.deactivate()
            obs.reset()
            tmpi.stop()
    port, jax_ = _tools("attribute", str(tmp_path), "--json")
    assert port.returncode == 0, port.stderr[-2000:]
    doc = json.loads(port.stdout)
    b = doc["hosts"][0]
    assert b["steps"] == 3 and b["wall_s"] > 0
    assert sum(doc["aggregate"].values()) == pytest.approx(1.0)
    assert port.stdout == jax_.stdout
