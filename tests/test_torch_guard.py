"""The port's guard (torchmpi_tpu_torch/guard.py and the wire-guard sites)
against the JAX package's on the CPU: JAX's tests/test_guard.py, its 23
cases, each run through both packages on the same numpy inputs made from
a seed.  The wire guard: ``corrupt_silent`` diverges with the guard off
and heals bit-identically with ``guard="wire"`` (the staged legs, the
async staged worker, the PS push), its ``tm_guard_*`` evidence and the
plans' ``guard`` field.  The numeric tripwire: the verdicts and the
zeroed outputs of ``synchronize_gradients`` (a rank-major stack of 8 rows
holding the JAX mesh's replicated gradients), the norm bound, the
deferred ``raise``, the ZeRO shard leg, the error-feedback residuals
reverted, the overlap buckets.  The rewind: the detector, ``run_guarded``'s
``info`` and final state against JAX's on the same step function, the
quarantine, the budget.  And the plumbing (the flight tail, the health
snapshot) and, in a subprocess, the off mode: nothing of the guard, the
elastic layer, the board or the launcher imported, a DP step's plans at
``guard=False``."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import faults as jfaults
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import faults as tfaults
from torchmpi_tpu_torch.faults import inject as finject
from torchmpi_tpu_torch.faults import policy as fpolicy

from _torch_world import module_group

torch.set_num_threads(2)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.arange(32, dtype=np.float32).reshape(8, 4)
N = 8  # the JAX flat mesh's devices = the port's rank-major rows


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


def _reset_all():
    for name in ("torchmpi_tpu_torch.faults", "torchmpi_tpu.faults"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.reset()
    for name in ("torchmpi_tpu_torch.guard", "torchmpi_tpu.guard"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.reset_stats()
    tmpi.stop()
    jmpi.stop()


@pytest.fixture(autouse=True)
def fresh():
    _reset_all()
    yield
    _reset_all()


def _write_plan(path, rules, seed=7):
    with open(path, "w") as f:
        json.dump({"version": finject.FAULT_PLAN_VERSION, "seed": seed,
                   "rules": rules}, f)
    return str(path)


@pytest.fixture()
def guard_runtime(tmp_path):
    """Callable fixture: arm the port's runtime (CPU, a world of one) and
    JAX's flat 8-device one with the same guard (and plan)."""
    counter = [0]

    def arm(rules=None, *, guard="wire", seed=7, jax_side=True, **cfg_kw):
        counter[0] += 1
        kw = dict(guard=guard, fault_backoff_s=0.01)
        if rules is not None:
            kw["faults"] = _write_plan(tmp_path / f"plan{counter[0]}.json",
                                       rules, seed=seed)
        kw.update(cfg_kw)
        tmpi.stop()
        tmpi.init(device="cpu", **kw)
        if jax_side:
            jmpi.stop()
            jkw = dict(kw)
            jkw.setdefault("dcn_size", 1)
            jmpi.init(jmpi.Config(**jkw))

    return arm


def _clean_staged(x=X):
    tmpi.stop()
    tmpi.init(device="cpu")
    out = tmpi.allreduce_rank_major(torch.from_numpy(x), backend="host")
    tmpi.stop()
    return out


def _both_allreduce(x=X):
    got = tmpi.allreduce_rank_major(torch.from_numpy(x), backend="host")
    return got, np.asarray(jmpi.allreduce(x, backend="host"))


# ---------------------------------------------------------------------------
# Config plumbing
# ---------------------------------------------------------------------------


def test_guard_config_normalization_env_and_validation(monkeypatch):
    import importlib

    from torchmpi_tpu import runtime as jrt

    tcfg = importlib.import_module("torchmpi_tpu_torch.config")

    for v in ("on", "1", "wire", "numeric", "full", "off", "", "banana"):
        assert tcfg.normalize_guard(v) == jrt._normalize_guard(v)
    for v in ("skip", "skip_step", "raise", "explode"):
        assert tcfg.normalize_guard_policy(v) == \
            jrt._normalize_guard_policy(v)
    tmpi.init(device="cpu", guard="on")
    assert tmpi.config().guard == "full"
    tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_GUARD", "wire")
    monkeypatch.setenv("TORCHMPI_TPU_GUARD_NORM_BOUND", "5.5")
    tmpi.init(tmpi.Config(dcn_size=1), device="cpu")
    assert tmpi.config().guard == "wire"
    assert tmpi.config().guard_norm_bound == 5.5
    with pytest.raises(ValueError, match="guard"):
        tmpi.set_config(guard="sideways")
    with pytest.raises(ValueError, match="guard_numeric_policy"):
        tmpi.set_config(guard_numeric_policy="explode")
    with pytest.raises(ValueError):
        tmpi.set_config(guard_norm_bound=-1)
    with pytest.raises(ValueError):
        tmpi.set_config(guard_spike_window=1)
    tmpi.set_config(guard="numeric", guard_numeric_policy="raise")
    assert tmpi.config().guard == "numeric"
    tmpi.stop()
    monkeypatch.delenv("TORCHMPI_TPU_GUARD")
    with pytest.raises(ValueError, match="guard"):
        tmpi.init(tmpi.Config(guard="banana"), device="cpu")


# ---------------------------------------------------------------------------
# The wire guard: the host-staged path
# ---------------------------------------------------------------------------


def test_corrupt_silent_diverges_without_guard(guard_runtime):
    clean = _clean_staged()
    guard_runtime([{"site": "host_staged.gather", "kind": "corrupt_silent",
                    "max_hits": 1}], guard="off", fault_retries=2)
    got, jgot = _both_allreduce()
    assert not torch.equal(got, clean), "corruption must propagate"
    assert got.numpy().tobytes() == jgot.tobytes()  # the same flipped bits
    assert tfaults.plan().arrivals("host_staged.gather") == 1
    assert jfaults.plan().arrivals("host_staged.gather") == 1
    assert "torchmpi_tpu_torch.guard" not in sys.modules


@pytest.mark.parametrize("leg", ["host_staged.gather",
                                 "host_staged.scatter"])
def test_corrupt_silent_healed_with_wire_guard(guard_runtime, leg):
    clean = _clean_staged()
    guard_runtime([{"site": leg, "kind": "corrupt_silent", "max_hits": 1}])
    got, jgot = _both_allreduce()
    assert torch.equal(got, clean)
    assert got.numpy().tobytes() == jgot.tobytes()
    assert tfaults.plan().arrivals(leg) == jfaults.plan().arrivals(leg) >= 2
    h = tfaults.ledger().get("gang")
    assert h is not None and h.total_failures >= 1
    assert h.state == "healthy"


def test_wire_guard_counters_flight_and_latency(guard_runtime, tmp_path):
    guard_runtime([{"site": "host_staged.gather", "kind": "corrupt_silent",
                    "max_hits": 1}], obs="metrics",
                  obs_dir=str(tmp_path / "obs"), jax_side=False)
    from torchmpi_tpu_torch import obs

    obs.reset()
    try:
        tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
        reg = obs.registry()
        assert reg.counter("tm_guard_verify_failed_total",
                           site="host_staged.gather", peer="gang") == 1
        assert reg.counter_total("tm_guard_healed_total") == 1
        assert reg.counter_total("tm_guard_verified_total") >= 2
        hists = [r for r in reg.snapshot() if r["kind"] == "hist"
                 and r["name"] == "tm_guard_verify_us"]
        assert hists and {h["labels"]["site"] for h in hists} >= {
            "host_staged.gather"}
        ev = [e for e in obs.recorder().events() if e[2] == "guard"]
        assert any(e[6] == "verify_failed" for e in ev)
        assert any(e[5] for e in ev)  # the digest in the backend slot
    finally:
        obs.deactivate()
        obs.reset()


def test_wire_guard_async_staged_heals(guard_runtime):
    clean = _clean_staged()
    guard_runtime([{"site": "host_staged.gather", "kind": "corrupt_silent",
                    "max_hits": 1}])
    x = torch.from_numpy(X.copy()).clone()
    got = tmpi.async_.allreduce(x, backend="host", donate=True).wait()
    assert torch.equal(got, clean)
    assert x.untyped_storage().size() == 0
    assert tfaults.plan().arrivals("host_staged.gather") >= 2
    import jax

    jgot = np.asarray(jmpi.async_.allreduce(jax.device_put(X),
                                            backend="host",
                                            donate=True).wait())
    assert got.numpy().tobytes() == jgot.tobytes()


def test_wire_guard_planned_into_collective_plan(guard_runtime):
    from torchmpi_tpu_torch import planner

    guard_runtime(None, guard="wire", jax_side=False)
    tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
    rows = [r for r in planner.describe() if r["kind"] == "eager-staged"]
    assert rows and all(r["guard"] for r in rows)
    tmpi.set_config(guard="off")
    tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
    rows = [r for r in planner.describe() if r["kind"] == "eager-staged"]
    assert rows and not any(r["guard"] for r in rows)


# ---------------------------------------------------------------------------
# The wire guard: the PS exchange
# ---------------------------------------------------------------------------


def _ps_round(mpi_mod, n=64, push=1.0):
    ps = mpi_mod.parameterserver.init({"w": np.zeros(n, np.float32)},
                                      num_shards=2)
    try:
        ps.send({"w": np.full(n, push, np.float32)}, rule="add").wait()
        got = ps.receive().wait()
        return np.asarray(got["w"]).copy()
    finally:
        ps.shutdown()


def test_ps_corrupt_silent_diverges_without_guard(guard_runtime):
    guard_runtime([{"site": "ps.request", "kind": "corrupt_silent",
                    "after": 1, "max_hits": 1}], guard="off")
    got, jgot = _ps_round(tmpi), _ps_round(jmpi)
    assert not np.array_equal(got, np.ones(64, np.float32))
    assert got.tobytes() == jgot.tobytes()


def test_ps_corrupt_silent_healed_with_wire_guard(guard_runtime):
    guard_runtime([{"site": "ps.request", "kind": "corrupt_silent",
                    "after": 1, "max_hits": 1}])
    got, jgot = _ps_round(tmpi), _ps_round(jmpi)
    np.testing.assert_array_equal(got, np.ones(64, np.float32))
    np.testing.assert_array_equal(jgot, got)
    assert any(h.total_failures >= 1 for h in tfaults.ledger().peers())


def test_ps_wire_guard_without_fault_plan(guard_runtime):
    guard_runtime(None, guard="wire")
    got = _ps_round(tmpi, 32, 2.0)
    np.testing.assert_array_equal(got, np.full(32, 2.0, np.float32))
    np.testing.assert_array_equal(_ps_round(jmpi, 32, 2.0), got)
    assert "torchmpi_tpu_torch.faults.integrity" in sys.modules


# ---------------------------------------------------------------------------
# The numeric tripwire
# ---------------------------------------------------------------------------


def _jax_sync():
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from torchmpi_tpu.parallel import gradsync

    mesh = jmpi.runtime.world_mesh()
    axes = mesh.axis_names
    f = jax.jit(shard_map(
        lambda g: gradsync.synchronize_gradients(g, axes),
        mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False))
    return lambda tree: {k: np.asarray(v) for k, v in f(tree).items()}


def _port_sync(tree):
    """The port's rank-major sync of a replicated tree (every row the
    tree, as every JAX device holds it); row 0 of each result, and the
    check that every row came out the same."""
    stacks = {k: torch.from_numpy(np.stack([np.asarray(v)] * N))
              for k, v in tree.items()}
    tmpi.parallel.gradsync.synchronize_gradients_rank_major(
        list(stacks.values()))
    for st in stacks.values():
        assert all(torch.equal(st[0], st[r]) for r in range(N))
    return {k: st[0].numpy() for k, st in stacks.items()}


def test_numeric_tripwire_skip_step_and_bitwise(guard_runtime):
    from torchmpi_tpu_torch import guard

    rng = np.random.RandomState(0)
    grads = {"a": rng.randn(2, 8).astype(np.float32),
             "b": rng.randn(4).astype(np.float32)}
    guard_runtime(None, guard="off")
    base = _port_sync(grads)
    guard_runtime(None, guard="numeric")
    jsync = _jax_sync()
    ok = _port_sync(grads)
    jok = jsync(grads)
    for k in base:
        np.testing.assert_array_equal(base[k], ok[k])
        np.testing.assert_array_equal(ok[k], jok[k])
    bad = {"a": grads["a"].copy(), "b": grads["b"]}
    bad["a"][0, 0] = np.nan
    z, jz = _port_sync(bad), jsync(bad)
    for k in z:
        assert np.all(z[k] == 0) and np.all(jz[k] == 0)
    st = guard.stats()
    assert st["numeric_trips"] == 1 and st["skipped_steps"] == 1
    assert st == dict(guard.stats(), rewinds=0)  # drained once


def test_numeric_tripwire_norm_bound(guard_runtime):
    guard_runtime(None, guard="numeric", guard_norm_bound=1.0)
    jsync = _jax_sync()
    big = {"w": np.full((8,), 10.0, np.float32)}
    small = {"w": np.full((8,), 0.01, np.float32)}
    z, jz = _port_sync(big), jsync(big)
    assert np.all(z["w"] == 0) and np.all(jz["w"] == 0)
    out, jout = _port_sync(small), jsync(small)
    assert np.all(out["w"] != 0)
    np.testing.assert_array_equal(out["w"], jout["w"])


def test_numeric_raise_policy_defers_typed_error(guard_runtime):
    from torchmpi_tpu import guard as jguard
    from torchmpi_tpu_torch import guard

    guard_runtime(None, guard="numeric", guard_numeric_policy="raise")
    jsync = _jax_sync()
    bad = {"w": np.full((8,), np.inf, np.float32)}
    z = _port_sync(bad)
    jz = jsync(bad)
    assert np.all(z["w"] == 0) and np.all(jz["w"] == 0)
    assert guard.pending() == 1 and jguard.pending() >= 1
    errs = []
    for g in (guard, jguard):
        with pytest.raises(g.NumericAnomalyError) as ei:
            g.raise_pending()
        errs.append(ei.value)
    assert errs[0].site == errs[1].site == "gradsync"
    assert errs[0].stat == np.inf and guard.pending() == 0
    out = _port_sync({"w": np.ones(8, np.float32)})
    assert np.isfinite(out["w"]).all()
    guard.raise_pending()  # nothing pending: no-op


def test_numeric_tripwire_zero_shard_leg(guard_runtime):
    from torchmpi_tpu_torch.parallel import zero

    guard_runtime(None, guard="numeric", jax_side=False)
    params = [torch.ones(8, 4)]
    tx = tmpi.optim.sgd(0.1)
    spec = zero.flat_spec(params, n_shards=N)
    opt = zero.init_rank_major(params, tx, N)
    flats = [torch.full((N, g.padded), float("nan")) for g in spec.groups]
    new, _ = zero.update_rank_major(params, flats, opt, tx)
    assert torch.equal(new[0], params[0])  # every shard zeroed
    # One rank's NaN lands in one shard only: that shard's update is
    # skipped, the others apply (each shard checks its own update).
    flats = [torch.ones(N, g.padded) for g in spec.groups]
    flats[0][3, 5] = float("nan")
    new, _ = zero.update_rank_major(params, flats, opt, tx)
    shard = spec.shard
    got = new[0].reshape(-1)
    assert torch.equal(got[:shard], torch.full((shard,), 0.9))
    hit = 5 // shard
    assert torch.equal(got[hit * shard:(hit + 1) * shard],
                       torch.ones(shard))


def test_numeric_trip_reverts_ef_residuals(guard_runtime):
    """The residuals of a tripped round are the pre-step ones bit for bit
    (a rank-major grid dcn 2 x ici 4, int8 codec); the clean round's
    residuals and synced gradients against JAX's on the same inputs."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from torchmpi_tpu.parallel import gradsync as jgs
    from torchmpi_tpu_torch.parallel import gradsync

    cfg = dict(guard="numeric", dcn_size=2, dcn_compress="int8",
               dcn_compress_min_bytes=0)
    guard_runtime(None, **cfg)
    params = [torch.zeros(64, 8)]
    res0 = gradsync.init_dcn_residuals(params, ("dcn", "ici"), n=N)
    g = np.random.RandomState(3).randn(64, 8).astype(np.float32)
    g1 = [torch.from_numpy(np.stack([g] * N))]
    _, res1 = gradsync.synchronize_gradients_rank_major(g1, residuals=res0)
    assert any(float(r.abs().max()) > 0 for r in res1)
    bad = [torch.full((N, 64, 8), float("nan"))]
    _, res2 = gradsync.synchronize_gradients_rank_major(bad,
                                                        residuals=res1)
    assert torch.all(bad[0] == 0)
    for a, b in zip(res2, res1):
        assert torch.equal(a, b)
    mesh = jmpi.runtime.world_mesh()
    axes = ("dcn", "ici")
    jparams = {"w": np.zeros((64, 8), np.float32)}
    jres0 = jgs.init_dcn_residuals(jparams, axes, mesh=mesh)
    sync = jax.jit(shard_map(
        lambda g, r: jgs.synchronize_gradients(g, axes, residuals=r),
        mesh=mesh, in_specs=(P(), P(axes)), out_specs=(P(), P(axes)),
        check_vma=False))
    jg1, jres1 = sync({"w": g}, jres0)
    # One int8 quantum apart at most (the codecs differ by ulps, ROADMAP
    # queue C note 19).
    quantum = float(np.abs(g).max()) * 2 / 127
    np.testing.assert_allclose(g1[0][0].numpy(), np.asarray(jg1["w"]),
                               rtol=0, atol=quantum)
    assert res1[0].shape == tuple(np.asarray(jres1[0]).shape)
    _, jres2 = sync({"w": np.full((64, 8), np.nan, np.float32)}, jres1)
    np.testing.assert_array_equal(np.asarray(jres2[0]),
                                  np.asarray(jres1[0]))


def test_numeric_tripwire_overlap_buckets(guard_runtime):
    from torchmpi_tpu_torch import guard
    from torchmpi_tpu_torch.parallel import gradsync

    guard_runtime(None, guard="numeric", jax_side=False)
    params = [torch.ones(16), torch.ones(16)]

    def loss_fn(p, x):
        return torch.sum(p[0] * x) + torch.sum(p[1] * x)

    vag = gradsync.make_overlapped_grad_fn_rank_major(loss_fn, params, N,
                                                      max_bytes=64)
    _, grads = vag(params, torch.full((N, 16), float("nan")))
    assert all(torch.all(g == 0) for g in grads)
    assert guard.stats()["numeric_trips"] >= 1
    _, grads = vag(params, torch.ones(N, 16))
    assert all(torch.all(g == 1.0) for g in grads)
    # The process world's form: one rank, the same verdicts.
    vag1 = gradsync.make_overlapped_grad_fn(loss_fn, params, max_bytes=64)
    _, g1 = vag1(params, torch.full((16,), float("nan")))
    assert all(torch.all(g == 0) for g in g1)


# ---------------------------------------------------------------------------
# The loss-spike detector and the agreed rewind
# ---------------------------------------------------------------------------


def test_loss_spike_detector_unit(guard_runtime):
    from torchmpi_tpu import guard as jguard
    from torchmpi_tpu_torch import guard

    guard_runtime(None, guard="full")
    rng = np.random.RandomState(0)
    seq = ([1.0 + 0.02 * rng.randn() for _ in range(8)]
           + [50.0, 1.01, float("nan"), float("inf")])
    dets = [g.LossSpikeDetector(window=8, threshold=6.0, min_history=4)
            for g in (guard, jguard)]
    verdicts = [[d.update(v) for v in seq] for d in dets]
    assert verdicts[0] == verdicts[1] == [False] * 8 + [True, False, True,
                                                        True]
    with pytest.raises(ValueError):
        guard.LossSpikeDetector(window=1)


def _rewind_init():
    return {"w": np.zeros((4,), np.float32),
            "losses": np.full((12,), np.nan, np.float32)}


def _rewind_step(poison_at, armed):
    def step(state, i):
        w = state["w"] + np.float32(i + 1)
        loss = 1.0 / (i + 1)
        if poison_at is not None and i == poison_at and armed[0]:
            armed[0] = False  # one-shot: the replay is clean
            w = w + np.float32(1e6)
            loss = 1e9
        losses = np.array(state["losses"])
        losses[i] = loss
        return {"w": w, "losses": losses}, loss

    return step


def test_rewind_bit_identical_plans_and_epoch_untouched(guard_runtime,
                                                        tmp_path):
    from torchmpi_tpu import guard as jguard
    from torchmpi_tpu_torch import guard, planner, runtime
    from torchmpi_tpu_torch.faults import membership

    guard_runtime(None, guard="full")
    epoch0 = runtime.config_epoch()
    misses0 = planner.stats()["misses"]
    runs = {}
    for name, g in (("torch", guard), ("jax", jguard)):
        d = str(tmp_path / name)
        runs[name] = g.run_guarded(
            _rewind_init, _rewind_step(7, [True]), steps=12, directory=d,
            save_every=3, detector=g.LossSpikeDetector(
                window=8, threshold=6.0, min_history=3))
    (final, info), (jfinal, jinfo) = runs["torch"], runs["jax"]
    assert info == jinfo
    assert info["rewinds"] == 1 and info["trip_steps"] == [7]
    assert info["recovered_step"] == 6
    assert runtime.config_epoch() == epoch0
    assert planner.stats()["misses"] == misses0
    recs = membership.Board(str(tmp_path / "torch" / "membership")
                            ).rewind_records()
    jrecs = membership.Board(str(tmp_path / "jax" / "membership")
                             ).rewind_records()
    assert recs and recs[0]["step"] == 7
    assert [{k: v for k, v in r.items() if k != "ts"} for r in recs] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in jrecs]
    assert guard.stats()["rewinds"] == 1
    clean, cinfo = guard.run_guarded(
        _rewind_init, _rewind_step(None, [False]), steps=12,
        directory=str(tmp_path / "clean"), save_every=3,
        detector=guard.LossSpikeDetector(window=8, threshold=6.0,
                                         min_history=3))
    assert cinfo["rewinds"] == 0
    for k in ("w", "losses"):
        np.testing.assert_array_equal(final[k], clean[k])
        np.testing.assert_array_equal(final[k], jfinal[k])


def test_rewind_quarantines_implicated_peer(guard_runtime, tmp_path):
    from torchmpi_tpu_torch import guard
    from torchmpi_tpu_torch.faults import membership

    guard_runtime(None, guard="full", faults="policy", jax_side=False)
    armed = [True]

    def step(state, i):
        loss = 1.0
        if i == 6 and armed[0]:
            armed[0] = False
            loss = float("nan")
        return {"w": state["w"] + 1}, loss

    _, info = guard.run_guarded(
        lambda: {"w": np.zeros((2,), np.float32)}, step, steps=10,
        directory=str(tmp_path), save_every=2, implicate="member:3")
    assert info["rewinds"] == 1
    assert tfaults.ledger().decide("member:3") == "raise"
    rec = membership.Board(os.path.join(str(tmp_path), "membership")
                           ).rewind_records()[0]
    assert rec["peer"] == "member:3" and rec["quarantined"] is True
    tmpi.set_config(faults="off")
    assert guard.quarantine("member:9") is False


def test_rewind_budget_exhausts_on_recurring_spike(guard_runtime,
                                                   tmp_path):
    from torchmpi_tpu import guard as jguard
    from torchmpi_tpu_torch import guard

    guard_runtime(None, guard="full")

    def step(state, i):
        return {"w": state["w"] + 1}, (float("nan") if i == 4 else 1.0)

    msgs = []
    for name, g in (("torch", guard), ("jax", jguard)):
        with pytest.raises(g.NumericAnomalyError, match="budget") as ei:
            g.run_guarded(lambda: {"w": np.zeros((2,), np.float32)}, step,
                          steps=8, directory=str(tmp_path / name),
                          save_every=2, max_rewinds=2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_run_guarded_requires_opt_in(tmp_path):
    tmpi.init(device="cpu")
    from torchmpi_tpu_torch import guard

    with pytest.raises(RuntimeError, match="guard"):
        guard.run_guarded(lambda: {}, lambda s, i: (s, 0.0), steps=1,
                          directory=str(tmp_path))


# ---------------------------------------------------------------------------
# The chaos tool, and the plumbing the guard depends on
# ---------------------------------------------------------------------------


def test_chaos_tool_corrupt_silent_and_guard_summary(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    out = tmp_path / "plan.json"
    assert tool.main(["gen", "--out", str(out), "--seed", "5",
                      "--rule", "host_staged.*:corrupt_silent:1.0:2"]) == 0
    plan = finject.FaultPlan.load(str(out))
    assert plan.rules[0].kind == "corrupt_silent"
    assert tool.main(["lint", str(out)]) == 0
    bad = tmp_path / "bad.json"
    _write_plan(bad, [{"site": "elastic.member", "kind": "corrupt_silent"}])
    assert tool.main(["lint", str(bad)]) == 1
    assert "no payload" in capsys.readouterr().out
    m = tmp_path / "metrics_host0.jsonl"
    with open(m, "w") as f:
        f.write(json.dumps({"kind": "counter",
                            "name": "tm_guard_verify_failed_total",
                            "labels": {"site": "host_staged.gather"},
                            "value": 2}) + "\n")
        f.write(json.dumps({"kind": "counter",
                            "name": "tm_guard_healed_total",
                            "labels": {"site": "host_staged"},
                            "value": 2}) + "\n")
    assert tool.main(["summarize", str(m)]) == 0
    text = capsys.readouterr().out
    assert "tm_guard_verify_failed_total" in text
    assert "guard_healed=2" in text


def test_peer_timeout_flight_tail_contents(guard_runtime, tmp_path):
    guard_runtime(None, guard="off", obs="metrics",
                  obs_dir=str(tmp_path / "obs"), jax_side=False)
    from torchmpi_tpu_torch import obs

    obs.reset()
    try:
        for _ in range(3):
            tmpi.barrier()

        def attempt(i):
            raise finject.DroppedPacket("silence")

        with pytest.raises(fpolicy.PeerTimeoutError) as ei:
            fpolicy.run("s", attempt, peer="p0",
                        policy=fpolicy.Policy(retries=0, deadline_s=5.0))
        tail = ei.value.flight_tail
        assert tail and len(tail) <= 8
        for rec in tail:
            assert {"seq", "ev", "op"} <= set(rec)
        want = obs.recorder().to_records()[-len(tail):]
        assert [r["seq"] for r in tail] == [r["seq"] for r in want]
        assert tail[-1]["ev"] == "barrier_done"
        assert f"last flight event #{tail[-1]['seq']}" in str(ei.value)
    finally:
        obs.deactivate()
        obs.reset()


def test_health_snapshot_roundtrip_under_concurrent_checkpoint(
        guard_runtime, tmp_path):
    from torchmpi_tpu_torch.utils import checkpoint, restart

    guard_runtime(None, guard="off", faults="policy", jax_side=False)
    led = tfaults.ledger()
    led.clear()
    led.record("flaky:7", ok=False)
    led.record("flaky:7", ok=False)
    d = str(tmp_path)
    state = {"w": torch.arange(64, dtype=torch.float32)}
    stop = threading.Event()
    errors = []

    def writer():
        step = 0
        while not stop.is_set():
            step += 1
            try:
                checkpoint.save(d, state, step=step)
            except Exception as e:  # noqa: BLE001 — failure IS the test
                errors.append(e)

    th = threading.Thread(target=writer)
    th.start()
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.0:
            restart._save_health(d)
            restart._load_health(d)
    finally:
        stop.set()
        th.join()
    assert not errors
    assert led.get("flaky:7").consecutive_failures == 2
    with open(os.path.join(d, "health_p0.json"), "w") as f:
        f.write('{"suspect_after": 2, "peers": [{"pe')
    restart._load_health(d)
    assert led.get("flaky:7").consecutive_failures == 2


# ---------------------------------------------------------------------------
# The off mode, in a subprocess
# ---------------------------------------------------------------------------

_OFF_PROBE = textwrap.dedent("""
    import sys
    import torch
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import planner
    from torchmpi_tpu_torch.parallel import gradsync
    mpi.init(device="cpu")
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = gradsync.data_parallel_step_rank_major(
        model, opt, lambda m, x: m(x).square().mean(), 4)
    step(torch.ones(8, 4))
    step = gradsync.data_parallel_step(
        model, opt, lambda m, x: m(x).square().mean())
    step(torch.ones(2, 4))
    mpi.allreduce_rank_major(torch.ones(4, 3), backend="host")
    rows = planner.describe()
    assert rows and not any(r["guard"] for r in rows), rows
    bad = [m for m in sys.modules if m in (
        'torchmpi_tpu_torch.guard', 'torchmpi_tpu_torch.elastic',
        'torchmpi_tpu_torch.faults.membership', 'torchmpi_tpu_torch.launch',
        'torchmpi_tpu_torch.faults.integrity')]
    assert not bad, bad
    assert 'torchmpi_tpu' not in sys.modules
    mpi.stop()
    print('OFF-MODE-OK', len(rows))
""").replace("REPO", repr(_REPO))


def test_off_mode_never_imports_guard_or_elastic():
    """Every knob off (the defaults): ``import torchmpi_tpu_torch`` and a
    DP step (rank-major and process world) and a staged call import none
    of the guard, the elastic driver, the membership board, the launcher
    or the digests, and every plan they built carries ``guard=False``."""
    env = dict(os.environ)
    for k in ("TORCHMPI_TPU_GUARD", "TORCHMPI_TPU_ELASTIC",
              "TORCHMPI_TPU_FAULTS", "TORCHMPI_TPU_STAGED"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", _OFF_PROBE],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OFF-MODE-OK" in out.stdout
