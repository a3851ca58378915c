"""The port's fault injection and resilient dispatch
(torchmpi_tpu_torch/faults/) held to the JAX package's (tests/test_faults.py,
one case here for each case there but the restart driver's, which is
in tests/test_torch_restart.py).

The plan schema, the schedule and the policy are pure Python: the port's
copies are held to the JAX package's on the same inputs (the draw of
``decision`` bitwise on a grid, plans written by either package loaded by
the other, the backoffs, the lint messages, the chaos tool's files and
output).  The sites run the same plan through both packages where the JAX
package has the path: its staged verbs on its 8-device CPU mesh against the
port's rank-major staged verbs at n = 8, the barrier, the parameter server
and ``aio.submit``; outputs are compared bitwise and the fault events (each
fired decision's ``(site, arrival, kind)`` and each ``tm_fault_*`` action,
in order) one for one.  Deadlines stay at or under 0.5 s and backoffs at
0.01 s; every subprocess has a timeout.
"""

import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.faults import health as jhealth
from torchmpi_tpu.faults import inject as jinject
from torchmpi_tpu.faults import policy as jpolicy
from torchmpi_tpu_torch import collectives as tcoll
from torchmpi_tpu_torch.faults import health as fhealth
from torchmpi_tpu_torch.faults import inject as finject
from torchmpi_tpu_torch.faults import policy as fpolicy
from torchmpi_tpu_torch.faults import tool as ftool

jfaults = importlib.import_module("torchmpi_tpu.faults")
tfaults = importlib.import_module("torchmpi_tpu_torch.faults")

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.arange(32, dtype=np.float32).reshape(8, 4)


def _chaos_tool():
    spec = importlib.util.spec_from_file_location(
        "_chaos_tool_under_port_test",
        os.path.join(_REPO, "scripts", "chaos_tool.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_plan(path, rules, seed=7):
    with open(path, "w") as f:
        json.dump({"version": finject.FAULT_PLAN_VERSION, "seed": seed,
                   "rules": rules}, f)
    return str(path)


def _trace(fmod, monkeypatch):
    """The armed plan's fired decisions ``(site, arrival, kind,
    "injected")`` and every other ``tm_fault_*`` action ``(site, -1,
    kind, action)``, in order, for one package's fault layer."""
    events = []
    plan = fmod.plan()
    decide = plan.decide

    def traced(site):
        got = decide(site)
        if got is not None:
            events.append((site, got[1], got[0].kind, "injected"))
        return got

    plan.decide = traced
    emit = fmod._emit

    def traced_emit(action, site, *, kind="", peer=""):
        if action != "injected":
            events.append((site, -1, kind, action))
        emit(action, site, kind=kind, peer=peer)

    monkeypatch.setattr(fmod, "_emit", traced_emit)
    return events


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
    jfaults.reset()
    tfaults.reset()
    jmpi.stop()
    tmpi.stop()


@pytest.fixture()
def fault_runtime(tmp_path, monkeypatch):
    """Callable fixture: arm the port's runtime (CPU, a world of one) and,
    with ``jax_side``, the JAX package's flat 8-device runtime under the
    same rule list (a fresh plan file a call, so re-arming restarts the
    schedule).  Returns ``(port events, JAX events)``."""
    counter = [0]

    def arm(rules, seed=7, jax_side=True, **cfg_kw):
        counter[0] += 1
        plan = _write_plan(tmp_path / f"plan{counter[0]}.json", rules,
                           seed=seed)
        cfg_kw.setdefault("fault_backoff_s", 0.01)
        tmpi.stop()
        tmpi.init(device="cpu", faults=plan, **cfg_kw)
        ev = _trace(tfaults, monkeypatch)
        jev = None
        if jax_side:
            jmpi.stop()
            jmpi.init(jmpi.Config(dcn_size=1, faults=plan, **cfg_kw))
            jev = _trace(jfaults, monkeypatch)
        return ev, jev

    yield arm
    tfaults.reset()
    jfaults.reset()
    tmpi.stop()
    jmpi.stop()


def _clean(x=X):
    """The clean staged allreduce of ``x`` [8, ...] in the port."""
    tmpi.stop()
    tmpi.init(device="cpu")
    return tmpi.allreduce_rank_major(torch.from_numpy(x), backend="host")


def _both_allreduce(x=X):
    """The staged allreduce of ``x`` in each package: (port, JAX)."""
    got = tmpi.allreduce_rank_major(torch.from_numpy(x), backend="host")
    return got, np.asarray(jmpi.allreduce(x, backend="host"))


# ---------------------------------------------------------------------------
# Plan schema + deterministic schedule (pure python)
# ---------------------------------------------------------------------------


def test_plan_roundtrip(tmp_path):
    plan = finject.FaultPlan(seed=11, note="chaos", rules=[
        finject.FaultRule("ps.request", "drop", prob=0.5, after=2,
                          max_hits=3, delay_s=0.25),
        finject.FaultRule("host_staged.*", "corrupt"),
    ])
    path = plan.save(str(tmp_path / "plan.json"))
    back = finject.FaultPlan.load(path)
    assert back.seed == 11 and back.note == "chaos"
    assert back.rules == plan.rules
    # Either package's file loads in the other, byte for byte the same.
    jplan = jinject.FaultPlan(seed=11, note="chaos", rules=[
        jinject.FaultRule(**r.to_json()) for r in plan.rules])
    jpath = jplan.save(str(tmp_path / "jplan.json"))
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    assert [r.to_json() for r in jinject.FaultPlan.load(path).rules] == \
        [r.to_json() for r in finject.FaultPlan.load(jpath).rules]


def test_plan_version_and_schema_raise(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"version": 99, "rules": []}))
    with pytest.raises(ValueError, match="version"):
        finject.FaultPlan.load(str(p))
    p.write_text("not json")
    with pytest.raises(ValueError, match="not JSON"):
        finject.FaultPlan.load(str(p))
    for bad in [{"site": "x", "kind": "explode"},
                {"site": "x", "kind": "drop", "prob": 2.0},
                {"site": "x", "kind": "drop", "typo": 1},
                {"kind": "drop"}]:
        with pytest.raises((ValueError, TypeError)) as ours:
            finject.FaultRule.from_json(bad)
        with pytest.raises((ValueError, TypeError)) as theirs:
            jinject.FaultRule.from_json(bad)
        assert str(ours.value) == str(theirs.value)


def test_schedule_determinism():
    def fires(mod, seed, n=64):
        plan = mod.FaultPlan(seed=seed, rules=[
            mod.FaultRule("s", "drop", prob=0.5, max_hits=-1)])
        return [plan.decide("s") is not None for _ in range(n)]

    a = fires(finject, 3)
    assert a == fires(finject, 3), "same seed must give the same schedule"
    assert a != fires(finject, 4), "seed must actually key the schedule"
    assert 8 < sum(a) < 56, "prob=0.5 should fire roughly half the time"
    assert a == fires(jinject, 3)


def test_decision_bitwise_to_jax_on_a_grid():
    """The one pure function both schedules hang on, bit for bit over
    seeds, every site and arrival ordinals."""
    for seed in (0, 1, 7, 12345, 2 ** 40 + 3):
        for site in finject.SITES + ("corrupt", "s", "host_staged.*"):
            for hit in (0, 1, 2, 3, 17, 255, 4096, 10 ** 6):
                assert finject.decision(seed, site, hit) == \
                    jinject.decision(seed, site, hit)
    assert finject.SITES == jinject.SITES and finject.KINDS == jinject.KINDS
    assert finject.PAYLOAD_SITES == jinject.PAYLOAD_SITES
    assert finject.BOARD_SITES == jinject.BOARD_SITES


def test_schedule_after_and_max_hits():
    plan = finject.FaultPlan(seed=0, rules=[
        finject.FaultRule("s", "fail", after=2, max_hits=2)])
    got = [plan.decide("s") is not None for _ in range(8)]
    assert got == [False, False, True, True, False, False, False, False]
    plan.reset_schedule()
    assert [plan.decide("s") is not None for _ in range(3)] == \
        [False, False, True]


def test_glob_rule_max_hits_bounds_total_fires():
    plan = finject.FaultPlan(seed=0, rules=[
        finject.FaultRule("host_staged.*", "drop", max_hits=2)])
    fired = 0
    for _ in range(4):
        fired += plan.decide("host_staged.gather") is not None
        fired += plan.decide("host_staged.scatter") is not None
    assert fired == 2


def test_corrupt_buffer_flips_and_respects_readonly():
    buf = np.zeros(256, np.float32)
    finject.corrupt_buffer(buf, seed=1, hit=0)
    assert np.any(buf != 0), "writable buffer must actually corrupt"
    again = np.zeros(256, np.float32)
    finject.corrupt_buffer(again, seed=1, hit=0)
    np.testing.assert_array_equal(buf, again)  # deterministic corruption
    # The JAX package flips the same bits in numpy ...
    theirs = np.zeros(256, np.float32)
    jinject.corrupt_buffer(theirs, seed=1, hit=0)
    assert buf.tobytes() == theirs.tobytes()
    # ... as the port does in a CPU tensor, bfloat16 included.
    t = torch.zeros(256)
    finject.corrupt_buffer(t, seed=1, hit=0)
    assert t.numpy().tobytes() == theirs.tobytes()
    b16 = torch.zeros(512, dtype=torch.bfloat16)
    finject.corrupt_buffer(b16, seed=1, hit=0)
    assert b16.view(torch.uint8).numpy().tobytes() == theirs.tobytes()
    # Read-only input is refused: nothing written.
    ro = np.broadcast_to(np.zeros(4, np.float32), (8, 4))
    finject.corrupt_buffer(ro, seed=1, hit=0)  # must not raise
    assert not np.any(ro)
    strided = torch.zeros(8, 4).t()
    finject.corrupt_buffer(strided, seed=1, hit=0)
    assert not strided.any()


# ---------------------------------------------------------------------------
# Policy (pure python)
# ---------------------------------------------------------------------------


def test_backoff_deterministic_doubling_capped():
    pol = fpolicy.Policy(backoff_s=0.1, backoff_max_s=0.35, jitter=0.5,
                         seed=3)
    seq = [pol.backoff("site", i) for i in range(1, 6)]
    assert seq == [pol.backoff("site", i) for i in range(1, 6)]
    assert 0.1 <= seq[0] <= 0.15 and 0.2 <= seq[1] <= 0.3
    assert all(s <= 0.35 * 1.5 for s in seq)  # capped (plus jitter)
    jpol = jpolicy.Policy(backoff_s=0.1, backoff_max_s=0.35, jitter=0.5,
                          seed=3)
    assert seq == [jpol.backoff("site", i) for i in range(1, 6)]


def test_run_retry_then_succeed():
    calls = []
    events = []

    def attempt(i):
        calls.append(i)
        if i < 2:
            raise finject.TransientFault("flaky")
        return "ok"

    out = fpolicy.run("s", attempt,
                      policy=fpolicy.Policy(retries=3, backoff_s=0.001),
                      on_event=lambda a, s: events.append(a))
    assert out == "ok" and calls == [0, 1, 2]
    assert events == ["retry", "retry", "survived"]


def test_run_retries_exhausted():
    def attempt(i):
        raise finject.CorruptPayload("always corrupt")

    with pytest.raises(fpolicy.RetriesExhaustedError) as ei:
        fpolicy.run("s", attempt,
                    policy=fpolicy.Policy(retries=1, backoff_s=0.001))
    assert ei.value.attempts == 2
    assert isinstance(ei.value.last_error, finject.CorruptPayload)


def test_run_drop_without_retries_is_peer_timeout():
    def attempt(i):
        raise finject.DroppedPacket("silence")

    t0 = time.monotonic()
    with pytest.raises(fpolicy.PeerTimeoutError) as ei:
        fpolicy.run("s", attempt, peer="p0",
                    policy=fpolicy.Policy(retries=0, deadline_s=0.5))
    assert time.monotonic() - t0 < 0.5, "must fail within the deadline"
    assert ei.value.site == "s" and ei.value.peer == "p0"
    # ONE class: AsyncHandle.wait(timeout_s)'s is the policy's.
    assert fpolicy.PeerTimeoutError is tcoll.PeerTimeoutError
    assert tfaults.PeerTimeoutError is tmpi.PeerTimeoutError


def test_run_deadline_overrides_remaining_retries():
    def attempt(i):
        time.sleep(0.03)
        raise finject.TransientFault("slow flake")

    with pytest.raises(fpolicy.PeerTimeoutError):
        fpolicy.run("s", attempt,
                    policy=fpolicy.Policy(retries=100, backoff_s=0.001,
                                          deadline_s=0.05))


def test_run_nontransient_propagates_untouched():
    def attempt(i):
        raise finject.InjectedFailure("dead peer")

    with pytest.raises(finject.InjectedFailure):
        fpolicy.run("s", attempt, policy=fpolicy.Policy(retries=5))


def test_bounded_call_times_out_and_passes_through():
    assert fpolicy.bounded_call("s", lambda: 42, deadline_s=0.5) == 42
    with pytest.raises(fpolicy.PeerTimeoutError):
        fpolicy.bounded_call("s", lambda: time.sleep(0.5), deadline_s=0.05)
    with pytest.raises(KeyError):  # worker exceptions re-raise in caller
        fpolicy.bounded_call("s", lambda: {}["missing"], deadline_s=0.5)


def test_is_transient_classification():
    cases = [finject.DroppedPacket("x"), socket.timeout(),
             ConnectionResetError(), finject.InjectedFailure("x"),
             ValueError("x"), OSError(110, "t"), finject.CorruptPayload("x")]
    assert [fpolicy.is_transient(e) for e in cases[:5]] == \
        [True, True, True, False, False]
    # The JAX classification on the JAX package's own error classes.
    jcases = [jinject.DroppedPacket("x"), socket.timeout(),
              ConnectionResetError(), jinject.InjectedFailure("x"),
              ValueError("x"), OSError(110, "t"), jinject.CorruptPayload("x")]
    assert [fpolicy.is_transient(e) for e in cases] == \
        [jpolicy.is_transient(e) for e in jcases]
    assert [fpolicy.is_timeoutish(e) for e in cases] == \
        [jpolicy.is_timeoutish(e) for e in jcases]


# ---------------------------------------------------------------------------
# Health ledger (pure python)
# ---------------------------------------------------------------------------


def test_health_ledger_thresholds_and_decide():
    seen = []
    led = fhealth.HealthLedger(suspect_after=2, dead_after=4,
                               on_transition=lambda p, o, n: seen.append(
                                   (p, o, n)))
    assert led.decide("a") == "ok"
    assert led.record("a", ok=False) == "healthy"
    assert led.record("a", ok=False) == "suspect"
    assert led.decide("a") == "degrade"
    led.record("a", ok=False)
    assert led.record("a", ok=False) == "dead"
    assert led.decide("a") == "raise"
    assert led.record("a", ok=True) == "healthy"
    assert led.decide("a") == "ok"
    assert seen == [("a", "healthy", "suspect"), ("a", "suspect", "dead"),
                    ("a", "dead", "healthy")]
    h = led.get("a")
    assert h.total_failures == 4 and h.total_successes == 1
    with pytest.raises(ValueError):
        fhealth.HealthLedger(suspect_after=5, dead_after=2)


def test_health_ledger_edge_transitions():
    seen = []
    led = fhealth.HealthLedger(suspect_after=1, dead_after=3,
                               on_transition=lambda p, o, n: seen.append(
                                   (o, n)))
    assert led.record("a", ok=False) == "suspect"
    assert led.record("a", ok=True) == "healthy"
    h = led.get("a")
    assert h.consecutive_failures == 0 and h.total_failures == 1
    for _ in range(3):
        led.record("a", ok=False)
    assert led.state("a") == "dead"
    n_seen = len(seen)
    assert led.record("a", ok=False) == "dead"
    assert len(seen) == n_seen
    assert seen == [("healthy", "suspect"), ("suspect", "healthy"),
                    ("healthy", "suspect"), ("suspect", "dead")]
    assert led.state("zzz") == "healthy" and led.get("zzz") is None


def test_health_ledger_concurrent_site_failures():
    import threading

    led = fhealth.HealthLedger(suspect_after=2, dead_after=4)
    n_threads, per = 4, 25

    def hammer():
        for _ in range(per):
            led.record("p", ok=False)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    h = led.get("p")
    assert h.total_failures == n_threads * per
    assert h.consecutive_failures == n_threads * per
    assert led.decide("p") == "raise"


def test_health_ledger_snapshot_roundtrip():
    led = fhealth.HealthLedger(suspect_after=2, dead_after=4)
    for _ in range(4):
        led.record("dead-peer", ok=False)
    led.record("fine-peer", ok=True)
    led.record("iffy-peer", ok=False)
    led.record("iffy-peer", ok=False)
    snap = led.to_dict()
    assert snap["suspect_after"] == 2 and snap["dead_after"] == 4
    # The JAX ledger writes the same snapshot on the same history.
    jled = jhealth.HealthLedger(suspect_after=2, dead_after=4)
    for peer, ok, k in (("dead-peer", False, 4), ("fine-peer", True, 1),
                        ("iffy-peer", False, 2)):
        for _ in range(k):
            jled.record(peer, ok=ok)
    assert jled.to_dict() == snap
    led2 = fhealth.HealthLedger.from_dict(snap)
    assert led2.state("dead-peer") == "dead"
    assert led2.decide("iffy-peer") == "degrade"
    assert led2.get("fine-peer").total_successes == 1
    fired = []
    led3 = fhealth.HealthLedger(suspect_after=1, dead_after=2,
                                on_transition=lambda *a: fired.append(a))
    led3.restore(snap)
    assert fired == []
    assert led3.state("iffy-peer") == "dead"
    with pytest.raises(ValueError):
        led3.restore({"peers": "nope"})
    with pytest.raises(ValueError):
        led3.restore({"peers": [{"no_peer_key": 1}]})


def test_dead_peer_ping_reprobe(fault_runtime):
    fault_runtime([], jax_side=False)  # armed, nothing injected
    ps = tmpi.parameterserver.init({"w": np.zeros(8, np.float32)},
                                   num_shards=1)
    try:
        peer = ps.client.peers[0]
        led = tfaults.ledger()
        for _ in range(led.dead_after):
            led.record(peer, ok=False)
        assert led.decide(peer) == "raise"
        assert ps.client.ping() == [True]
        assert led.decide(peer) == "ok"  # one success resurrects
    finally:
        ps.shutdown()


# ---------------------------------------------------------------------------
# The sites: the same plan through both packages
# ---------------------------------------------------------------------------


def test_host_staged_drop_retried_bit_identical(fault_runtime):
    clean = _clean()
    ev, jev = fault_runtime([{"site": "host_staged.gather", "kind": "drop",
                              "max_hits": 1}])
    got, jgot = _both_allreduce()
    assert torch.equal(got, clean)
    assert got.numpy().tobytes() == jgot.tobytes()
    assert tfaults.plan().arrivals("host_staged.gather") == 2  # retried
    assert ev == jev and ev[0] == ("host_staged.gather", 0, "drop",
                                   "injected")


def test_host_staged_corrupt_then_heal_bit_identical(fault_runtime):
    clean = _clean()
    ev, jev = fault_runtime([{"site": "host_staged.*", "kind": "corrupt",
                              "max_hits": 2, "prob": 0.7}])
    for _ in range(3):
        got, jgot = _both_allreduce()
        assert torch.equal(got, clean)
        assert got.numpy().tobytes() == jgot.tobytes()
    assert ev == jev and [e[3] for e in ev].count("injected") == 2
    # The corruption flips the same bits in both packages' staged copy.
    t = torch.from_numpy(X.copy())
    finject.corrupt_buffer(t, 7, 0)
    j = X.copy()
    jinject.corrupt_buffer(j, 7, 0)
    assert t.numpy().tobytes() == j.tobytes() and not np.array_equal(j, X)


def test_host_staged_hard_fail_propagates(fault_runtime):
    ev, jev = fault_runtime([{"site": "host_staged.gather",
                              "kind": "fail"}])
    x = torch.ones(8, 2)
    with pytest.raises(tfaults.InjectedFailure):
        tmpi.allreduce_rank_major(x, backend="host")
    with pytest.raises(jfaults.InjectedFailure):
        jmpi.allreduce(np.ones((8, 2), np.float32), backend="host")
    assert tfaults.plan().arrivals("host_staged.gather") == 1
    assert torch.equal(tmpi.allreduce_rank_major(x, backend="host")[0],
                       torch.full((2,), 8.0))
    assert ev == jev


def test_host_staged_drop_no_retries_peer_timeout(fault_runtime):
    ev, jev = fault_runtime([{"site": "host_staged.gather", "kind": "drop",
                              "max_hits": -1}], fault_retries=0,
                            fault_deadline_s=0.5)
    t0 = time.monotonic()
    with pytest.raises(tfaults.PeerTimeoutError) as ei:
        tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
    assert time.monotonic() - t0 < 0.5
    assert ei.value.site == "host_staged"
    with pytest.raises(jfaults.PeerTimeoutError):
        jmpi.allreduce(np.ones((8, 2), np.float32), backend="host")
    assert ev == jev


def test_barrier_delay_and_drop_survive(fault_runtime):
    ev, jev = fault_runtime([{"site": "runtime.barrier", "kind": "delay",
                              "delay_s": 0.01},
                             {"site": "runtime.barrier", "kind": "drop",
                              "after": 1, "max_hits": 1}])
    for mod in (tmpi, jmpi):
        mod.barrier()  # delayed
        mod.barrier()  # dropped once, retried
    assert tfaults.plan().arrivals("runtime.barrier") == 3
    assert ev == jev


def _ps_pair():
    """A PS of 64 zeros, 2 shards, in each package."""
    return (tmpi.parameterserver.init({"w": np.zeros((64,), np.float32)},
                                      num_shards=2),
            jmpi.parameterserver.init({"w": np.zeros((64,), np.float32)},
                                      num_shards=2))


def test_ps_request_drop_retried(fault_runtime):
    ev, jev = fault_runtime([{"site": "ps.request", "kind": "drop",
                              "max_hits": 2}])
    ps, jps = _ps_pair()
    try:
        for p in (ps, jps):
            p.send({"w": np.ones((64,), np.float32)}, rule="add").wait()
        got, jgot = ps.receive().wait(), jps.receive().wait()
        np.testing.assert_allclose(got["w"], 1.0)
        assert got["w"].tobytes() == jgot["w"].tobytes()
    finally:
        ps.shutdown()
        jps.shutdown()
    assert ev == jev


def test_ps_response_drop_retransmits(fault_runtime):
    ev, jev = fault_runtime([{"site": "ps.response", "kind": "drop",
                              "max_hits": 1}])
    ps = tmpi.parameterserver.init({"w": np.full((32,), 3.0, np.float32)},
                                   num_shards=2)
    jps = jmpi.parameterserver.init({"w": np.full((32,), 3.0, np.float32)},
                                    num_shards=2)
    try:
        got, jgot = ps.receive().wait(), jps.receive().wait()
        np.testing.assert_allclose(got["w"], 3.0)
        assert got["w"].tobytes() == jgot["w"].tobytes()
        assert all(h.state == "healthy" for h in tfaults.ledger().peers())
    finally:
        ps.shutdown()
        jps.shutdown()
    assert ev == jev


def test_ps_response_drop_applies_an_add_twice_as_jax(fault_runtime):
    """The retransmit semantics (ROADMAP queue C): ``ps.response`` fires
    before the wait, so a drop there abandons an exchange the server has
    applied and the retransmit applies it again.  Pushes of random values
    under drops on both legs leave both packages' centers bitwise equal to
    the numpy float32 fold with each push applied once per enqueue that
    got past ``ps.request``."""
    ev, jev = fault_runtime([{"site": "ps.request", "kind": "drop",
                              "prob": 0.5, "max_hits": 3},
                             {"site": "ps.response", "kind": "drop",
                              "prob": 0.5, "max_hits": 3}], seed=11,
                            fault_retries=8)
    rng = np.random.RandomState(0)
    w0 = rng.randn(48).astype(np.float32)
    ups = [rng.randn(48).astype(np.float32) for _ in range(5)]
    ps = tmpi.parameterserver.init({"w": w0}, num_shards=2)
    jps = jmpi.parameterserver.init({"w": w0}, num_shards=2)
    try:
        for u in ups:
            ps.send({"w": u}, rule="axpy", alpha=0.5).wait()
            jps.send({"w": u}, rule="axpy", alpha=0.5).wait()
        got, jgot = ps.receive().wait()["w"], jps.receive().wait()["w"]
    finally:
        ps.shutdown()
        jps.shutdown()
    assert ev == jev
    # Replay the schedule: every ps.request arrival that did not fire is
    # one application of the current push (the init copy is the first).
    fired = {(s, h) for s, h, _, a in ev if a == "injected"}
    req = resp = 0
    applied = []
    for _ in [None] + ups:  # the init "copy" push, then the axpys
        n_app = 0
        while ("ps.request", req) in fired:  # dropped before the enqueue
            req += 1
        req += 1
        n_app += 1
        while ("ps.response", resp) in fired:  # retransmitted
            resp += 1
            while ("ps.request", req) in fired:
                req += 1
            req += 1
            n_app += 1
        resp += 1
        applied.append(n_app)
    receive_req, receive_resp = req, resp
    assert tfaults.plan().arrivals("ps.request") >= receive_req
    assert sum(applied) > len(applied), "the plan must retransmit a push"
    want = w0.copy()  # the init copy is idempotent
    for u, k in zip(ups, applied[1:]):
        for _ in range(k):
            want = want + np.float32(0.5) * u
    assert got.tobytes() == jgot.tobytes() == want.tobytes()
    assert receive_resp <= tfaults.plan().arrivals("ps.response")


def test_aio_submit_drop_retried(fault_runtime, tmp_path):
    from torchmpi_tpu.utils import aio as jaio
    from torchmpi_tpu_torch.utils import aio

    ev, jev = fault_runtime([{"site": "aio.submit", "kind": "drop",
                              "max_hits": 1}])
    for mod, name in ((aio, "out.bin"), (jaio, "jout.bin")):
        path = str(tmp_path / name)
        with mod.AsyncWriter() as w:
            assert w.submit(path, b"payload").wait() == path
        with open(path, "rb") as f:
            assert f.read() == b"payload"
    assert tfaults.plan().arrivals("aio.submit") == 2
    assert ev == jev


def test_fault_counters_and_flight_tail(fault_runtime, tmp_path):
    fault_runtime([{"site": "host_staged.gather", "kind": "drop",
                    "max_hits": 1},
                   {"site": "host_staged.gather", "kind": "drop",
                    "after": 2, "max_hits": -1}], jax_side=False,
                  obs="metrics", obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    obs.reset()
    try:
        tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
        reg = obs.registry()
        assert reg.counter("tm_fault_injected_total",
                           site="host_staged.gather", kind="drop",
                           peer="gang") == 1
        assert reg.counter_total("tm_fault_retry_total") == 1
        assert reg.counter_total("tm_fault_survived_total") == 1
        assert any(e[2] == "fault" and e[3] == "host_staged.gather"
                   for e in obs.recorder().events())
        tmpi.set_config(fault_retries=0)
        with pytest.raises(tfaults.PeerTimeoutError) as ei:
            tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
        assert ei.value.flight_tail, "tail must carry the flight events"
        assert ei.value.flight_tail[-1]["ev"] in ("fault", "eager")
    finally:
        obs.deactivate()
        obs.reset()


def test_set_config_faults_off_disarms(fault_runtime):
    fault_runtime([{"site": "host_staged.gather", "kind": "fail",
                    "max_hits": -1}], jax_side=False)
    with pytest.raises(tfaults.InjectedFailure):
        tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
    tmpi.set_config(faults="off")
    assert not tfaults.active()
    assert torch.equal(
        tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")[0],
        torch.full((2,), 8.0))


def test_policy_mode_without_plan(fault_runtime):
    tmpi.stop()
    tmpi.init(device="cpu", faults="policy")
    assert tfaults.active() and not tfaults.injecting()
    assert torch.equal(
        tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")[0],
        torch.full((2,), 8.0))
    tmpi.barrier()
    # The staged plan records the armed layer; a direct one does not.
    from torchmpi_tpu_torch import planner

    planner.invalidate()
    tmpi.allreduce_rank_major(torch.ones(8, 2), backend="host")
    tmpi.allreduce_rank_major(torch.ones(8, 2))
    rows = {r["kind"]: r for r in planner.describe()}
    assert rows["eager-staged"]["faults"] and not rows["eager"]["faults"]


def test_corrupt_plan_raises_at_init(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    tmpi.stop()
    with pytest.raises(ValueError):
        tmpi.init(device="cpu", faults=str(bad))
    assert not tmpi.runtime.is_initialized()
    wrong = _write_plan(tmp_path / "v2.json", [])
    with open(wrong) as f:
        d = json.load(f)
    d["version"] = 2
    with open(wrong, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="version"):
        tmpi.init(device="cpu", faults=wrong)
    tmpi.stop()


def test_faults_env_reaches_explicit_config(tmp_path, monkeypatch):
    plan = _write_plan(tmp_path / "env_plan.json",
                       [{"site": "aio.submit", "kind": "delay"}])
    monkeypatch.setenv("TORCHMPI_TPU_FAULTS", plan)
    monkeypatch.setenv("TORCHMPI_TPU_FAULT_RETRIES", "7")
    tmpi.stop()
    try:
        tmpi.init(tmpi.Config(), device="cpu")  # explicit Config
        assert tfaults.injecting()
        assert tfaults.current_policy().retries == 7
        assert tmpi.runtime.config().faults == plan
    finally:
        tfaults.reset()
        tmpi.stop()


def test_ps_timeout_config_and_env(monkeypatch):
    from torchmpi_tpu_torch.parallel import ps as psimpl

    for k in ("TORCHMPI_TPU_PS_TIMEOUT", "TORCHMPI_TPU_PS_TIMEOUT_MS"):
        monkeypatch.delenv(k, raising=False)
    tmpi.stop()
    tmpi.init(device="cpu", ps_timeout_s=2.5)
    assert psimpl._timeout_ms() == 2500
    tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_PS_TIMEOUT", "1.5")
    tmpi.init(device="cpu")
    assert tmpi.runtime.config().ps_timeout_s == 1.5
    assert psimpl._timeout_ms() == 1500
    tmpi.stop()
    assert psimpl._timeout_ms() == 1500
    monkeypatch.delenv("TORCHMPI_TPU_PS_TIMEOUT")
    monkeypatch.setenv("TORCHMPI_TPU_PS_TIMEOUT_MS", "750")
    assert psimpl._timeout_ms() == 750
    tmpi.init(device="cpu")
    assert tmpi.runtime.config().ps_timeout_s == 0.75
    assert psimpl._timeout_ms() == 750
    with pytest.raises(ValueError):
        tmpi.set_config(ps_timeout_s=-1)
    tmpi.set_config(ps_timeout_s="2")  # coerced like init
    assert tmpi.runtime.config().ps_timeout_s == 2.0
    tmpi.stop()


# ---------------------------------------------------------------------------
# The chaos tool: the JAX tool's files, messages and exit codes
# ---------------------------------------------------------------------------


def _both_tools(capsys, argv):
    """(rc, stdout) of JAX's chaos_tool and of the port's tool."""
    out = []
    for t in (_chaos_tool(), ftool):
        rc = t.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_chaos_tool_gen_and_lint(tmp_path, capsys):
    out = tmp_path / "plan.json"
    rc = ftool.main(["gen", "--out", str(out), "--seed", "5",
                     "--rule", "ps.request:drop:0.5:3:0.01",
                     "--rule", "host_staged.*:corrupt"])
    assert rc == 0
    plan = finject.FaultPlan.load(str(out))
    assert plan.seed == 5 and len(plan.rules) == 2
    assert plan.rules[0] == finject.FaultRule("ps.request", "drop",
                                              prob=0.5, max_hits=3,
                                              delay_s=0.01)
    assert ftool.main(["lint", str(out)]) == 0
    bad = tmp_path / "bad.json"
    _write_plan(bad, [{"site": "no.such.site", "kind": "drop"}])
    assert ftool.main(["lint", str(bad)]) == 1
    assert "matches no instrumented site" in capsys.readouterr().out
    garbled = tmp_path / "garbled.json"
    garbled.write_text("{")
    assert ftool.main(["lint", str(garbled)]) == 2
    capsys.readouterr()
    # The same argv writes the same file, and lint prints the same text,
    # through both tools, recipes and JSON findings included.
    recipes = (["--rule", "ps.request:drop:0.5:3:0.01:2",
                "--rule", "host_staged.*:corrupt"],
               ["--stall", "1:3:2", "--partition", "0,1|2,3:4:9"],
               ["--shrink", "2:5:4", "--rule", "serving.admit:corrupt"],
               ["--migrate", "1:2:4", "--note", "drill"])
    for i, extra in enumerate(recipes):
        paths = [str(tmp_path / f"r{i}_{k}.json") for k in ("j", "t")]
        outs = []
        for t, path in zip((_chaos_tool(), ftool), paths):
            assert t.main(["gen", "--out", path, "--seed", "9"] + extra) == 0
            outs.append(capsys.readouterr().out.replace(path, "PLAN"))
        assert outs[0] == outs[1]
        with open(paths[0]) as a, open(paths[1]) as b:
            assert a.read() == b.read()
        for argv in (["lint", paths[0]], ["lint", "--json", paths[0]]):
            (jrc, jout), (rc, tout) = _both_tools(capsys, argv)
            assert (rc, tout) == (jrc, jout)
    (jrc, jout), (rc, tout) = _both_tools(capsys, ["lint", str(bad)])
    assert (rc, tout) == (jrc, jout) == (1, jout)


def test_chaos_tool_summarize(tmp_path, capsys):
    m = tmp_path / "metrics_host0.jsonl"
    with open(m, "w") as f:
        f.write(json.dumps({"kind": "meta", "stream": "metrics",
                            "host": 0, "mode": "metrics"}) + "\n")
        f.write(json.dumps({"kind": "counter",
                            "name": "tm_fault_injected_total",
                            "labels": {"site": "ps.request",
                                       "kind": "drop"},
                            "value": 3}) + "\n")
        f.write(json.dumps({"kind": "counter",
                            "name": "tm_fault_survived_total",
                            "labels": {"site": "ps.response"},
                            "value": 3}) + "\n")
        f.write(json.dumps({"kind": "counter", "name": "tm_other_total",
                            "labels": {}, "value": 9}) + "\n")
    (jrc, jout), (rc, out) = _both_tools(capsys, ["summarize", str(m)])
    assert rc == jrc == 0 and out == jout
    assert "injected" in out and "ps.request" in out and "survived" in out
    assert "tm_other_total" not in out
    empty = tmp_path / "metrics_host1.jsonl"
    with open(empty, "w") as f:
        f.write(json.dumps({"kind": "meta", "stream": "metrics",
                            "host": 1, "mode": "metrics"}) + "\n")
    assert ftool.main(["summarize", str(empty)]) == 1  # no fault counters


# ---------------------------------------------------------------------------
# Off-mode import discipline; the async staged path; the re-stage view
# ---------------------------------------------------------------------------


_OFF_PROBE = textwrap.dedent("""
    import sys, tempfile, os
    import numpy as np, torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.utils import aio
    mpi.init(device='cpu')
    x = torch.ones(2, 4)
    mpi.allreduce_rank_major(x, backend='host')
    mpi.allreduce_rank_major(x)
    mpi.allreduce(torch.ones(4))
    mpi.async_.allreduce(x, backend='host').wait()
    mpi.barrier()
    ps = mpi.parameterserver.init({'w': np.zeros(8, np.float32)})
    ps.send({'w': np.ones(8, np.float32)}).wait()
    ps.receive().wait()
    ps.shutdown()
    w = aio.AsyncWriter()
    path = os.path.join(tempfile.mkdtemp(), 'probe.bin')
    w.submit(path, b'x').wait()
    w.close()
    mpi.stop()
    bad = [m for m in sys.modules if m.startswith(
        ('torchmpi_tpu_torch.faults', 'torchmpi_tpu_torch.watchdog'))]
    assert not bad, bad
    assert 'torchmpi_tpu' not in sys.modules
    print('OFF-MODE-OK')
""")


def test_off_mode_never_imports_faults():
    """With faults and the watchdog off (the defaults), neither
    ``torchmpi_tpu_torch.faults`` nor ``torchmpi_tpu_torch.watchdog`` is
    imported: the probe drives every instrumented surface (a staged and a
    direct collective, a handle, the barrier, a PS send and receive, an
    aio write)."""
    env = dict(os.environ)
    for k in ("TORCHMPI_TPU_FAULTS", "TORCHMPI_TPU_STAGED",
              "TORCHMPI_TPU_WATCHDOG"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", _OFF_PROBE],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OFF-MODE-OK" in out.stdout


_CHAOS_WORKER = textwrap.dedent("""
    import hashlib, sys
    import numpy as np, torch
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import faults
    rank, world, port, mode, plan = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5])
    kw = {} if mode == "clean" else dict(faults=plan, fault_backoff_s=0.01,
                                         fault_deadline_s=0.5)
    if mode == "noretry":
        kw["fault_retries"] = 0
    mpi.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=world, **kw)
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4) * (rank + 1)
    try:
        local = mpi.allreduce_rank_major(x, backend="host")
        total = mpi.allreduce(local[0])
        print(f"CHECK rank={rank} digest="
              + hashlib.sha256(total.numpy().tobytes()).hexdigest())
        if mode == "retry":
            assert faults.plan().arrivals("host_staged.gather") == 2
            print(f"CHECK rank={rank} survived ok")
    except faults.PeerTimeoutError as e:
        assert mode == "noretry" and e.site == "host_staged", e
        print(f"CHECK rank={rank} peer-timeout ok")
    mpi.barrier()
    print(f"CHECK rank={rank} done")
    mpi.stop()
""").replace("REPO", repr(_REPO))


@pytest.mark.slow
def test_two_process_chaos_acceptance(tmp_path):
    """Two gloo processes under a seeded transient drop at
    ``host_staged.gather``: (a) the staged allreduce and the process-world
    sum complete bit-identically to the clean run via retry, (b) with
    retries off the drop is a PeerTimeoutError within the site deadline on
    every rank."""
    worker = tmp_path / "worker.py"
    worker.write_text(_CHAOS_WORKER)
    plan = _write_plan(tmp_path / "plan.json",
                       [{"site": "host_staged.gather", "kind": "drop",
                         "max_hits": 1, "delay_s": 0.01}])

    def run_mode(mode):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), mode,
             plan], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for i in range(2)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=240)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"{mode} proc {i} failed:\n{out}"
            assert f"CHECK rank={i} done" in out, out
        return outs

    def digests(outs):
        return sorted(ln.split("digest=")[1].strip()
                      for out in outs for ln in out.splitlines()
                      if "digest=" in ln)

    clean = digests(run_mode("clean"))
    assert len(clean) == 2
    retried = run_mode("retry")
    assert digests(retried) == clean, "retry must be bit-identical"
    for i, out in enumerate(retried):
        assert f"CHECK rank={i} survived ok" in out, out
    for i, out in enumerate(run_mode("noretry")):
        assert f"CHECK rank={i} peer-timeout ok" in out, out


def test_async_staged_corrupt_then_heal_bit_identical(fault_runtime):
    """The async staged path under corrupt-then-heal: the worker stages
    one host master and the fault layer's retries stage fresh writable
    copies of it (``collectives._RestageView``), so the handle's result is
    bit-identical to the clean run with the input donated away; the same
    plan gives JAX's handle the same bits and the same events."""
    clean = _clean()
    ev, jev = fault_runtime([{"site": "host_staged.gather",
                              "kind": "corrupt", "max_hits": 1}])
    x = torch.from_numpy(X.copy()).clone()
    h = tmpi.async_.allreduce(x, backend="host", donate=True)
    got = h.wait()
    assert torch.equal(got, clean)
    assert x.untyped_storage().size() == 0  # donated away
    assert tfaults.plan().arrivals("host_staged.gather") >= 2
    import jax

    jgot = np.asarray(jmpi.async_.allreduce(jax.device_put(X),
                                            backend="host",
                                            donate=True).wait())
    assert got.numpy().tobytes() == jgot.tobytes()
    assert ev == jev


def test_restage_view_gives_fresh_writable_copies():
    master = torch.arange(8, dtype=torch.float32)
    view = tcoll._RestageView(master)
    a, b = view.stage(), view.stage()
    assert a is not b and a.data_ptr() != b.data_ptr()
    a[:] = -1.0
    assert torch.equal(view.stage(), torch.arange(8, dtype=torch.float32))
    assert torch.equal(tcoll._restage(view), master)
    # A tensor stages a fresh copy too (the synchronous path's contract).
    c = tcoll._restage(master)
    c[:] = 5.0
    assert torch.equal(master, torch.arange(8, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Partition grammar, rule validation and lint pairings (JAX
# tests/test_partition.py :76, :89, :110; the board's cases are in
# tests/test_torch_membership.py)
# ---------------------------------------------------------------------------


def test_partition_ranks_grammar():
    groups, one_way = tfaults.parse_partition_ranks("2,3")
    assert groups == [frozenset({2, 3})] and not one_way
    groups, one_way = tfaults.parse_partition_ranks("0,1|2,3")
    assert groups == [frozenset({0, 1}), frozenset({2, 3})]
    assert not one_way
    groups, one_way = tfaults.parse_partition_ranks("~2,3")
    assert groups == [frozenset({2, 3})] and one_way
    for bad in ("", "a,b", "1|1", "~0|1", "-1", "1,,|"):
        with pytest.raises(ValueError) as ours:
            tfaults.parse_partition_ranks(bad)
        with pytest.raises(ValueError) as theirs:
            jfaults.parse_partition_ranks(bad)
        assert str(ours.value) == str(theirs.value)


def test_partition_rule_validation():
    rule = tfaults.FaultRule(site="board.read", kind="partition",
                             ranks="~1", after=4, heal_after=9)
    rule.validate()
    d = rule.to_json()
    assert d["ranks"] == "~1" and d["heal_after"] == 9
    assert tfaults.FaultRule.from_json(d) == rule
    old = tfaults.FaultRule(site="ps.request", kind="drop").to_json()
    assert "ranks" not in old and "heal_after" not in old
    with pytest.raises(ValueError):
        tfaults.FaultRule(site="board.read", kind="partition").validate()
    with pytest.raises(ValueError):
        tfaults.FaultRule(site="board.read", kind="partition",
                          ranks="1", after=5, heal_after=5).validate()
    with pytest.raises(ValueError):
        tfaults.FaultRule(site="ps.request", kind="drop",
                          ranks="1").validate()
    # The mask the board will read: built once a plan, and only then.
    from torchmpi_tpu_torch.faults import partition

    mask = partition.build(tfaults.FaultPlan(rules=[rule]))
    assert mask.masked(1, 0, 4) and not mask.masked(0, 1, 4)
    assert not mask.masked(1, 0, 9) and mask.healed(9)


def test_partition_lint_pairings():
    def lint(rule, mod=tfaults):
        return mod.lint_plan(mod.FaultPlan(rules=[rule]))

    ok = tfaults.FaultRule(site="board.read", kind="partition", ranks="1")
    assert lint(ok) == []
    cases = [dict(site="elastic.member", kind="partition", ranks="1"),
             dict(site="board.read", kind="partition", ranks="1", prob=0.5),
             dict(site="board.write", kind="corrupt_silent"),
             dict(site="board.write", kind="torn"),
             dict(site="ps.request", kind="drop", heal_after=9),
             dict(site="serving.admit", kind="corrupt"),
             dict(site="ps.request", kind="stall", delay_s=1.0)]
    needles = ["membership board", "standing window", "no payload", "torn",
               "heal_after", "no payload", "indefinite"]
    for kw, needle in zip(cases, needles):
        ours = lint(tfaults.FaultRule(**kw))
        assert any(needle in p for p in ours), (kw, ours)
        assert ours == lint(jfaults.FaultRule(**kw), jfaults)
