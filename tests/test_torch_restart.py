"""The port's checkpoint-restart loop (torchmpi_tpu_torch/utils/restart.py)
on the CPU; JAX's tests/test_restart.py is the spec, one port case for
each of its 10: crash mid-training, restore the newest checkpoint, replay,
and land on the uninterrupted run's final state; the restart budget; a
process-level resume; the fault layer's health ledger across a restart; a
truncated newest checkpoint walked past; the dcn error-feedback residuals
checkpointed with the state (``attach_ef_residuals``).

With them the cases the JAX package keeps in its fault and watchdog
tests: a ``PeerTimeoutError`` takes the ``on_peer_timeout`` path, and a
``stall`` on the staged path under ``watchdog="break"`` is broken into a
``CollectiveHangError`` and recovered bit-identically.  Across the
packages: the same step function, crash and fault plan give the same
``info`` and the same final bytes in both packages.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.utils import restart as jrestart
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.utils import checkpoint, restart

from _torch_world import module_group

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture(autouse=True)
def fresh():
    tmpi.stop()
    yield
    for name in ("torchmpi_tpu_torch.faults", "torchmpi_tpu.faults"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.reset()
    wd = sys.modules.get("torchmpi_tpu_torch.watchdog")
    if wd is not None:
        wd.reset()
    tmpi.stop()
    jmpi.stop()


def _init():
    return {"w": torch.zeros(4), "n": np.float32(0)}


def _step(state, i):
    # Deterministic and step-indexed: the final state encodes the exact
    # sequence of executed steps.
    return {"w": state["w"] + (i + 1), "n": state["n"] + np.float32(1)}


def _expected(steps):
    s = _init()
    for i in range(steps):
        s = _step(s, i)
    return s


def test_uninterrupted_run(tmp_path):
    final, info = restart.run_with_restarts(
        _init, _step, steps=7, directory=str(tmp_path), save_every=3)
    assert torch.equal(final["w"], _expected(7)["w"])
    assert info == {"restarts": 0, "restarts_used": 0, "steps_run": 7,
                    "recovered_step": 0}


@pytest.mark.parametrize("crash_at,save_every", [(5, 1), (5, 3), (1, 4)])
def test_crash_restores_and_matches(tmp_path, crash_at, save_every):
    crashed = []

    def flaky(state, i):
        if i == crash_at and not crashed:
            crashed.append(i)
            raise RuntimeError("injected failure")
        return _step(state, i)

    seen = []
    final, info = restart.run_with_restarts(
        _init, flaky, steps=9, directory=str(tmp_path),
        save_every=save_every, on_restart=lambda r, e: seen.append(str(e)))
    assert torch.equal(final["w"], _expected(9)["w"])
    assert final["n"] == np.float32(9)
    assert info["restarts"] == 1 and crashed and seen == ["injected failure"]
    assert info["restarts_used"] == 1
    assert info["recovered_step"] == (crash_at // save_every) * save_every
    assert info["steps_run"] <= 9 + save_every


def test_gives_up_after_max_restarts(tmp_path):
    def always_fails(state, i):
        raise RuntimeError("permafail")

    with pytest.raises(RuntimeError, match="permafail"):
        restart.run_with_restarts(_init, always_fails, steps=3,
                                  directory=str(tmp_path), max_restarts=2)


def test_process_level_resume(tmp_path):
    restart.run_with_restarts(_init, _step, steps=6,
                              directory=str(tmp_path), save_every=3)
    calls = []

    def counting(state, i):
        calls.append(i)
        return _step(state, i)

    final, info = restart.run_with_restarts(
        _init, counting, steps=10, directory=str(tmp_path), save_every=3)
    assert torch.equal(final["w"], _expected(10)["w"])
    assert calls == [6, 7, 8, 9]  # resumed, no replay of 0..5
    assert info["recovered_step"] == 6


def test_health_ledger_survives_restart_recovery(tmp_path):
    tmpi.init(device="cpu", faults="policy")
    from torchmpi_tpu_torch import faults

    led = faults.ledger()
    led.clear()
    led.record("flaky:9", ok=False)
    led.record("flaky:9", ok=False)
    restart.run_with_restarts(_init, _step, steps=4,
                              directory=str(tmp_path), save_every=2)
    assert os.path.exists(os.path.join(str(tmp_path), "health_p0.json"))
    led.clear()  # a fresh process's ledger knows nothing
    assert led.get("flaky:9") is None
    restart.run_with_restarts(_init, _step, steps=4,
                              directory=str(tmp_path), save_every=2)
    h = led.get("flaky:9")
    assert h is not None and h.consecutive_failures == 2
    assert led.decide("flaky:9") == "degrade"


def test_corrupt_latest_checkpoint_falls_back(tmp_path):
    restart.run_with_restarts(_init, _step, steps=6,
                              directory=str(tmp_path), save_every=3)
    (tmp_path / "ckpt_9_p0.npz").write_bytes(b"PK\x03\x04 truncated")
    final, info = restart.run_with_restarts(
        _init, _step, steps=12, directory=str(tmp_path), save_every=3)
    assert torch.equal(final["w"], _expected(12)["w"])
    assert info["restarts"] == 0


def test_ef_residuals_checkpoint_roundtrip(tmp_path):
    """8 ranks rank-major on a dcn 2 x ici 4 grid, int8 error feedback:
    the residuals ride the checkpoints, and crash-restore-replay lands
    bitwise on the uninterrupted run, parameters and residuals."""
    tmpi.init(device="cpu", dcn_size=2, dcn_compress="int8",
              dcn_compress_min_bytes=0)
    from torchmpi_tpu_torch.parallel import gradsync

    n = 8

    def init_fn():
        state = {"params": {"w": torch.zeros(64, 8)}}
        return restart.attach_ef_residuals(state, n=n)

    def make_step(crash_at):
        armed = {"on": crash_at is not None}

        def step_fn(state, i):
            if armed["on"] and i == crash_at:
                armed["on"] = False
                raise RuntimeError("injected crash")
            # Step-indexed per-rank gradients through the quantized EF dcn
            # leg: the residuals evolve every step.  Exact arithmetic only
            # (multiples of 1/32): a transcendental of large arguments may
            # round differently on a process's first calls.
            k = torch.arange(n * 64 * 8, dtype=torch.float32).view(n, 64, 8)
            g = state["params"]["w"] + ((k * (7 + 2 * i)) % 97 - 48) / 32
            (synced,), res = gradsync.synchronize_gradients_rank_major(
                [g.contiguous()], residuals=state["ef_residuals"])
            return {"params": {"w": synced[0].clone()},
                    "ef_residuals": res}

        return step_fn

    final, info = restart.run_with_restarts(
        init_fn, make_step(crash_at=4), steps=6, directory=str(tmp_path),
        save_every=2)
    assert info["restarts_used"] == 1 and info["recovered_step"] == 4
    ck = checkpoint.restore(str(tmp_path), init_fn(), step=4)
    assert any(float(r.abs().max()) > 0 for r in ck["ef_residuals"])
    state = init_fn()
    step_fn = make_step(crash_at=None)
    for i in range(6):
        state = step_fn(state, i)
    assert torch.equal(final["params"]["w"], state["params"]["w"])
    for got, exp in zip(final["ef_residuals"], state["ef_residuals"]):
        assert torch.equal(got, exp)


def test_attach_ef_residuals_validates():
    with pytest.raises(KeyError, match="params"):
        restart.attach_ef_residuals({"opt": 1})
    state = {"params": {"w": torch.zeros(8)}, "ef_residuals": []}
    with pytest.raises(ValueError, match="already"):
        restart.attach_ef_residuals(state)


# --- the typed-timeout path -------------------------------------------------------

def test_restart_on_peer_timeout_path(tmp_path):
    """JAX tests/test_faults.py::test_restart_on_peer_timeout_path."""
    from torchmpi_tpu_torch.collectives import PeerTimeoutError

    hits = []

    def flaky(state, i):
        if i == 3 and not hits:
            hits.append("raise")
            raise PeerTimeoutError("ps.response", peer="p0", deadline_s=1.0)
        return {"w": state["w"] + (i + 1)}

    seen = []
    final, info = restart.run_with_restarts(
        lambda: {"w": np.zeros((2,), np.float32)}, flaky, steps=5,
        directory=str(tmp_path), save_every=2,
        on_restart=lambda r, e: seen.append(("restart", r)),
        on_peer_timeout=lambda r, e: seen.append(("peer", r)))
    assert seen == [("peer", 1)], "peer timeouts take their own path"
    assert info["restarts_used"] == 1 and info["recovered_step"] == 2
    np.testing.assert_array_equal(final["w"], np.full(2, 15, np.float32))


def _stall_plan(path, after):
    with open(path, "w") as f:
        json.dump({"version": 1, "seed": 7, "rules": [
            {"site": "host_staged.gather", "kind": "stall", "after": after,
             "max_hits": 1}]}, f)
    return str(path)


def test_restart_loop_recovers_bit_identical(tmp_path):
    """JAX tests/test_watchdog.py::test_restart_loop_recovers_bit_identical:
    a stall mid-run under watchdog "break" is broken into a typed hang,
    routed through on_peer_timeout, and the final state is bitwise a clean
    run's."""

    def run(tag, plan):
        tmpi.stop()
        kw = dict(watchdog="break", watchdog_deadline_s=0.3,
                  watchdog_poll_s=0.02)
        if plan:
            kw["faults"] = plan
        tmpi.init(device="cpu", **kw)
        d = str(tmp_path / tag)
        pts = []

        def init_fn():
            return {"w": torch.zeros(8, 4)}

        def step_fn(state, i):
            red = tmpi.allreduce_rank_major(
                torch.full((8, 4), float(i + 1)), backend="host")
            return {"w": state["w"] + red[0] * 0.1}

        state, info = restart.run_with_restarts(
            init_fn, step_fn, steps=6, directory=d, save_every=2,
            on_peer_timeout=lambda r, e: pts.append(e))
        return state, info, pts

    # Arrival 3: step 3's staged allreduce (one a step).
    state1, info1, pts = run("stalled", _stall_plan(tmp_path / "p.json", 3))
    from torchmpi_tpu_torch import watchdog

    assert info1["restarts_used"] == 1 and info1["recovered_step"] == 2
    assert len(pts) == 1 and isinstance(pts[0], watchdog.CollectiveHangError)
    state2, info2, _ = run("clean", None)
    assert info2["restarts_used"] == 0
    assert torch.equal(state1["w"], state2["w"])


# --- across the packages -------------------------------------------------------------

def _np_step(crash_at):
    crashed = []

    def step(state, i):
        if i == crash_at and not crashed:
            crashed.append(i)
            raise RuntimeError("injected crash")
        w = state["w"] * np.float32(1.5) + np.sin(
            np.arange(6, dtype=np.float32) + i).astype(np.float32)
        return {"w": w.astype(np.float32), "k": state["k"] + np.int64(i)}

    return step


def _np_init():
    return {"w": np.linspace(-1, 1, 6, dtype=np.float32), "k": np.int64(0)}


@pytest.mark.parametrize("redundancy,rules", [
    ("off", None),
    ("buddy", [{"site": "ckpt.read", "kind": "corrupt_silent",
                "max_hits": 1}]),
], ids=["plain", "buddy-rot"])
def test_same_run_in_both_packages(tmp_path, redundancy, rules):
    """The same numpy step function, crash and plan in each package: the
    same info and the same final bytes (in buddy mode the first read of
    the recovery rots and both repair from the buddy)."""
    plan = None
    if rules:
        plan = str(tmp_path / "plan.json")
        with open(plan, "w") as f:
            json.dump({"version": 1, "seed": 3, "rules": rules}, f)
    kw = dict(ckpt_redundancy=redundancy, ckpt_keep=2)
    if plan:
        kw["faults"] = plan
    jmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, **kw))
    try:
        jfinal, jinfo = jrestart.run_with_restarts(
            _np_init, _np_step(5), steps=9, directory=str(tmp_path / "j"),
            save_every=2)
    finally:
        mod = sys.modules.get("torchmpi_tpu.faults")
        if mod is not None:
            mod.reset()
        jmpi.stop()
    tmpi.init(device="cpu", **kw)
    tfinal, tinfo = restart.run_with_restarts(
        _np_init, _np_step(5), steps=9, directory=str(tmp_path / "t"),
        save_every=2)
    assert tinfo == jinfo
    assert tinfo["recovered_step"] == 4 and tinfo["steps_run"] == 10
    for k in ("w", "k"):
        assert np.asarray(tfinal[k]).tobytes() == \
            np.asarray(jfinal[k]).tobytes(), k
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
