"""The port's hot-state tier (torchmpi_tpu_torch/hotstate/,
docs/HOTSTATE_TORCH.md) against the JAX package's on the CPU.

JAX's tests/test_hotstate.py ported case for case onto the port's runtime
(world of one process, ``device="cpu"``): the consent gate and the env /
validation plumbing, the bit-exact mixed-dtype publish and restore, the
staleness gate, recv corruption walked back, the ladder RAM first and its
fall to disk, send-drop self-healing, the fenced publish, budget eviction,
migration with the watchdog's ``migrating`` lease and its miss, and the
chaos tool's ``--migrate`` recipe.  Then parity with the JAX package: the
same seeded trees (float32 with NaN and +-inf, bfloat16, float16, int32,
an empty leaf, a 0-d int64) give byte-equal snapshot and delta blobs and
equal digests through both packages' packers (the port's torch-op pack,
which runs on the card for tensors there, taken here on CPU tensors too);
the same publish / save schedule gives the same ``restart.recover`` step
and the same ``tm_hotstate_*`` counters in both; one ``run_elastic
--shrink`` on JAX's small MLP harness gives the same ``info`` in both,
recovered from RAM at the kill's step."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi

from _torch_world import module_group

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


def _write_plan(path, rules, seed=11):
    with open(path, "w") as f:
        json.dump({"version": 1, "seed": seed, "rules": rules}, f)
    return str(path)


def _reset_all():
    for pkg in ("torchmpi_tpu_torch", "torchmpi_tpu"):
        hs = sys.modules.get(pkg + ".hotstate")
        if hs is not None:
            hs.disable()
        for name in (".faults", ".obs"):
            mod = sys.modules.get(pkg + name)
            if mod is not None:
                mod.reset()
        fz = sys.modules.get(pkg + ".faults.fencing")
        if fz is not None:
            fz.disarm()
    tmpi.stop()
    jmpi.stop()


@pytest.fixture()
def hot_runtime(tmp_path):
    """Callable fixture: (re-)init the port's runtime with hotstate on and
    obs metrics armed (counters cleared), optionally under a fault plan;
    always disables the replicator and disarms faults on exit."""
    counter = [0]

    def arm(rules=None, *, seed=11, **cfg_kw):
        counter[0] += 1
        kw = dict(hotstate="on", obs="metrics",
                  obs_dir=str(tmp_path / "obs"))
        if rules is not None:
            kw["faults"] = _write_plan(
                tmp_path / f"plan{counter[0]}.json", rules, seed=seed)
        kw.update(cfg_kw)
        tmpi.stop()
        tmpi.init(tmpi.Config(**kw), device="cpu")
        sys.modules["torchmpi_tpu_torch.obs"].reset()

    yield arm
    _reset_all()


def _reg():
    return sys.modules["torchmpi_tpu_torch.obs"].registry()


def _state(i, steps=12):
    """Mixed-dtype state (JAX's ``_state``): float32 weights, float16
    statistics, an int64 step counter and a NaN-padded loss ring."""
    rng = np.random.RandomState(i)
    losses = np.full((steps,), np.nan, np.float32)
    losses[:i] = np.arange(i, dtype=np.float32) * np.float32(0.25)
    return {"w": (rng.randn(6, 8) * (1 + 0.1 * i)).astype(np.float32),
            "h": (rng.randn(16) * 0.01).astype(np.float16),
            "step": np.int64(i),
            "losses": losses}


def _trees_equal(a, b):
    from torchmpi_tpu_torch import _tree

    la, ta = _tree.flatten(a)
    lb, tb = _tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y, equal_nan=True)


# ---------------------------------------------------------------------------
# Config plumbing and the consent gate
# ---------------------------------------------------------------------------


def test_hotstate_config_env_and_validation(monkeypatch):
    monkeypatch.setenv("TORCHMPI_TPU_HOTSTATE", "1")
    monkeypatch.setenv("TORCHMPI_TPU_HOTSTATE_INTERVAL", "16")
    monkeypatch.setenv("TORCHMPI_TPU_HOTSTATE_BUDGET_MB", "64")
    tmpi.stop()
    try:
        tmpi.init(tmpi.Config(), device="cpu")
        cfg = tmpi.config()
        assert cfg.hotstate == "on"
        assert cfg.hotstate_interval == 16
        assert cfg.hotstate_budget_mb == 64
        with pytest.raises(ValueError, match="hotstate"):
            tmpi.set_config(hotstate="sometimes")
        with pytest.raises(ValueError, match="hotstate_interval"):
            tmpi.set_config(hotstate_interval=0)
        with pytest.raises(ValueError, match="hotstate_budget_mb"):
            tmpi.set_config(hotstate_budget_mb=-1)
        tmpi.set_config(hotstate="off")
        assert tmpi.config().hotstate == "off"
    finally:
        tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_HOTSTATE", "maybe")
    with pytest.raises(ValueError, match="hotstate"):
        tmpi.init(tmpi.Config(), device="cpu")
    tmpi.stop()


def test_consent_gate_requires_on(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime(hotstate="off")
    with pytest.raises(RuntimeError, match="HOTSTATE"):
        hotstate.enable(4)
    assert not hotstate.active()
    with pytest.raises(RuntimeError, match="not enabled"):
        hotstate.replicator()
    # offer_restore is a rung, not a requirement: quietly no-ops.
    assert hotstate.offer_restore(_state(0)) is None
    tmpi.set_config(hotstate="on")
    rep = hotstate.enable(4, rank=0)
    assert hotstate.active() and hotstate.replicator() is rep


# ---------------------------------------------------------------------------
# The stream: bit-exact reconstruction through the delta chain
# ---------------------------------------------------------------------------


def test_publish_restore_bit_exact_mixed_dtypes(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime()
    rep = hotstate.enable(4, rank=0, interval=4)
    for i in range(1, 11):
        rep.publish(_state(i), i)
    assert rep.stats["streamed"] == 10 and rep.stats["dropped"] == 0
    reg = _reg()
    assert reg.counter("tm_hotstate_streamed_total", peer="member:0",
                       reason="snap") >= 2
    assert reg.counter("tm_hotstate_streamed_total", peer="member:0",
                       reason="delta") >= 6
    got = rep.restore(_state(0))
    assert got is not None
    state, step = got
    assert step == 10
    _trees_equal(state, _state(10))
    state7, step7 = rep.restore(_state(0), step=7)
    assert step7 == 7
    _trees_equal(state7, _state(7))
    assert rep.restore(_state(0), step=99) is None


def test_offer_restore_staleness_gate(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime()
    rep = hotstate.enable(4, rank=0)
    for i in range(1, 4):
        rep.publish(_state(i), i)
    got = hotstate.offer_restore(_state(0), min_step=3)
    assert got is not None and got[1] == 3
    assert _reg().counter_total("tm_hotstate_restored_total") == 1
    # A RAM copy older than the disk tier is stale: the disk rung wins.
    assert hotstate.offer_restore(_state(0), min_step=4) is None
    assert _reg().counter("tm_hotstate_fallback_disk_total",
                          peer="member:0", reason="stale") == 1


# ---------------------------------------------------------------------------
# The ladder under seeded corruption (hotstate.recv corrupt_silent)
# ---------------------------------------------------------------------------


def test_recv_corruption_verify_fails_and_walks_back(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime(rules=[{"site": "hotstate.recv", "kind": "corrupt_silent",
                        "prob": 1.0, "after": 4, "max_hits": -1}])
    rep = hotstate.enable(4, rank=0, interval=3)
    for i in range(1, 9):
        rep.publish(_state(i), i)
    got = rep.restore(_state(0))
    assert got is not None
    state, step = got
    assert step == 4
    _trees_equal(state, _state(4))
    assert _reg().counter_total("tm_hotstate_verify_failed_total") >= 1


def test_recover_ladder_ram_first_then_disk(tmp_path, hot_runtime):
    from torchmpi_tpu_torch import hotstate
    from torchmpi_tpu_torch.utils import checkpoint, restart

    hot_runtime()
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    init_fn = lambda: _state(0)  # noqa: E731
    rep = hotstate.enable(4, rank=0)
    for i in range(1, 8):
        rep.publish(_state(i), i)
        if i == 5:
            checkpoint.save(d, _state(i), step=i)
    state, step = restart.recover(init_fn, d, init_fn())
    assert step == 7
    _trees_equal(state, _state(7))
    assert _reg().counter_total("tm_hotstate_restored_total") == 1
    hotstate.disable()
    state, step = restart.recover(init_fn, d, init_fn())
    assert step == 5
    _trees_equal(state, _state(5))


def test_recover_falls_to_disk_on_corrupt_ram(tmp_path, hot_runtime):
    from torchmpi_tpu_torch import hotstate
    from torchmpi_tpu_torch.utils import checkpoint, restart

    hot_runtime(rules=[{"site": "hotstate.recv", "kind": "corrupt_silent",
                        "prob": 1.0, "max_hits": -1}])
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    init_fn = lambda: _state(0)  # noqa: E731
    rep = hotstate.enable(4, rank=0)
    for i in range(1, 8):
        rep.publish(_state(i), i)
        if i == 5:
            checkpoint.save(d, _state(i), step=i)
    state, step = restart.recover(init_fn, d, init_fn())
    assert step == 5
    _trees_equal(state, _state(5))
    reg = _reg()
    assert reg.counter_total("tm_hotstate_verify_failed_total") >= 1
    assert reg.counter_total("tm_hotstate_fallback_disk_total") >= 1
    assert reg.counter_total("tm_hotstate_restored_total") == 0


def test_send_drop_forces_snapshot_self_heal(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime(rules=[{"site": "hotstate.send", "kind": "drop",
                        "prob": 1.0, "after": 2, "max_hits": 1}])
    rep = hotstate.enable(4, rank=0, interval=50)
    for i in range(1, 7):
        rep.publish(_state(i), i)
    assert rep.stats["dropped"] == 1 and rep.stats["streamed"] == 5
    reg = _reg()
    assert reg.counter_total("tm_hotstate_dropped_total") == 1
    assert reg.counter("tm_hotstate_streamed_total", peer="member:0",
                       reason="snap") == 2
    got = rep.restore(_state(0))
    assert got is not None and got[1] == 6
    _trees_equal(got[0], _state(6))


# ---------------------------------------------------------------------------
# Fencing and the budget
# ---------------------------------------------------------------------------


def test_fenced_publish_lands_nothing(hot_runtime):
    from torchmpi_tpu_torch import hotstate
    from torchmpi_tpu_torch.faults import fencing

    hot_runtime()
    rep = hotstate.enable(4, rank=0)
    rep.publish(_state(1), 1, epoch=1)

    class _View:
        epoch = 3

    class _Board:
        fence = None

        def committed_view(self):
            return _View()

    fencing.arm(_Board(), 0, epoch=3)
    try:
        with pytest.raises(fencing.FencedWriterError):
            rep.publish(_state(2), 2, epoch=1)
    finally:
        fencing.disarm()
    assert rep.latest_step(0) == 1
    rep.publish(_state(2), 2, epoch=3)
    assert rep.latest_step(0) == 2


def test_budget_evicts_oldest_never_newest(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime()
    rep = hotstate.enable(4, rank=0, interval=1, budget_mb=1)
    big = {"w": np.zeros((150_000,), np.float32)}
    for i in range(1, 4):
        big["w"][:] = i
        rep.publish(big, i)
    assert rep.stats["evicted"] >= 1
    assert _reg().counter_total("tm_hotstate_evicted_total") >= 1
    got = rep.restore({"w": np.zeros((150_000,), np.float32)})
    assert got is not None and got[1] == 3
    assert float(np.asarray(got[0]["w"])[0]) == 3.0


# ---------------------------------------------------------------------------
# Live migration: zero rollback, lease-visible drain
# ---------------------------------------------------------------------------


def test_migrate_zero_rollback_watchdog_visible(hot_runtime, monkeypatch):
    from torchmpi_tpu_torch import hotstate, watchdog

    hot_runtime(watchdog="warn", watchdog_deadline_s=30.0)
    assert watchdog.active()
    states = []
    real = watchdog.set_state

    def spy(state, detail=""):
        states.append((state, detail))
        return real(state, detail)

    monkeypatch.setattr(watchdog, "set_state", spy)
    rep = hotstate.enable(4, rank=0)
    for i in range(1, 6):
        rep.publish(_state(i), i, rank=1)
    slot = {}
    state, step = hotstate.migrate(
        1, 3, _state(0),
        admit=lambda st, s: slot.update(state=st, step=s),
        retire=lambda r: slot.update(retired=r))
    assert step == 5 and slot["step"] == 5 and slot["retired"] == 1
    _trees_equal(state, _state(5))
    _trees_equal(slot["state"], _state(5))
    assert ("migrating", "rank 1 -> rank 3") in states
    assert states[-1] == ("running", "")
    assert watchdog.state() == "running"
    assert rep.latest_step(1) == 0
    assert rep.latest_step(3) == 5
    assert _reg().counter("tm_hotstate_migrated_total",
                          peer="member:1->member:3") == 1


def test_migrate_without_stream_raises_miss(hot_runtime):
    from torchmpi_tpu_torch import hotstate

    hot_runtime()
    hotstate.enable(4, rank=0)
    with pytest.raises(hotstate.HotStateMiss, match="rank 2"):
        hotstate.migrate(2, 3, _state(0))
    assert _reg().counter_total("tm_hotstate_fallback_disk_total") == 1


# ---------------------------------------------------------------------------
# The chaos tool's --migrate drill recipe
# ---------------------------------------------------------------------------


def test_chaos_tool_migrate_recipe(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    out = str(tmp_path / "migrate.json")
    assert tool.main(["gen", "--out", out, "--seed", "3",
                      "--migrate", "2:6:4"]) == 0
    text = capsys.readouterr().out
    assert "drain rank 2 onto a spare at step 6" in text
    assert "source killed at step 7" in text
    plan = json.load(open(out))
    assert plan["rules"] == [{"site": "elastic.member", "kind": "fail",
                              "prob": 1.0, "after": 30, "max_hits": 1,
                              "delay_s": 0.0}]
    assert tool.main(["lint", out]) == 0
    capsys.readouterr()
    assert tool.main(["gen", "--out", out, "--migrate", "4:1:4"]) == 2
    assert tool.main(["gen", "--out", out, "--migrate", "1:2:4",
                      "--shrink", "2:3:4"]) == 2
    assert tool.main(["gen", "--out", out, "--rule",
                      "hotstate.recv:corrupt_silent:1.0:-1",
                      "--rule", "hotstate.send:drop"]) == 0
    assert tool.main(["lint", out]) == 0


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def _parity_tree(i, j=None):
    """Seeded trees of every leaf kind: float32 with NaN / +-inf entries,
    bfloat16, float16, int32, an empty float32 leaf, float64 and a 0-d
    int64; ``j`` reseeds the float leaves only (a base for a delta)."""
    import ml_dtypes

    r = np.random.RandomState(i)
    f = np.random.RandomState(i if j is None else j)
    w = (f.randn(9, 11) * 3).astype(np.float32)
    w[0, :4] = [np.nan, np.inf, -np.inf, np.nan]
    return {"w": w,
            "bf": f.randn(37).astype(ml_dtypes.bfloat16),
            "h": (f.randn(5, 3) * 0.01).astype(np.float16),
            "ids": r.randint(-9, 9, (4,)).astype(np.int32),
            "empty": np.zeros((0, 3), np.float32),
            "d": f.randn(6).astype(np.float64),
            "n": np.int64(i)}


def _to_torch(tree):
    import ml_dtypes

    out = {}
    for k, v in tree.items():
        v = np.asarray(v)
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


@pytest.mark.parametrize("case", ["fresh", "zero_delta", "all_changed",
                                  "nan_base"])
def test_blobs_and_digests_match_jax(case):
    from torchmpi_tpu import hotstate as jhs
    from torchmpi_tpu_torch import hotstate as ths

    new = _parity_tree(3)
    base = {"fresh": _parity_tree(3, 17), "zero_delta": _parity_tree(3),
            "all_changed": {k: (np.asarray(v) + np.asarray(v).dtype.type(1)
                                if np.asarray(v).dtype.kind == "f"
                                else np.asarray(v))
                            for k, v in _parity_tree(3).items()},
            "nan_base": _parity_tree(3, 5)}[case]
    if case == "nan_base":
        base["w"][:, 2] = np.nan
        base["d"][1] = np.inf
    jn, _ = jhs._tree_leaves(new)
    jb, _ = jhs._tree_leaves(base)
    tn, _ = ths._tree_leaves(_to_torch(new))
    tb, _ = ths._tree_leaves(_to_torch(base))
    assert ths._digest_state(tn) == jhs._digest_state(jn)
    assert ths._digest_state(tb) == jhs._digest_state(jb)
    # The threaded digest the publish and the restore take, fed whole or
    # leaf by leaf.
    assert ths._Digest(tn).result() == jhs._digest_state(jn)
    fed = ths._Digest()
    for leaf in tb:
        fed.feed(leaf)
    fed.close()
    assert fed.result() == jhs._digest_state(jb)
    assert np.array_equal(ths._pack_snap(tn), jhs._pack_snap(jn))
    with np.errstate(invalid="ignore"):
        jblob = jhs._pack_delta(jn, jb)
        assert np.array_equal(ths._pack_delta(tn, tb), jblob)
    # The torch-op pack (the card's) on CPU tensors: the same bytes.
    tt, bt = _to_torch(new), _to_torch(base)
    got = ths._pack_delta_device([tt[k] for k in sorted(tt)],
                                 [bt[k] for k in sorted(bt)])
    assert np.array_equal(got, jblob)
    # Each package unpacks the other's blobs onto the same leaves.
    back = ths._unpack_delta(jblob, ths._unpack_snap(jhs._pack_snap(jb),
                                                     tb))
    assert ths._digest_state(back) == jhs._digest_state(jn)


def _jax_arm(tmp_path, tag, rules=None, **kw):
    cfg = dict(dcn_size=1, hotstate="on", obs="metrics")
    if rules is not None:
        cfg["faults"] = _write_plan(tmp_path / f"j{tag}.json", rules)
    cfg.update(kw)
    jmpi.stop()
    jmpi.init(jmpi.Config(**cfg))
    sys.modules["torchmpi_tpu.obs"].reset()


def _hot_counters(reg):
    names = ("streamed", "received", "dropped", "restored",
             "verify_failed", "fallback_disk", "evicted")
    return {n: reg.counter_total(f"tm_hotstate_{n}_total") for n in names}


@pytest.mark.parametrize("rules", [
    None,
    [{"site": "hotstate.recv", "kind": "corrupt_silent", "prob": 1.0,
      "after": 5, "max_hits": -1}],
    [{"site": "hotstate.send", "kind": "drop", "prob": 1.0, "after": 2,
      "max_hits": 1}],
], ids=["clean", "recv_corrupt", "send_drop"])
def test_recover_schedule_matches_jax(tmp_path, hot_runtime, rules):
    from torchmpi_tpu import hotstate as jhs
    from torchmpi_tpu.utils import checkpoint as jckpt
    from torchmpi_tpu.utils import restart as jrestart
    from torchmpi_tpu_torch import hotstate as ths
    from torchmpi_tpu_torch.utils import checkpoint, restart

    got = {}
    for side in ("port", "jax"):
        d = str(tmp_path / f"ckpt_{side}")
        os.makedirs(d)
        if side == "port":
            hot_runtime(rules=rules)
            hs, ck, rs = ths, checkpoint, restart
        else:
            _jax_arm(tmp_path, "s", rules)
            hs, ck, rs = jhs, jckpt, jrestart
        rep = hs.enable(4, rank=0, interval=3)
        for i in range(1, 9):
            rep.publish(_state(i), i)
            if i % 4 == 0:
                ck.save(d, _state(i), step=i)
        state, step = rs.recover(lambda: _state(0), d, _state(0))
        reg = sys.modules[("torchmpi_tpu_torch" if side == "port"
                           else "torchmpi_tpu") + ".obs"].registry()
        got[side] = (step, _hot_counters(reg), dict(rep.stats))
        _trees_equal({k: np.asarray(v) for k, v in state.items()},
                     _state(step))
        hs.disable()
    assert got["port"] == got["jax"]


def test_run_elastic_shrink_recovers_from_ram_as_jax(tmp_path):
    """``--shrink 2:5:4`` on JAX's MLP harness (test_elastic.py) and the
    port's (test_torch_elastic.py) with the tier armed in both: the same
    info, recovered at the kill's step from RAM (the disk holds step 4),
    losses to float32 rounding as the elastic parity tests hold them, the
    same ``tm_hotstate_*`` counters (the fresh start's rung, which finds
    nothing, is the one step down to disk)."""
    import test_elastic as jte
    import test_torch_elastic as tte
    from torchmpi_tpu import elastic as jel
    from torchmpi_tpu import hotstate as jhs
    from torchmpi_tpu_torch import elastic as tel
    from torchmpi_tpu_torch import hotstate as ths

    plan = jte._kill_plan(tmp_path / "plan.json", 2, 5, 4)
    d, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(d)
    os.makedirs(dj)
    try:
        tmpi.stop()
        tmpi.init(device="cpu", elastic="on", hotstate="on", faults=plan,
                  obs="metrics", obs_dir=str(tmp_path / "obs"))
        sys.modules["torchmpi_tpu_torch.obs"].reset()
        jmpi.stop()
        jmpi.init(jmpi.Config(elastic="on", hotstate="on", faults=plan,
                              obs="metrics"))
        sys.modules["torchmpi_tpu.obs"].reset()
        ths.enable(4, rank=0, interval=3, budget_mb=64)
        jhs.enable(4, rank=0, interval=3, budget_mb=64)
        state, info = tel.run_elastic(
            tte._make_build(jte.STEPS), steps=jte.STEPS, directory=d,
            save_every=2, members=[0, 1, 2, 3], world_size=8)
        jstate, jinfo = jel.run_elastic(
            jte._make_build(jte.STEPS), steps=jte.STEPS, directory=dj,
            save_every=2, members=[0, 1, 2, 3], world_size=8)
        assert tte._info_js(info) == tte._info_js(jinfo)
        assert info["recovered_step"] == 5 and info["shrinks"] == 1
        assert info["recoveries"] == [0, 5]
        tte._assert_losses_match_jax(state, jstate)
        counters = {}
        for pkg in ("torchmpi_tpu_torch", "torchmpi_tpu"):
            reg = sys.modules[pkg + ".obs"].registry()
            counters[pkg] = dict(
                _hot_counters(reg),
                peer_lost=reg.counter_total("tm_hotstate_peer_lost_total"),
                # The fresh start's rung found nothing: the only step-down.
                missing=reg.counter("tm_hotstate_fallback_disk_total",
                                    peer="member:0", reason="missing"))
        assert counters["torchmpi_tpu_torch"] == counters["torchmpi_tpu"]
        c = counters["torchmpi_tpu_torch"]
        assert c["restored"] == 1 and c["peer_lost"] == 1
        assert c["fallback_disk"] == c["missing"] == 1
    finally:
        _reset_all()
