"""The port's collective watchdog (torchmpi_tpu_torch/watchdog.py) as the
JAX package's tests/test_watchdog.py holds its own: one case here for each
case there but the restart loop's (tests/test_torch_restart.py), the three
elastic ones included (the gang adopts its board as the lease home, a
``set_config`` tune keeps it, a stall broken at a member's liveness check
shrinks the gang bit-identically).

Config plumbing, the stall -> break -> escalate ladder, the deferred raise,
the ``stall`` fault kind through the port's real staged call site,
``AsyncHandle.wait(timeout_s=)``, leases and ``obs.tool blame --live`` (the
port's tool and JAX's ``scripts/obs_tool.py`` print the same verdict on the
port's leases, and JAX's ``read_leases`` / ``dead_ranks`` read them as the
port's do), the flight ring's completion edges, and the off mode.  Deadlines
are 0.2-0.3 s; the escalation exit runs in a subprocess with the exit seam
patched.
"""

import contextlib
import importlib
import importlib.util
import io
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

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.obs import tool as otool

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}_under_port_wd_test",
        os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_plan(path, rules, seed=7):
    with open(path, "w") as f:
        json.dump({"version": 1, "seed": seed, "rules": rules}, f)
    return str(path)


def _stall_rule(site, after=0, max_hits=1):
    return {"site": site, "kind": "stall", "prob": 1.0, "after": after,
            "max_hits": max_hits}


@pytest.fixture()
def wd_runtime(tmp_path):
    """Callable fixture: (re-)init the port's runtime with the watchdog
    armed at test-speed deadlines; always disarms and resets on exit, the
    exit seam observed instead of dying."""
    counter = [0]

    def arm(rules=None, *, watchdog="break", deadline_s=0.3, **cfg_kw):
        counter[0] += 1
        if rules is not None:
            cfg_kw["faults"] = _write_plan(
                tmp_path / f"plan{counter[0]}.json", rules)
            cfg_kw.setdefault("fault_backoff_s", 0.01)
        tmpi.stop()
        tmpi.init(device="cpu", watchdog=watchdog,
                  watchdog_deadline_s=deadline_s, watchdog_poll_s=0.02,
                  **cfg_kw)
        from torchmpi_tpu_torch import watchdog as wd

        wd._exit_fn = lambda code: None
        return wd

    yield arm
    from torchmpi_tpu_torch import watchdog

    watchdog.reset()  # joins the monitor BEFORE the real exit comes back
    watchdog._exit_fn = os._exit
    for name in ("torchmpi_tpu_torch.faults", "torchmpi_tpu_torch.obs"):
        if name in sys.modules:
            sys.modules[name].reset()
    tmpi.stop()


# ---------------------------------------------------------------------------
# Config plumbing
# ---------------------------------------------------------------------------


def test_config_env_normalization(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHMPI_TPU_WATCHDOG", "1")
    monkeypatch.setenv("TORCHMPI_TPU_WATCHDOG_DEADLINE", "2.5")
    monkeypatch.setenv("TORCHMPI_TPU_WATCHDOG_DIR", str(tmp_path / "leases"))
    tmpi.stop()
    try:
        tmpi.init(tmpi.Config(), device="cpu")
        cfg = tmpi.runtime.config()
        assert cfg.watchdog == "break"  # boolean opt-in = everything
        assert cfg.watchdog_deadline_s == 2.5
        assert cfg.watchdog_dir == str(tmp_path / "leases")
        from torchmpi_tpu_torch import watchdog

        assert watchdog.active() and watchdog.mode() == "break"
        assert os.path.exists(watchdog.lease_path(str(tmp_path / "leases"),
                                                  0))
    finally:
        from torchmpi_tpu_torch import watchdog

        watchdog.reset()
        tmpi.stop()


def test_config_validation():
    tmpi.stop()
    with pytest.raises(ValueError, match="off|warn|break"):
        tmpi.init(device="cpu", watchdog="sometimes")
    with pytest.raises(ValueError, match="must be > 0"):
        tmpi.init(device="cpu", watchdog="warn", watchdog_deadline_s=0)
    tmpi.init(device="cpu")
    with pytest.raises(ValueError, match="off|warn|break"):
        tmpi.set_config(watchdog="x")
    with pytest.raises(ValueError, match="must be > 0"):
        tmpi.set_config(watchdog_deadline_s=-1)
    tmpi.stop()


# ---------------------------------------------------------------------------
# The monitor: stall flagging, the break ladder, deferred raise
# ---------------------------------------------------------------------------


def test_warn_mode_flags_and_clears(wd_runtime, tmp_path):
    watchdog = wd_runtime(watchdog="warn", obs="metrics",
                          obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    with pytest.warns(RuntimeWarning, match="stalled at slow.site"):
        tok = watchdog.begin("slow.site", op="allreduce", peer="gang")
        time.sleep(0.6)
    assert watchdog.stats()["stalled"] >= 1
    assert watchdog.stats()["broken"] == 0  # warn never intervenes
    watchdog.end(tok)
    reg = obs.registry()
    assert reg.counter_total("tm_watchdog_armed_total") >= 1
    assert reg.counter_total("tm_watchdog_stalled_total") >= 1
    assert reg.counter_total("tm_watchdog_cleared_total") >= 1
    evs = [e for e in obs.recorder().to_records() if e["ev"] == "watchdog"]
    assert any(e["backend"] == "slow.site"
               and e["detail"].startswith("stalled") for e in evs)


def test_break_ladder_cooperative(wd_runtime):
    watchdog = wd_runtime(watchdog="break", deadline_s=0.3)
    tok = watchdog.begin("wedged.site", op="reduce_scatter")
    time.sleep(0.35)  # past 1x, before 1.5x
    watchdog.check_break(tok)  # stalled but not yet broken: no raise
    assert watchdog.stats()["stalled"] >= 1
    time.sleep(0.2)  # past 1.5x
    with pytest.raises(watchdog.CollectiveHangError) as ei:
        watchdog.check_break(tok)
    watchdog.end(tok)
    e = ei.value
    assert e.site == "wedged.site" and e.op == "reduce_scatter"
    assert e.elapsed_s >= 0.45 and e.deadline_s == 0.3
    assert e.is_timeout and not e.transient
    assert watchdog.pending_count() == 0  # in-place raise consumed it
    # The fault policy reads it as the JAX package's: timeout-flavored,
    # never retried.
    from torchmpi_tpu_torch.faults import policy

    assert policy.is_timeoutish(e) and not policy.is_transient(e)


def test_deferred_raise_at_boundary(wd_runtime):
    watchdog = wd_runtime(watchdog="break", deadline_s=0.2)
    tok = watchdog.begin("background.site", op="ps_wait")
    time.sleep(0.45)
    # The next eager dispatch is the boundary: a direct rank-major call.
    with pytest.raises(watchdog.CollectiveHangError):
        tmpi.allreduce_rank_major(torch.ones(2, 3))
    watchdog.end(tok)
    watchdog.raise_pending()  # delivered + ended: nothing left
    tok2 = watchdog.begin("resolves.site")
    time.sleep(0.45)
    watchdog.end(tok2)  # the wait completed before any boundary ran
    watchdog.raise_pending()  # its queued break died with it


def test_softening_to_warn_disarms_pending_breaks(wd_runtime):
    watchdog = wd_runtime(watchdog="break", deadline_s=0.2)
    tok = watchdog.begin("background.site", op="ps_wait")
    deadline = time.monotonic() + 5.0
    while watchdog.pending_count() == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert watchdog.pending_count() == 1
    tmpi.set_config(watchdog="warn")
    assert watchdog.pending_count() == 0
    watchdog.raise_pending()   # no-op: nothing armed, mode gated
    watchdog.check_break(tok)  # likewise
    watchdog.end(tok)


def test_dead_ranks_ignores_previous_runs_leases(tmp_path):
    from torchmpi_tpu import watchdog as jwd
    from torchmpi_tpu_torch import watchdog

    d = str(tmp_path / "board")
    os.makedirs(d)
    stale = {"rank": 1, "pid": 1, "mode": "break", "deadline_s": 1.0,
             "ttl_s": 1.0, "ts": time.time() - 3600, "inflight": [],
             "stalled_total": 0, "broken_total": 0, "escalated": False}
    with open(watchdog.lease_path(d, 1), "w") as f:
        json.dump(stale, f)
    floor = time.time()
    assert watchdog.dead_ranks(d) == [1]          # raw read: expired
    assert watchdog.dead_ranks(d, newer_than=floor) == []  # floored
    fresh = dict(stale, ts=time.time(), escalated=True)
    with open(watchdog.lease_path(d, 1), "w") as f:
        json.dump(fresh, f)
    assert watchdog.dead_ranks(d, newer_than=floor) == [1]
    assert jwd.dead_ranks(d, newer_than=floor) == [1]
    assert jwd.read_leases(d) == watchdog.read_leases(d)


_ESCALATE = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    lease_dir = sys.argv[1]
    mpi.init(device="cpu", watchdog="break", watchdog_deadline_s=0.2,
             watchdog_poll_s=0.02, watchdog_dir=lease_dir)
    from torchmpi_tpu_torch import watchdog
    calls = []
    watchdog._exit_fn = calls.append  # observe instead of dying
    tok = watchdog.begin("compiled.region", op="allreduce")
    deadline = time.monotonic() + 10.0
    while not calls and time.monotonic() < deadline:
        time.sleep(0.02)
    assert calls and calls[0] == watchdog.ESCALATE_EXIT_CODE, calls
    assert watchdog.stats()["escalated"] >= 1
    lease = watchdog.read_leases(lease_dir)[0]
    assert lease["escalated"] is True
    assert watchdog.dead_ranks(lease_dir) == [0]
    watchdog.end(tok)
    # The real seam exits with the ladder's code.
    watchdog._exit_fn = os._exit
    tok = watchdog.begin("compiled.region", op="allreduce")
    time.sleep(10)
    print("NOT REACHED")
""").replace("REPO", repr(_REPO))


def test_escalation_exit_seam(tmp_path):
    """An unbreakable stall escalates at 2.5x the deadline through the
    clean-exit seam (patched, then real), tombstoning the lease so
    ``dead_ranks`` reports it; run in a subprocess, since the real seam
    exits the process."""
    lease_dir = str(tmp_path / "leases")
    out = subprocess.run([sys.executable, "-c", _ESCALATE, lease_dir],
                         capture_output=True, text=True, timeout=120,
                         cwd=_REPO)
    from torchmpi_tpu import watchdog as jwd
    from torchmpi_tpu_torch import watchdog

    assert out.returncode == watchdog.ESCALATE_EXIT_CODE == \
        jwd.ESCALATE_EXIT_CODE, out.stdout + out.stderr
    assert "NOT REACHED" not in out.stdout
    assert watchdog.dead_ranks(lease_dir) == jwd.dead_ranks(lease_dir) == [0]


# ---------------------------------------------------------------------------
# The `stall` fault kind through the port's call sites
# ---------------------------------------------------------------------------


def test_stall_breaks_staged_collective(wd_runtime, tmp_path):
    watchdog = wd_runtime([_stall_rule("host_staged.gather")],
                          watchdog="break", deadline_s=0.3, obs="metrics",
                          obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    x = torch.ones(8, 16)
    t0 = time.monotonic()
    with pytest.raises(watchdog.CollectiveHangError) as ei:
        tmpi.allreduce_rank_major(x, backend="host")
    assert time.monotonic() - t0 < 2.0  # ~1.5 x 0.3 s, not forever
    assert ei.value.site == "host_staged.gather"
    y = tmpi.allreduce_rank_major(x, backend="host")
    assert torch.equal(y, torch.full((8, 16), 8.0))
    reg = obs.registry()
    assert reg.counter_total("tm_watchdog_stalled_total") >= 1
    assert reg.counter_total("tm_watchdog_broken_total") >= 1
    # The enclosing host_staged window unwound through the hold's break:
    # not a stall that "resolved on its own".
    assert reg.counter_total("tm_watchdog_cleared_total") == 0


def test_stall_wedges_without_watchdog_until_disarm(wd_runtime):
    wd_runtime([_stall_rule("host_staged.gather")], watchdog="off")
    done = []
    th = threading.Thread(
        target=lambda: done.append(tmpi.allreduce_rank_major(
            torch.ones(8, 4), backend="host")), daemon=True)
    th.start()
    th.join(0.7)
    assert th.is_alive() and not done  # wedged, nothing raised
    tmpi.set_config(faults="off")  # disarm: the hold releases
    th.join(10.0)
    assert not th.is_alive() and done


def test_wait_timeout_typed(wd_runtime, tmp_path):
    wd_runtime([_stall_rule("host_staged.gather")], watchdog="off",
               obs="metrics", obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch.faults.policy import PeerTimeoutError

    h = tmpi.async_.allreduce(torch.ones(8, 4), backend="host")
    t0 = time.monotonic()
    with pytest.raises(PeerTimeoutError) as ei:
        h.wait(timeout_s=0.4)
    assert 0.3 < time.monotonic() - t0 < 5.0
    assert ei.value.deadline_s == 0.4
    with pytest.raises(PeerTimeoutError):
        tmpi.collectives.wait_all([h], timeout_s=0.3)
    tmpi.set_config(faults="off")  # release the hold; the worker drains
    out = h.wait(timeout_s=30.0)
    assert torch.equal(out, torch.full((8, 4), 8.0))


def test_async_staged_stall_breaks_in_wait(wd_runtime):
    """A stall the async staged worker is wedged in, under break mode:
    the caller's ``wait()`` is a cooperative break point and raises the
    typed hang in place; the healed plan's next handle is clean."""
    watchdog = wd_runtime([_stall_rule("host_staged.gather")],
                          watchdog="break", deadline_s=0.2)
    h = tmpi.async_.allreduce(torch.ones(8, 4), backend="host")
    t0 = time.monotonic()
    with pytest.raises(watchdog.CollectiveHangError):
        h.wait()
    assert time.monotonic() - t0 < 5.0
    h2 = tmpi.async_.allreduce(torch.ones(8, 4), backend="host")
    assert torch.equal(h2.wait(timeout_s=10.0), torch.full((8, 4), 8.0))


# ---------------------------------------------------------------------------
# Leases + blame --live
# ---------------------------------------------------------------------------


def _blame_live(directory, tool=otool):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["blame", "--live", str(directory)])
    return rc, buf.getvalue()


def _both_live(directory):
    """(rc, text) of the port's tool and of JAX's on one lease dir, the
    lease ages ("renewed 0.1s ago") masked."""
    import re

    outs = [_blame_live(directory, t)
            for t in (otool, _load_script("obs_tool"))]
    return [(rc, re.sub(r"\d+\.\d+s ago", "Ns ago", out))
            for rc, out in outs]


def test_blame_live_names_stalled_rank(wd_runtime, tmp_path):
    lease_dir = str(tmp_path / "leases")
    watchdog = wd_runtime(watchdog="warn", deadline_s=0.25,
                          watchdog_dir=lease_dir)
    tok = watchdog.begin("runtime.barrier", op="step7", peer="member:1")
    time.sleep(0.55)
    rc, out = _blame_live(lease_dir)
    ours, theirs = _both_live(lease_dir)
    watchdog.end(tok)
    assert rc == 1, out
    assert "STALLED in runtime.barrier" in out and "op=step7" in out
    assert "member:1" in out
    assert ours[0] == theirs[0] == 1
    time.sleep(0.3)
    rc, out = _blame_live(lease_dir)
    assert rc == 0 and "all ranks healthy" in out, out
    assert _both_live(lease_dir)[0] == _both_live(lease_dir)[1]
    lease = watchdog.read_leases(lease_dir)[0]
    lease["ts"] -= 10 * lease["ttl_s"]
    watchdog.deactivate()
    with open(watchdog.lease_path(lease_dir, 0), "w") as f:
        json.dump(lease, f)
    rc, out = _blame_live(lease_dir)
    assert rc == 1 and "EXPIRED" in out and "implicated" in out, out
    ours, theirs = _both_live(lease_dir)
    assert ours == theirs


def test_blame_live_usage_errors(tmp_path):
    rc, out = _blame_live(tmp_path / "nothing_here")
    assert rc == 2
    os.makedirs(tmp_path / "empty")
    assert _blame_live(tmp_path / "empty")[0] == 2
    assert otool.main(["blame", "--live", str(tmp_path),
                       str(tmp_path)]) == 2


def test_deactivate_retracts_lease(wd_runtime, tmp_path):
    lease_dir = str(tmp_path / "leases")
    watchdog = wd_runtime(watchdog="warn", watchdog_dir=lease_dir)
    assert os.path.exists(watchdog.lease_path(lease_dir, 0))
    watchdog.deactivate()
    assert not os.path.exists(watchdog.lease_path(lease_dir, 0))
    assert watchdog.dead_ranks(lease_dir) == []


def test_reactivate_without_dir_disables_leases(wd_runtime, tmp_path):
    lease_dir = str(tmp_path / "leases")
    watchdog = wd_runtime(watchdog="warn", watchdog_dir=lease_dir)
    assert watchdog.lease_dir() == lease_dir
    watchdog.activate("warn", deadline_s=1.0, lease_dir=None)
    assert watchdog.lease_dir() is None


def test_wait_all_armed_drives_whole_batch(wd_runtime):
    from concurrent.futures import Future

    wd_runtime(watchdog="warn", deadline_s=5.0)
    f = Future()
    f.set_exception(RuntimeError("boom"))
    bad = tmpi.collectives.AsyncHandle(future=f, op="allreduce")
    good = tmpi.async_.allreduce(torch.ones(8, 4), backend="host")
    with pytest.raises(RuntimeError, match="boom"):
        tmpi.collectives.wait_all([bad, good])
    assert good.done  # the failing head did not strand the tail


# ---------------------------------------------------------------------------
# Flight-ring completion edges + blame's stuck-vs-done verdict
# ---------------------------------------------------------------------------


def test_completion_edges_recorded(wd_runtime, tmp_path):
    wd_runtime(watchdog="off", obs="metrics", obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    obs.reset()
    x = torch.ones(8, 8)
    tmpi.allreduce_rank_major(x)                  # planned direct
    tmpi.allreduce_rank_major(x, backend="host")  # planned staged
    tmpi.barrier()
    names = [e["ev"] for e in obs.recorder().to_records()]
    assert names.count("eager") == 2 and names.count("eager_done") == 2
    assert names.index("eager") < names.index("eager_done")
    assert "barrier" in names and "barrier_done" in names
    assert names.index("barrier") < names.index("barrier_done")


def _flight_file(path, host, events, backend="host"):
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "stream": "flight",
                            "host": host}) + "\n")
        for seq, (ev, op) in enumerate(events):
            f.write(json.dumps({"kind": "event", "seq": seq, "ts": seq,
                                "ev": ev, "op": op, "nbytes": 64,
                                "backend": backend, "detail": ""}) + "\n")
    return str(path)


@pytest.mark.parametrize("backend,last,needle", [
    ("host", ("eager", "allreduce"), "stuck INSIDE"),
    ("host", ("eager_done", "allreduce"), "never launched"),
    ("xla", ("eager_done", "allreduce"), "device execution"),
])
def test_blame_distinguishes_stuck_vs_done(tmp_path, backend, last, needle):
    common = [("eager", "allreduce"), ("eager_done", "allreduce")]
    a = _flight_file(tmp_path / "a.jsonl", "0", common + [last],
                     backend=backend)
    b = _flight_file(tmp_path / "b.jsonl", "1",
                     common + [last, ("eager", "broadcast"),
                               ("eager_done", "broadcast")],
                     backend=backend)
    outs = []
    for tool in (otool, _load_script("obs_tool")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(["blame", a, b])
        outs.append((rc, buf.getvalue()))
    rc, out = outs[0]
    assert rc == 1 and needle in out, out
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The chaos tool: the stall kind + recipe + summarize
# ---------------------------------------------------------------------------


def test_chaos_tool_stall(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    out = str(tmp_path / "stall.json")
    assert tool.main(["gen", "--out", out, "--seed", "5",
                      "--stall", "1:3:2"]) == 0
    with open(out) as f:
        plan = json.load(f)
    [rule] = plan["rules"]
    assert rule["kind"] == "stall" and rule["site"] == "elastic.member"
    assert rule["after"] == 3 * 2 + 1 and rule["max_hits"] == 1
    assert tool.main(["lint", out]) == 0
    capsys.readouterr()
    bad = _write_plan(tmp_path / "bad.json",
                      [{"site": "ps.request", "kind": "stall",
                        "delay_s": 1.0}])
    assert tool.main(["lint", bad]) == 1
    assert "indefinite" in capsys.readouterr().out
    dump = tmp_path / "metrics_host0.jsonl"
    with open(dump, "w") as f:
        f.write(json.dumps({"kind": "counter",
                            "name": "tm_watchdog_stalled_total",
                            "labels": {"site": "runtime.barrier"},
                            "value": 2}) + "\n")
    assert tool.main(["summarize", str(dump)]) == 0
    assert "tm_watchdog_stalled_total" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Off mode; the plans' record
# ---------------------------------------------------------------------------


def test_watchdog_off_never_imported_and_plans_record_it():
    """With the watchdog off nothing imports it (the faults probe of
    tests/test_torch_faults.py drives every surface; this one the
    watchdog's own knobs through set_config), and a plan built armed
    records it: the staged replay inside the window, the direct one past
    the boundary only."""
    code = textwrap.dedent("""
        import sys, torch
        import torchmpi_tpu_torch as mpi
        mpi.init(device='cpu')
        mpi.set_config(watchdog='off', watchdog_deadline_s=5.0)
        mpi.allreduce_rank_major(torch.ones(2, 4), backend='host')
        h = mpi.async_.allreduce(torch.ones(2, 4), backend='host')
        h.wait(timeout_s=10.0)
        mpi.barrier()
        assert 'torchmpi_tpu_torch.watchdog' not in sys.modules
        mpi.set_config(watchdog='warn')
        from torchmpi_tpu_torch import planner
        mpi.allreduce_rank_major(torch.ones(2, 4), backend='host')
        mpi.allreduce_rank_major(torch.ones(2, 4))
        rows = {r['kind']: r for r in planner.describe()}
        assert rows['eager-staged']['watchdog'], rows
        assert rows['eager']['watchdog'], rows
        mpi.set_config(watchdog='off')
        from torchmpi_tpu_torch import watchdog
        assert not watchdog.active()
        print('WD-OFF-OK')
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TORCHMPI_TPU_WATCHDOG")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=_REPO)
    assert out.returncode == 0 and "WD-OFF-OK" in out.stdout, \
        out.stdout + out.stderr


# ---------------------------------------------------------------------------
# Two processes (slow): a wedged gloo peer, named live and broken
# ---------------------------------------------------------------------------


_HANG_WORKER = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, REPO)
    import torch
    import torchmpi_tpu_torch as mpi
    rank, port, lease_dir, plan = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
    kw = dict(faults=plan, fault_backoff_s=0.01) if rank == 1 else {}
    mpi.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=2, watchdog="break",
             watchdog_deadline_s=1.0, watchdog_poll_s=0.02,
             watchdog_dir=lease_dir, **kw)
    from torchmpi_tpu_torch import watchdog
    watchdog._exit_fn = lambda code: None
    x = torch.ones(4, 3) * (rank + 1)
    mpi.barrier()
    if rank == 1:
        try:
            mpi.allreduce_rank_major(x, backend="host")
            print("CHECK rank=1 no-hang")
        except watchdog.CollectiveHangError as e:
            print(f"CHECK rank=1 hang-broken site={e.site}")
    total = mpi.allreduce(torch.ones(3) * (rank + 1))
    print("WATCHDOG-SUMMARY " + json.dumps(
        {"rank": rank, "total": total.tolist(), **watchdog.stats()}))
    mpi.barrier()
    watchdog.reset()
    mpi.stop()
""").replace("REPO", repr(_REPO))


@pytest.mark.slow
def test_two_process_hang_acceptance(tmp_path):
    """A seeded stall wedges rank 1 of a real 2-process gloo world at its
    staged allreduce while rank 0 waits in the next process-world
    collective; while it is wedged the leases name the stall live
    (``blame --live``), break mode converts it into a typed hang on rank
    1, and both ranks then finish the world's allreduce."""
    import socket

    worker = tmp_path / "worker.py"
    worker.write_text(_HANG_WORKER)
    lease_dir = str(tmp_path / "leases")
    plan = _write_plan(tmp_path / "plan.json",
                       [_stall_rule("host_staged.gather")])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), lease_dir, plan],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    live = None
    deadline = time.monotonic() + 120
    try:
        while live is None and time.monotonic() < deadline:
            if any(p.poll() is not None for p in procs):
                break
            if os.path.isdir(lease_dir):
                rc, out = _blame_live(lease_dir)
                if rc == 1 and "STALLED" in out:
                    live = out
                    break
            time.sleep(0.05)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert live is not None and "host_staged.gather" in live, (live, outs)
    assert "CHECK rank=1 hang-broken site=host_staged.gather" in outs[1]
    sums = [json.loads(ln[len("WATCHDOG-SUMMARY "):]) for o in outs
            for ln in o.splitlines() if ln.startswith("WATCHDOG-SUMMARY ")]
    assert [s["total"] for s in sums] == [[3.0, 3.0, 3.0]] * 2
    assert sums[1]["broken"] >= 1


# ---------------------------------------------------------------------------
# The elastic gang's seams (JAX test_watchdog.py :455, :476, :699)
# ---------------------------------------------------------------------------


def test_elastic_gang_adopts_board_for_leases(tmp_path, wd_runtime):
    """With no watchdog_dir / elastic_dir the gang's board is known only
    when the gang is built: ElasticGang adopts it as the lease home."""
    wd = wd_runtime(watchdog="warn", deadline_s=5.0, elastic="on")
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "gang")
    os.makedirs(d)
    assert wd.lease_dir() is None
    gang = elastic.ElasticGang(d, members=[0, 1, 2, 3], world_size=8)
    assert wd.lease_dir() == gang.board.directory
    assert os.path.exists(wd.lease_path(gang.board.directory, 0))


def test_set_config_preserves_adopted_lease_dir(tmp_path, wd_runtime):
    """A mid-run deadline tune must not orphan the adopted lease home."""
    wd = wd_runtime(watchdog="warn", deadline_s=5.0, elastic="on")
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "gang")
    os.makedirs(d)
    gang = elastic.ElasticGang(d, members=[0, 1], world_size=8)
    board = gang.board.directory
    assert wd.lease_dir() == board
    tmpi.set_config(watchdog_deadline_s=60.0)
    assert wd.lease_dir() == board
    assert os.path.exists(wd.lease_path(board, 0))


def _mlp_build(steps):
    """A data-parallel MLP, one rank-major row a member, its batch a
    function of (member, step): the trajectory depends on the view
    schedule only."""
    dim, hid, lr = 4, 8, 0.05

    def build(comm, view):
        members = view.members

        def init_fn():
            rng = np.random.RandomState(0)
            return {"w1": torch.from_numpy(
                        (rng.randn(dim, hid) * 0.3).astype(np.float32)),
                    "w2": torch.from_numpy(
                        (rng.randn(hid, 1) * 0.3).astype(np.float32)),
                    "losses": np.full((steps,), np.nan, np.float32)}

        def step_fn(state, i):
            grads, losses = [], []
            for m in members:
                rng = np.random.RandomState(10_000 + m * 97 + i)
                x = torch.from_numpy(rng.randn(8, dim).astype(np.float32))
                y = torch.from_numpy(rng.randn(8, 1).astype(np.float32))
                w1 = state["w1"].detach().requires_grad_()
                w2 = state["w2"].detach().requires_grad_()
                loss = torch.mean((torch.tanh(x @ w1) @ w2 - y) ** 2)
                grads.append(torch.autograd.grad(loss, [w1, w2]))
                losses.append(loss.detach())
            stacks = [torch.stack([g[k] for g in grads]) for k in (0, 1)]
            tmpi.parallel.gradsync.synchronize_gradients_rank_major(stacks)
            out = np.array(state["losses"])
            out[i] = float(torch.stack(losses).mean())
            return {"w1": state["w1"] - lr * stacks[0][0],
                    "w2": state["w2"] - lr * stacks[1][0], "losses": out}

        return init_fn, step_fn

    return build


def test_elastic_hang_shrinks_bit_identical(tmp_path, wd_runtime):
    """A stall on member 2's liveness check at step 3 (the ``--stall``
    recipe's shape, 4 members): the watchdog breaks the hold into a hang
    naming member:2, the poll reads it as death evidence, the gang shrinks
    to N-1 and finishes bit-identical to a clean N-1 run restored from the
    recovered step."""
    steps = 8
    d1 = str(tmp_path / "gang")
    os.makedirs(d1)
    wd_runtime([_stall_rule("elastic.member", after=3 * 4 + 2)],
               watchdog="break", deadline_s=0.3, elastic="on",
               obs="metrics", obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import elastic, obs

    obs.reset()
    state1, info1 = elastic.run_elastic(
        _mlp_build(steps), steps=steps, directory=d1, save_every=2,
        members=[0, 1, 2, 3], world_size=8)
    assert info1["shrinks"] == 1
    assert info1["view"].members == (0, 1, 3)
    assert obs.registry().counter_total("tm_watchdog_broken_total") >= 1
    r = info1["recovered_step"]
    assert 0 < r <= 3
    obs.deactivate()
    d2 = str(tmp_path / "clean")
    os.makedirs(d2)
    for f in os.listdir(d1):
        if f.startswith(f"ckpt_{r}_"):
            import shutil

            shutil.copy(os.path.join(d1, f), os.path.join(d2, f))
    tmpi.stop()
    sys.modules["torchmpi_tpu_torch.faults"].reset()
    tmpi.init(device="cpu", elastic="on")
    state2, info2 = elastic.run_elastic(
        _mlp_build(steps), steps=steps, directory=d2, save_every=2,
        members=[0, 1, 3], world_size=8)
    assert info2["recovered_step"] == r and info2["shrinks"] == 0
    assert np.array_equal(state1["losses"][r:], state2["losses"][r:])
    for k in ("w1", "w2"):
        assert torch.equal(state1[k], state2[k])
