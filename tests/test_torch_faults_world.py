"""The fault layer and the watchdog across two gloo processes (one run of
two processes for the whole module; every wait bounded).

Both ranks arm the same plan: drops at ``runtime.barrier`` (a barrier
attempt each an arrival, the gloo sync under the site deadline) and drops
and a corrupt at ``host_staged.*`` (each rank's rank-major staged allreduce,
then the world's sum of it).  Each rank holds its results bitwise to the
clean run of the same calls, and both ranks see the same fault events, as
the schedule is a hash of the seed, the site and the arrival.  Then rank 1
alone arms a ``stall`` at the barrier under ``watchdog="warn"``: rank 0
reads rank 1's lease until it shows the stalled window, snapshots the
lease directory (the JAX package's ``read_leases`` / ``dead_ranks`` read it
here as the port's do) and releases the stall through a file; both ranks
then leave the barrier.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import hashlib, json, os, shutil, sys, threading, time
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    import torchmpi_tpu_torch as mpi
    rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    res = {}

    def write_plan(name, rules):
        path = os.path.join(out_dir, f"{name}_{rank}.json")
        with open(path, "w") as f:
            json.dump({"version": 1, "seed": 5, "rules": rules}, f)
        return path

    mpi.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=2, fault_backoff_s=0.01,
             fault_deadline_s=30.0)
    x = (torch.arange(24, dtype=torch.float32).reshape(4, 6)
         * (rank + 1) + 0.25)

    def work():
        local = mpi.allreduce_rank_major(x, backend="host")
        total = mpi.allreduce(local[0])
        mpi.barrier()
        mpi.barrier()
        return local, total

    clean = work()
    plan = write_plan("chaos", [
        {"site": "runtime.barrier", "kind": "drop", "after": 1,
         "max_hits": 1},
        {"site": "host_staged.gather", "kind": "drop", "max_hits": 1},
        {"site": "host_staged.scatter", "kind": "corrupt", "max_hits": 1},
        {"site": "host_staged.*", "kind": "delay", "delay_s": 0.005,
         "max_hits": -1}])
    mpi.set_config(faults=plan)
    from torchmpi_tpu_torch import faults
    events = []
    decide = faults.plan().decide
    def traced(site):
        got = decide(site)
        if got is not None:
            events.append([site, got[1], got[0].kind])
        return got
    faults.plan().decide = traced
    got = work()
    res["bitwise"] = all(torch.equal(a, b) for a, b in zip(got, clean))
    res["events"] = events
    res["arrivals"] = {s: faults.plan().arrivals(s) for s in
                       ("runtime.barrier", "host_staged.gather",
                        "host_staged.scatter")}
    res["digest"] = hashlib.sha256(got[1].numpy().tobytes()).hexdigest()
    mpi.set_config(faults="off")

    # A stalled peer, flagged by its own lease and read by the other rank.
    lease_dir = os.path.join(out_dir, "leases")
    release = os.path.join(out_dir, "release")
    mpi.set_config(watchdog="warn", watchdog_deadline_s=0.3,
                   watchdog_poll_s=0.02, watchdog_dir=lease_dir)
    from torchmpi_tpu_torch import watchdog
    if rank == 1:
        mpi.set_config(faults=write_plan("stall", [
            {"site": "runtime.barrier", "kind": "stall"}]))

        def releaser():
            while not os.path.exists(release):
                time.sleep(0.01)
            faults.deactivate()  # the modeled wedge ends with the plan

        threading.Thread(target=releaser, daemon=True).start()
        t0 = time.monotonic()
        mpi.barrier()
        res["stalled_s"] = time.monotonic() - t0
        res["wd_stats"] = watchdog.stats()
    else:
        seen = None
        deadline = time.monotonic() + 60
        while seen is None and time.monotonic() < deadline:
            lease = watchdog.read_leases(lease_dir).get(1)
            if lease and any(e["stalled"] for e in lease["inflight"]):
                seen = lease
                shutil.copytree(lease_dir, os.path.join(out_dir, "snap"))
            else:
                time.sleep(0.01)
        res["seen"] = seen
        res["dead"] = watchdog.dead_ranks(os.path.join(out_dir, "snap"))
        open(release, "w").close()
        mpi.barrier()
    watchdog.reset()
    mpi.set_config(watchdog="off", faults="off")
    mpi.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mpi.stop()
""").replace("REPO", repr(_REPO))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("faults_world"))
    worker = os.path.join(out_dir, "worker.py")
    with open(worker, "w") as f:
        f.write(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(port),
                               out_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    res = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    yield out_dir, res
    shutil.rmtree(out_dir, ignore_errors=True)


def test_barrier_and_staged_faults_survive_bitwise(results):
    _, res = results
    for r in res:
        assert r["bitwise"], r
        # Two barriers, the second dropped once; one staged call whose
        # gather dropped once and whose scatter corrupted once.
        assert r["arrivals"] == {"runtime.barrier": 3,
                                 "host_staged.gather": 3,
                                 "host_staged.scatter": 2}, r["arrivals"]
    assert res[0]["digest"] == res[1]["digest"]


def test_both_ranks_inject_the_same_schedule(results):
    _, res = results
    assert res[0]["events"] == res[1]["events"]
    kinds = [e[2] for e in res[0]["events"]]
    assert kinds.count("drop") == 2 and kinds.count("corrupt") == 1


def test_stalled_peer_flagged_by_its_lease(results):
    out_dir, res = results
    seen = res[0]["seen"]
    assert seen is not None and seen["rank"] == 1
    stalled = [e for e in seen["inflight"] if e["stalled"]]
    assert {e["site"] for e in stalled} <= {"runtime.barrier"}
    assert any(e["op"] == "stall" for e in stalled) or \
        any(e["op"] == "torchmpi_tpu_barrier" for e in stalled)
    assert res[0]["dead"] == []  # fresh: the peer is alive, not dead
    assert res[1]["stalled_s"] >= 0.3
    assert res[1]["wd_stats"]["stalled"] >= 1
    # The JAX package reads the port's leases as the port does.
    from torchmpi_tpu import watchdog as jwd
    from torchmpi_tpu_torch import watchdog

    snap = os.path.join(out_dir, "snap")
    assert jwd.read_leases(snap) == watchdog.read_leases(snap)
    assert sorted(jwd.read_leases(snap)) == [0, 1]
    far = max(d["ts"] + d["ttl_s"] for d in jwd.read_leases(snap).values())
    assert jwd.dead_ranks(snap, now=far + 1) == \
        watchdog.dead_ranks(snap, now=far + 1) == [0, 1]
