"""The recovery agreement across two gloo processes (one run of two
processes for the whole module; every wait bounded).

Each process saves its own files (``ckpt_<step>_p<rank>``) in one shared
directory and the processes agree through ``checkpoint.agree_min_step``,
an all-reduce MIN over the world's process group:

- step 6 lands on rank 0 only (a crash between the two saves): both
  restore step 4, the newest step they share;
- rank 1's newest file rots with ``ckpt_redundancy="off"``: rank 1's
  restore fails, the success flag is agreed, and both walk back to the
  step below together;
- no step in common: a collective fresh start;
- ``restore_sharded`` of each process's own shard (``Sharded.local``)
  agrees on the newest complete sharded step both hold;
- ``run_with_restarts`` with one crash on both ranks at the same step:
  both recover to the same step and end bitwise on a clean run.
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
    import json, os, sys
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.utils import checkpoint, restart
    rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mpi.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=2)
    res = {}

    def tree(v):
        return {"w": torch.full((4,), float(v)), "r": np.int64(rank)}

    def init_fn():
        return tree(0)

    def d(name):
        path = os.path.join(out_dir, name)
        os.makedirs(path, exist_ok=True)
        return path

    # (a) step 6 on rank 0 only.
    a = d("a")
    for s in (2, 4):
        checkpoint.save(a, tree(s), step=s)
    if rank == 0:
        checkpoint.save(a, tree(6), step=6)
    mpi.barrier()
    state, step = restart.recover(init_fn, a, init_fn())
    res["a"] = [step, float(state["w"][0]), int(state["r"])]

    # (b) rank 1's newest file rots, redundancy off.
    b = d("b")
    for s in (3, 5):
        checkpoint.save(b, tree(s), step=s)
    mpi.barrier()
    if rank == 1:
        with open(os.path.join(b, "ckpt_5_p1.npz"), "r+b") as f:
            f.seek(40)
            f.write(b"\\x00" * 64)
    mpi.barrier()
    state, step = restart.recover(init_fn, b, init_fn())
    res["b"] = [step, float(state["w"][0])]

    # (c) no step in common.
    c = d("c")
    checkpoint.save(c, tree(7), step=7 if rank == 0 else 8)
    mpi.barrier()
    state, step = restart.recover(init_fn, c, init_fn())
    res["c"] = [step, float(state["w"][0])]

    # (d) sharded: each process its own shard; step 9 on rank 1 only.
    e = d("e")
    full = torch.arange(8.0)
    for s in (5, 7):
        checkpoint.save_sharded(e, {"m": checkpoint.Sharded.local(
            full[rank * 4:(rank + 1) * 4] * s, rank, 2)}, step=s)
    if rank == 1:
        checkpoint.save_sharded(e, {"m": checkpoint.Sharded.local(
            full[4:] * 9, rank, 2)}, step=9)
    mpi.barrier()
    tmpl = {"m": checkpoint.Sharded.local(
        torch.empty(4, device="meta"), rank, 2).template()}
    got = checkpoint.restore_sharded(e, tmpl)
    res["d"] = got["m"].shards[0].tolist()

    # (e) the restart loop, one crash on both ranks at step 3.
    def step_fn_of(crash):
        done = []

        def step_fn(state, i):
            if crash and i == 3 and not done:
                done.append(i)
                raise RuntimeError("injected crash")
            return {"w": state["w"] * 1.25 + (i + rank), "r": state["r"]}

        return step_fn

    final, info = restart.run_with_restarts(
        init_fn, step_fn_of(True), steps=6, directory=d("f"), save_every=2)
    clean, _ = restart.run_with_restarts(
        init_fn, step_fn_of(False), steps=6, directory=d("g"), save_every=2)
    res["e"] = [info, torch.equal(final["w"], clean["w"])]
    mpi.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mpi.stop()
""").replace("REPO", repr(_REPO))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("restart_world"))
    worker = os.path.join(out_dir, "worker.py")
    with open(worker, "w") as f:
        f.write(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TORCHMPI_TPU_")}
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(port),
                               out_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
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


def test_step_on_one_rank_only_restores_newest_shared(results):
    _, res = results
    for r, got in enumerate(res):
        assert got["a"] == [4, 4.0, r]


def test_rotted_file_on_one_rank_walks_back_together(results):
    _, res = results
    assert res[0]["b"] == res[1]["b"] == [3, 3.0]


def test_no_common_step_is_a_collective_fresh_start(results):
    _, res = results
    assert res[0]["c"] == res[1]["c"] == [0, 0.0]


def test_sharded_restore_agrees_on_the_min_step(results):
    _, res = results
    assert res[0]["d"] == [0.0, 7.0, 14.0, 21.0]
    assert res[1]["d"] == [28.0, 35.0, 42.0, 49.0]


def test_restart_loop_on_both_ranks(results):
    _, res = results
    for got in res:
        info, bitwise = got["e"]
        assert info == {"restarts": 1, "restarts_used": 1, "steps_run": 7,
                        "recovered_step": 2}
        assert bitwise
