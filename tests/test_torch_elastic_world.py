"""The port's elastic gang across real processes on the CPU (gloo): JAX's
two-process cases, tests/test_elastic.py:826 (a dead rank admitted back)
and :852 (the survivor shrinks alone, bitwise to a clean one-process run
from the recovered step), tests/test_partition.py:795 (under
``elastic_quorum="majority"`` an asymmetric board partition leaves one
lineage: the minority is fenced, parks and is admitted back, both sides
end bitwise equal and equal to a clean replay of the schedule) and :837
(the same plan with quorum off forks).  The shrink and the rejoin are
also held against the JAX package: its 2-member sim (JAX
tests/test_elastic.py's own ``_make_build``, the model the workers train)
under the same kill plan, the join posted where the port's survivor saw
it, gives the same recoveries and view, and the survivor's losses equal
JAX's within rtol 1e-6 (float32 summation order, as
tests/test_torch_elastic.py holds its sim cases).

One module-scoped set of processes: the four scenarios' workers
(tests/_torch_elastic_worker.py) start together once for the module, then
the two comparison runs; each case reads its scenario's summaries.
``slow``, as JAX marks these cases.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_elastic_worker.py")

pytestmark = pytest.mark.slow
STEPS = 10
LOSS_RTOL = 1e-6


def _kill_plan(path, rank, step, nranks, seed=3):
    with open(path, "w") as f:
        json.dump({"version": 1, "seed": seed, "note": "", "rules": [
            {"site": "elastic.member", "kind": "fail", "prob": 1.0,
             "after": step * nranks + rank, "max_hits": 1}]}, f)
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(mode, directory, extra, n):
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, _WORKER, str(i), str(n), port, mode, directory]
        + list(extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n)]


def _finish(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    return outs


def _summaries(outs, tag):
    got = {}
    for o in outs:
        for ln in o.splitlines():
            if ln.startswith(tag + " "):
                d = json.loads(ln[len(tag) + 1:])
                got[d["rank"]] = d
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_world")
    from torchmpi_tpu_torch.faults import tool

    plan_kill = _kill_plan(root / "kill.json", 1, 4, 2)
    plan_part = str(root / "partition.json")
    assert tool.main(["gen", "--out", plan_part, "--seed", "3",
                      "--partition", "~0:4:18"]) == 0
    dirs = {k: str(root / k) for k in ("shrink", "rejoin", "quorum_on",
                                       "quorum_off")}
    for d in dirs.values():
        os.makedirs(d)
    started = {
        "shrink": _start("elastic", dirs["shrink"], [plan_kill], 2),
        "rejoin": _start("elastic-rejoin", dirs["rejoin"], [plan_kill], 2),
        "quorum_on": _start("partition", dirs["quorum_on"],
                            [plan_part, "on"], 2),
        "quorum_off": _start("partition", dirs["quorum_off"],
                             [plan_part, "off"], 2)}
    outs = {k: _finish(v) for k, v in started.items()}
    out = {"dirs": dirs, "outs": outs,
           "elastic": {k: _summaries(outs[k], "ELASTIC-SUMMARY")
                       for k in ("shrink", "rejoin")},
           "partition": {k: _summaries(outs[k], "PARTITION-SUMMARY")
                         for k in ("quorum_on", "quorum_off")}}
    # The comparison runs: a clean one-process run from the survivor's
    # recovered step, and a clean replay of the majority's schedule.
    r = out["elastic"]["shrink"][0]["recovered_step"]
    clean_dir = str(root / "clean")
    os.makedirs(clean_dir)
    for f in os.listdir(dirs["shrink"]):
        if f.startswith(f"ckpt_{r}_"):
            shutil.copy(os.path.join(dirs["shrink"], f),
                        os.path.join(clean_dir, f))
    out["clean"] = _summaries(_finish(_start("clean", clean_dir, [], 1)),
                              "ELASTIC-SUMMARY").get(0)
    r0 = out["partition"]["quorum_on"].get(0)
    out["replay"] = None
    if r0 is not None and len(r0["recoveries"]) == 3:
        start, c1, b = r0["recoveries"]
        sched = json.dumps([[start, [0, 1]], [c1, [0]], [b, [0, 1]]])
        out["replay"] = _summaries(
            _finish(_start("replay", str(root / "replay"), [sched], 1)),
            "PARTITION-SUMMARY").get(0)
    return out


def test_two_process_elastic_rejoin(runs):
    outs = runs["outs"]["rejoin"]
    assert any("CHECK rank=1 member-death ok" in o for o in outs), outs
    assert any("CHECK rank=1 admitted" in o for o in outs), outs
    by_rank = runs["elastic"]["rejoin"]
    assert set(by_rank) == {0, 1}, outs
    assert by_rank[0]["shrinks"] == 1 and by_rank[0]["rejoins"] == 1
    assert by_rank[0]["members"] == by_rank[1]["members"] == [0, 1]
    assert by_rank[0]["world_size"] == by_rank[1]["world_size"] == 2
    assert by_rank[0]["losses_digest"] == by_rank[1]["losses_digest"]
    assert by_rank[0]["params_digest"] == by_rank[1]["params_digest"]


def test_two_process_elastic_shrink(runs):
    outs = runs["outs"]["shrink"]
    summary = runs["elastic"]["shrink"].get(0)
    assert summary is not None, outs
    assert summary["shrinks"] >= 1 and summary["elastic_shrink_total"] >= 1
    assert summary["members"] == [0] and summary["world_size"] == 1
    assert any("CHECK rank=1 member-death ok" in o for o in outs), outs
    clean = runs["clean"]
    assert clean is not None
    assert clean["recovered_step"] == summary["recovered_step"]
    assert clean["losses_digest"] == summary["losses_digest"]
    assert clean["params_digest"] == summary["params_digest"]


def test_two_process_partition_one_lineage(runs):
    by_rank = runs["partition"]["quorum_on"]
    assert set(by_rank) == {0, 1}, runs["outs"]["quorum_on"]
    r0, r1 = by_rank[0], by_rank[1]
    assert r0["shrinks"] == 1 and r0["rejoins"] == 1 and r0["parks"] == 0
    assert r1["parks"] == 1 and r1["shrinks"] == 0
    assert r1["quorum_lost_total"] >= 1 and r1["parked_total"] >= 1
    assert r1["fenced_total"] >= 1 and r1["healed_total"] >= 1
    assert r0["members"] == r1["members"] == [0, 1]
    assert r0["epoch"] == r1["epoch"]
    assert r0["losses_digest"] == r1["losses_digest"]
    assert r0["params_digest"] == r1["params_digest"]
    clean = runs["replay"]
    assert clean is not None, r0
    assert clean["losses_digest"] == r0["losses_digest"]
    assert clean["params_digest"] == r0["params_digest"]


def test_two_process_partition_forks_without_quorum(runs):
    from torchmpi_tpu_torch.faults import membership

    by_rank = runs["partition"]["quorum_off"]
    assert set(by_rank) == {0, 1}, runs["outs"]["quorum_off"]
    r0, r1 = by_rank[0], by_rank[1]
    assert r0["shrinks"] == 1 and r0["members"] == [0]
    assert r1["shrinks"] == 0 and r1["members"] == [0, 1]
    assert r0["epoch"] > r1["epoch"]
    assert r0["parks"] == 0 and r1["parks"] == 0
    assert r1["fenced_total"] == 0
    assert r0["losses_digest"] != r1["losses_digest"]
    board = membership.Board(os.path.join(runs["dirs"]["quorum_off"],
                                          "membership"))
    assert board.committed_view().members == (0,)
    assert board.committed_view().epoch == r0["epoch"]


def _jax_elastic(directory, plan, join_at=None, shrunk_at=None):
    """JAX's sim of the workers' gang: members (0, 1) under ``plan``; with
    ``join_at``, member 1 asks to rejoin where the port's survivor grew:
    as the shrunk gang forms when ``join_at`` is its recovered step
    ``shrunk_at`` (the joiner was back before a step ran alone), else once
    step ``join_at - 1`` ran alone."""
    import torchmpi_tpu as jmpi
    from torchmpi_tpu import elastic as jel
    from torchmpi_tpu.faults import membership as jmem

    import test_elastic as jte

    base = jte._make_build(STEPS)

    def join():
        jmem.Board(os.path.join(directory, "membership")).request_join(1)

    def build(mesh, view):
        init_fn, step_fn = base(mesh, view)
        if view.members == (0,) and join_at is not None \
                and join_at == shrunk_at:
            join()

        def step(state, i):
            out = step_fn(state, i)
            if view.members == (0,) and i + 1 == join_at:
                join()
            return out

        return init_fn, step

    os.makedirs(directory)
    jmpi.stop()
    jmpi.init(jmpi.Config(elastic="on", faults=plan))
    try:
        return jel.run_elastic(build, steps=STEPS, directory=directory,
                               save_every=2, members=[0, 1], world_size=8)
    finally:
        if "torchmpi_tpu.faults" in sys.modules:
            sys.modules["torchmpi_tpu.faults"].reset()
        jmpi.stop()


@pytest.mark.parametrize("case", ["shrink", "rejoin"])
def test_two_process_elastic_matches_jax(runs, tmp_path, case):
    survivor = runs["elastic"][case].get(0)
    assert survivor is not None, runs["outs"][case]
    rec = survivor["recoveries"]
    jstate, jinfo = _jax_elastic(
        str(tmp_path / "jax"), _kill_plan(tmp_path / "kill.json", 1, 4, 2),
        join_at=rec[2] if case == "rejoin" else None, shrunk_at=rec[1])
    assert jinfo["recoveries"] == rec
    assert jinfo["shrinks"] == survivor["shrinks"]
    assert jinfo["rejoins"] == survivor["rejoins"]
    assert list(jinfo["view"].members) == survivor["members"]
    np.testing.assert_allclose(np.array(survivor["losses"], np.float32),
                               jstate["losses"], rtol=LOSS_RTOL, atol=0)
