"""The port's membership board and two-phase reconcile
(torchmpi_tpu_torch/faults/membership.py) against the JAX package's on the
CPU: JAX's tests/test_elastic.py:43-130 (the six board cases) and
tests/test_partition.py from :137 on (the board mask, the quorum rule,
the fork against the single lineage, board trouble, the fence on the board
and the checkpoint seam, the recovery-agreement gate, the park / heal /
resume round trip and the quorum-off contrast, the staging reaper, the
``parked`` lease through ``blame --live``, the chaos tool's partition
recipe and summary against JAX's tool, the elastic_quorum knob); its
two process cases are in tests/test_torch_elastic_world.py.  Each board
scenario runs through both packages and the views they commit must be
equal; one board is written half by each package (ranks 0-1 by JAX's
``Board``, 2-3 by the port's) and both commit one view."""

import contextlib
import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import faults as jfaults
from torchmpi_tpu.faults import membership as jmem
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import faults as tfaults
from torchmpi_tpu_torch.faults import membership as tmem

from _torch_world import module_group

torch.set_num_threads(2)
PKGS = {"torch": (tmem, tfaults), "jax": (jmem, jfaults)}


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture(autouse=True)
def fresh():
    tmpi.stop()
    yield
    for f in (tfaults, jfaults):
        f.reset()
    for name in ("torchmpi_tpu_torch.faults.fencing",
                 "torchmpi_tpu.faults.fencing"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.disarm()
    wd = sys.modules.get("torchmpi_tpu_torch.watchdog")
    if wd is not None:
        wd.reset()
    tmpi.stop()
    jmpi.stop()


def _both(fn, tmp_path):
    """``fn(mem, directory)`` through each package on its own board; the
    two results."""
    out = {}
    for name, (mem, _) in PKGS.items():
        out[name] = fn(mem, str(tmp_path / name))
    return out["torch"], out["jax"]


def _js(view):
    return None if view is None else view.to_json()


# ---------------------------------------------------------------------------
# JAX tests/test_elastic.py:43-130
# ---------------------------------------------------------------------------


def test_membership_two_phase_reconcile(tmp_path):
    def run(mem, d):
        board = mem.Board(d)
        v1 = mem.reconcile(board, [0, 1, 2], [0, 1, 2], epoch=1, step=0,
                           deadline_s=2, poll_s=0.01)
        assert board.committed_view() == v1
        v2 = mem.reconcile(board, [0, 1], [0, 1], epoch=v1.epoch + 1,
                           step=5, deadline_s=2, poll_s=0.01)
        assert board.committed_view() == v2
        assert mem.MembershipView.from_json(v2.to_json()) == v2
        return [_js(v1), _js(v2)]

    t, j = _both(run, tmp_path)
    assert t == j
    assert t[1] == {"epoch": 2, "members": [0, 1], "step": 5}


def test_membership_bounded_drop(tmp_path):
    def run(mem, d):
        board = mem.Board(d)
        v = mem.reconcile(board, [0], [0, 1, 2], epoch=1, step=3,
                          deadline_s=0.25, poll_s=0.01)
        assert board.committed_view() == v
        return _js(v)

    t, j = _both(run, tmp_path)
    assert t == j and t["members"] == [0] and t["epoch"] > 1


def test_membership_grow_without_joiner_vote(tmp_path):
    def run(mem, d):
        board = mem.Board(d)
        v1 = mem.reconcile(board, [0, 1], [0, 1], epoch=1, step=0,
                           deadline_s=2, poll_s=0.01)
        v2 = mem.reconcile(board, [0, 1], [0, 1, 2], epoch=v1.epoch + 1,
                           step=7, voters=[0, 1], deadline_s=2, poll_s=0.01)
        assert board.committed_view() == v2
        return _js(v2)

    t, j = _both(run, tmp_path)
    assert t == j == {"epoch": 2, "members": [0, 1, 2], "step": 7}


def test_membership_step_disagreement_resolves_min(tmp_path):
    def run(mem, d):
        board = mem.Board(d)
        results = {}

        def go(rank, step):
            results[rank] = mem.reconcile(board, [rank], [0, 1], epoch=1,
                                          step=step, deadline_s=5,
                                          poll_s=0.005)

        ts = [threading.Thread(target=go, args=(0, 5)),
              threading.Thread(target=go, args=(1, 7))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=10)
        assert results[0] == results[1] == board.committed_view()
        return _js(results[0])

    t, j = _both(run, tmp_path)
    assert t["step"] == j["step"] == 5
    assert t["members"] == j["members"] == [0, 1]


def test_membership_dropped_rank_raises(tmp_path):
    for mem, _ in PKGS.values():
        board = mem.Board(str(tmp_path / mem.__name__))
        with pytest.raises(mem.ReconcileDropped):
            mem.reconcile(board, [5], [0, 1], epoch=1, step=0,
                          deadline_s=0.2, poll_s=0.01)


def test_membership_agree_min_and_join(tmp_path):
    def run(mem, d):
        board = mem.Board(d)
        a = mem.agree_min(board, "t0", [0, 1], [0, 1], 7, deadline_s=1,
                          poll_s=0.01)
        board.post_value("t1", 1, 3)
        b = mem.agree_min(board, "t1", [0], [0, 1], 9, deadline_s=1,
                          poll_s=0.01)
        with pytest.raises(mem.ReconcileTimeout):
            mem.agree_min(board, "t2", [0], [0, 1], 1, deadline_s=0.2,
                          poll_s=0.01)
        board.request_join(4)
        joins = board.join_requests()
        board.clear_join(4)
        return a, b, joins, board.join_requests()

    t, j = _both(run, tmp_path)
    assert t == j == (7, 3, [4], [])


def test_mixed_board_commits_one_view(tmp_path):
    """One board, two packages: JAX's Board speaks for ranks 0-1, the
    port's for 2-3, each rank reconciling on its own thread; every rank
    commits the same view, and both packages read it back (the files are
    the same names, keys and JSON)."""
    d = str(tmp_path / "board")
    boards = {r: (jmem if r < 2 else tmem).Board(d, reader_rank=r)
              for r in range(4)}
    results = {}

    def go(r):
        mem = jmem if r < 2 else tmem
        results[r] = mem.reconcile(boards[r], [r], [0, 1, 2, 3], epoch=1,
                                   step=4, deadline_s=5, poll_s=0.005)

    ts = [threading.Thread(target=go, args=(r,)) for r in range(4)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=20)
    views = {r: _js(v) for r, v in results.items()}
    assert len(views) == 4
    assert all(v == {"epoch": 1, "members": [0, 1, 2, 3], "step": 4}
               for v in views.values()), views
    assert _js(tmem.Board(d).committed_view()) == \
        _js(jmem.Board(d).committed_view()) == views[0]
    # A shrink voted by both packages again: ranks 0 (JAX) and 3 (port).
    results.clear()

    def go2(r):
        mem = jmem if r < 2 else tmem
        results[r] = mem.reconcile(boards[r], [r], [0, 3], epoch=2,
                                   step=6, deadline_s=5, poll_s=0.005)

    ts = [threading.Thread(target=go2, args=(r,)) for r in (0, 3)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=20)
    assert _js(results[0]) == _js(results[3]) == {
        "epoch": 2, "members": [0, 3], "step": 6}
    assert sorted(os.listdir(d)) == sorted(
        f"{p}_{e}_{r}.json" for p in ("propose", "commit")
        for e, rs in ((1, range(4)), (2, (0, 3))) for r in rs)


# ---------------------------------------------------------------------------
# JAX tests/test_partition.py from :137
# ---------------------------------------------------------------------------


def _write_plan(path, rules, seed=7):
    with open(path, "w") as f:
        json.dump({"version": 1, "seed": seed, "rules": rules}, f)
    return str(path)


def _partition_rule(ranks, after=0, heal=-1, site="board.read"):
    return {"site": site, "kind": "partition", "ranks": ranks,
            "after": after, "heal_after": heal}


def _armed(tmp_path, rules):
    """Arm the same plan in both packages' fault layers."""
    plan = _write_plan(tmp_path / "plan.json", rules)
    tfaults.activate(plan)
    jfaults.activate(plan)


def _mask_case(tmp_path, rule, scenario):
    _armed(tmp_path, [rule])
    return _both(scenario, tmp_path)


def test_board_mask_symmetric_and_self_exempt(tmp_path):
    def run(mem, d):
        b0 = mem.Board(d, reader_rank=0)
        b1 = mem.Board(d, reader_rank=1)
        raw = mem.Board(d)
        b0.note_step(0)
        b1.note_step(0)
        b0.heartbeat(0, epoch=1, step=0)
        b1.heartbeat(1, epoch=1, step=0)
        return (set(b0.heartbeats()), set(b1.heartbeats()),
                set(raw.heartbeats()))

    t, j = _mask_case(tmp_path, _partition_rule("0|1"), run)
    assert t == j == ({0}, {1}, {0, 1})


def test_board_mask_one_way_asymmetric(tmp_path):
    def run(mem, d):
        b0 = mem.Board(d, reader_rank=0)
        b1 = mem.Board(d, reader_rank=1)
        b0.note_step(0)
        b1.note_step(0)
        b0.heartbeat(0, epoch=1, step=0)
        b1.heartbeat(1, epoch=1, step=0)
        return set(b0.heartbeats()), set(b1.heartbeats())

    t, j = _mask_case(tmp_path, _partition_rule("~1"), run)
    assert t == j == ({0, 1}, {1})


def test_board_mask_window_and_heal_clock(tmp_path):
    def run(mem, d):
        b0 = mem.Board(d, reader_rank=0)
        writer = mem.Board(d)
        writer.heartbeat(1, epoch=1, step=0)
        seen = [set(b0.heartbeats())]
        b0.note_step(3)
        seen.append(set(b0.heartbeats()))
        writer.heartbeat(1, epoch=1, step=6)
        seen.append(set(b0.heartbeats()))
        return seen

    t, j = _mask_case(tmp_path, _partition_rule("1", after=3, heal=6), run)
    assert t == j == [{1}, set(), {1}]


def test_quorum_rule_matrix():
    cases = [([0, 1, 2], [0, 1, 2, 3]), ([3], [0, 1, 2, 3]),
             ([], [0, 1, 2, 3]), ([0, 1], [0, 1, 2, 3]),
             ([2, 3], [0, 1, 2, 3]), ([5, 6], []), ([0, 1], [0, 1, 2]),
             ([2], [0, 1, 2])]
    got = [tmem.has_quorum(v, q) for v, q in cases]
    assert got == [jmem.has_quorum(v, q) for v, q in cases]
    assert got == [True, False, False, True, False, True, True, False]


def test_reconcile_quorum_minority_raises(tmp_path):
    def run(mem, d):
        board = mem.Board(d)
        with pytest.raises(mem.QuorumLost) as ei:
            mem.reconcile(board, [3], [3], epoch=2, step=5,
                          quorum_of=[0, 1, 2, 3], deadline_s=1, poll_s=0.01)
        assert board.proposals(2) == {} and board.commits(2) == {}
        v = mem.reconcile(board, [0, 1], [0, 1], epoch=2, step=5,
                          quorum_of=[0, 1, 2, 3], deadline_s=1, poll_s=0.01)
        return ei.value.voters, ei.value.quorum_of, str(ei.value), _js(v)

    t, j = _both(run, tmp_path)
    assert t == j
    assert t[:2] == ((3,), (0, 1, 2, 3))
    assert t[3] == {"epoch": 2, "members": [0, 1], "step": 5}


def _split_brain(mem, d, quorum_of):
    b0 = mem.Board(d, reader_rank=0)
    b1 = mem.Board(d, reader_rank=1)
    for b in (b0, b1):
        b.note_step(0)
    results = {}

    def run(board, rank):
        try:
            results[rank] = mem.reconcile(board, [rank], [rank], epoch=2,
                                          step=5, quorum_of=quorum_of,
                                          deadline_s=2, poll_s=0.01)
        except mem.MembershipError as e:
            results[rank] = e

    ts = [threading.Thread(target=run, args=(b0, 0)),
          threading.Thread(target=run, args=(b1, 1))]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=20)
    raw = mem.Board(d)
    payloads = {tuple(p["members"]) for p in raw.commits(2).values()}
    return ({r: (type(v).__name__ if isinstance(v, Exception) else _js(v))
             for r, v in results.items()}, payloads,
            _js(raw.committed_view()))


def test_reconcile_fork_vs_single_lineage(tmp_path):
    _armed(tmp_path, [_partition_rule("0|1")])
    t, j = _both(lambda mem, d: (_split_brain(mem, d + "f", None),
                                 _split_brain(mem, d + "l", [0, 1])),
                 tmp_path)
    assert t == j
    fork, lineage = t
    assert fork[0][0]["members"] == [0] and fork[0][1]["members"] == [1]
    assert fork[1] == {(0,), (1,)}
    assert lineage[0][1] == "QuorumLost" and lineage[1] == {(0,)}
    assert lineage[2]["members"] == [0]


def test_double_death_partition_interplay(tmp_path):
    _armed(tmp_path, [_partition_rule("0,1|2,3,4")])

    def run(mem, d):
        prior = [0, 1, 2, 3, 4]
        b_small = mem.Board(d, reader_rank=0)
        b_big = mem.Board(d, reader_rank=2)
        for b in (b_small, b_big):
            b.note_step(0)
        with pytest.raises(mem.QuorumLost):
            mem.reconcile(b_small, [0, 1], [0, 1], epoch=2, step=3,
                          quorum_of=prior, deadline_s=1, poll_s=0.01)
        with pytest.raises(mem.QuorumLost):
            mem.reconcile(b_big, [2, 3], [2, 3], epoch=2, step=3,
                          quorum_of=prior, deadline_s=1, poll_s=0.01)
        return _js(mem.reconcile(b_big, [2, 3, 4], [2, 3, 4], epoch=2,
                                 step=3, quorum_of=prior, deadline_s=1,
                                 poll_s=0.01))

    t, j = _both(run, tmp_path)
    assert t == j and t["members"] == [2, 3, 4]


def test_board_trouble_is_not_voter_silence(tmp_path):
    _armed(tmp_path, [{"site": "board.read", "kind": "drop", "prob": 1.0,
                       "after": 0, "max_hits": 25}])

    def run(mem, d):
        board = mem.Board(d, reader_rank=0)
        return _js(mem.reconcile(board, [0, 1], [0, 1], epoch=1, step=0,
                                 deadline_s=0.25, poll_s=0.02))

    t, j = _both(run, tmp_path)
    assert t == j == {"epoch": 1, "members": [0, 1], "step": 0}


def test_board_unreadable_exhausts_with_typed_timeout(tmp_path):
    _armed(tmp_path, [{"site": "board.read", "kind": "drop", "prob": 1.0,
                       "after": 0, "max_hits": -1}])
    for mem, _ in PKGS.values():
        board = mem.Board(str(tmp_path / mem.__name__), reader_rank=0)
        with pytest.raises(mem.ReconcileTimeout, match="board unreadable"):
            mem.reconcile(board, [0, 1], [0, 1], epoch=1, step=0,
                          deadline_s=0.1, poll_s=0.02)


def test_fence_rejects_stale_board_writes(tmp_path):
    """The port's fence on the port's board, the other rank's commit
    written by JAX's board into the same directory."""
    from torchmpi_tpu_torch.faults import fencing

    d = str(tmp_path / "board")
    board = tmem.Board(d, reader_rank=0)
    fence = fencing.arm(board, 0, epoch=1)
    other = jmem.Board(d, reader_rank=1)
    jmem.reconcile(other, [1], [1], epoch=2, step=7, deadline_s=1,
                   poll_s=0.01)
    with pytest.raises(fencing.FencedWriterError) as ei:
        board.heartbeat(0, epoch=1, step=9)
    assert ei.value.committed_epoch == 2 and ei.value.writer_epoch == 1
    assert not os.path.exists(os.path.join(d, "hb_0.json"))
    with pytest.raises(fencing.FencedWriterError):
        board.propose(1, 0, [0, 1], 9)
    board.propose(3, 0, [0, 1], 9)
    assert 0 in jmem.Board(d).proposals(3)
    board.heartbeat(0, epoch=-1, step=9)
    assert 0 in jmem.Board(d).heartbeats()
    fence.update(2)
    board.heartbeat(0, epoch=2, step=9)


def test_fence_rejects_stale_checkpoint_save(tmp_path):
    from torchmpi_tpu_torch.faults import fencing
    from torchmpi_tpu_torch.utils import checkpoint

    d = str(tmp_path / "board")
    board = tmem.Board(d, reader_rank=0)
    fence = fencing.arm(board, 0, epoch=1)
    other = tmem.Board(d, reader_rank=1)
    tmem.reconcile(other, [1], [1], epoch=2, step=7, deadline_s=1,
                   poll_s=0.01)
    ckpt_dir = str(tmp_path / "ckpt")
    state = {"w": torch.arange(6, dtype=torch.float32)}
    with pytest.raises(fencing.FencedWriterError):
        checkpoint.save(ckpt_dir, state, step=5)
    with pytest.raises(fencing.FencedWriterError):
        checkpoint.save_async(ckpt_dir, state, step=5)
    assert checkpoint.latest_step(ckpt_dir) is None
    fence.update(2)
    checkpoint.save(ckpt_dir, state, step=5)
    assert checkpoint.latest_step(ckpt_dir) == 5
    fencing.disarm()
    checkpoint.save(ckpt_dir, state, step=6)
    assert checkpoint.latest_step(ckpt_dir) == 6


def test_agreement_gate_refuses_stale_minority(tmp_path):
    tmpi.init(device="cpu", elastic="on", elastic_quorum="majority")
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    gang = elastic.ElasticGang(d, members=[0, 1], world_size=8)
    other = tmem.Board(os.path.join(d, "membership"), reader_rank=1)
    tmem.reconcile(other, [1], [1], epoch=gang.view.epoch + 1, step=7,
                   deadline_s=1, poll_s=0.01)
    with pytest.raises(tmem.QuorumLost):
        gang.agreement()(5)
    tmpi.stop()  # retracts the fence with the runtime
    assert sys.modules["torchmpi_tpu_torch.faults.fencing"].current() \
        is None


# -- the park / heal / resume round trip on one process ----------------------

STEPS = 12
DIM, H, B = 4, 8, 8
LR = 0.05


def _member_batch(m, step):
    rng = np.random.RandomState(10_000 + m * 97 + step)
    return (rng.randn(B, DIM).astype(np.float32),
            rng.randn(B, 1).astype(np.float32))


def _make_build(steps, sleep_s=0.0):
    """The compact data-parallel MLP of JAX test_partition.py:435, one
    rank-major row a member: the trajectory is a pure function of the
    view schedule."""

    def build(comm, view):
        members = view.members

        def init_fn():
            rng = np.random.RandomState(0)
            params = {"w1": torch.from_numpy(
                          (rng.randn(DIM, H) * 0.3).astype(np.float32)),
                      "b1": torch.zeros(H),
                      "w2": torch.from_numpy(
                          (rng.randn(H, 1) * 0.3).astype(np.float32))}
            return {"params": params,
                    "losses": np.full((steps,), np.nan, np.float32)}

        def step_fn(state, i):
            if sleep_s:
                time.sleep(sleep_s)
            p = state["params"]
            grads, losses = [], []
            for m in members:
                x, y = map(torch.from_numpy, _member_batch(m, i))
                leaves = {k: v.detach().requires_grad_() for k, v in
                          p.items()}
                h = torch.tanh(x @ leaves["w1"] + leaves["b1"])
                loss = torch.mean((h @ leaves["w2"] - y) ** 2)
                g = torch.autograd.grad(loss, list(leaves.values()))
                grads.append(g)
                losses.append(loss.detach())
            stacks = [torch.stack([g[k] for g in grads])
                      for k in range(len(p))]
            tmpi.parallel.gradsync.synchronize_gradients_rank_major(stacks)
            new = {k: v - LR * st[0] for (k, v), st in zip(p.items(),
                                                            stacks)}
            out = np.array(state["losses"])
            out[i] = float(tmpi.allreduce_rank_major(
                torch.stack(losses).reshape(-1, 1), op="mean")[0, 0])
            return {"params": new, "losses": out}

        return init_fn, step_fn

    return build


def _heal_when_parked(board_dir, stop, deadline=25.0):
    from torchmpi_tpu_torch import obs

    t0 = time.monotonic()
    while not stop.is_set() and time.monotonic() - t0 < deadline:
        if obs.registry().counter_total("tm_elastic_parked_total") >= 1:
            with open(os.path.join(board_dir, "hb_9.json"), "w") as f:
                json.dump({"rank": 9, "epoch": -1, "step": 10_000,
                           "ts": time.time()}, f)
            return
        time.sleep(0.05)


def test_park_heal_resume_roundtrip_sim(tmp_path):
    from torchmpi_tpu_torch import elastic, obs

    d = str(tmp_path / "elastic")
    os.makedirs(d)
    plan = _write_plan(tmp_path / "plan.json",
                       [_partition_rule("~0", after=2, heal=10_000)])
    tmpi.init(device="cpu", elastic="on", faults=plan,
              elastic_quorum="majority", elastic_deadline_s=0.5,
              elastic_poll_s=0.02, obs="metrics",
              obs_dir=str(tmp_path / "obs"))
    obs.reset()
    stop = threading.Event()
    healer = threading.Thread(target=_heal_when_parked,
                              args=(os.path.join(d, "membership"), stop))
    healer.start()
    try:
        state1, info1 = elastic.run_elastic(
            _make_build(STEPS, sleep_s=0.08), steps=STEPS, directory=d,
            save_every=2, members=[0, 1, 2], world_size=8,
            park_budget_s=30)
    finally:
        stop.set()
        healer.join(timeout=30)
    assert info1["parks"] == 1 and info1["shrinks"] == 0
    assert info1["view"].members == (0, 1, 2)
    assert np.isfinite(state1["losses"]).all()
    reg = obs.registry()
    assert reg.counter_total("tm_elastic_quorum_lost_total") >= 1
    assert reg.counter_total("tm_elastic_parked_total") >= 1
    assert reg.counter_total("tm_elastic_healed_total") >= 1
    obs.deactivate()
    tmpi.stop()
    tfaults.reset()
    d2 = str(tmp_path / "clean")
    os.makedirs(d2)
    tmpi.init(device="cpu", elastic="on")
    state2, info2 = elastic.run_elastic(
        _make_build(STEPS), steps=STEPS, directory=d2, save_every=2,
        members=[0, 1, 2], world_size=8)
    assert info2["parks"] == 0
    assert np.array_equal(state1["losses"], state2["losses"])
    for k in state1["params"]:
        assert torch.equal(state1["params"][k], state2["params"][k])


def test_quorum_off_same_plan_commits_minority(tmp_path):
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "elastic")
    os.makedirs(d)
    plan = _write_plan(tmp_path / "plan.json",
                       [_partition_rule("~0", after=2, heal=-1)])
    tmpi.init(device="cpu", elastic="on", faults=plan,
              elastic_deadline_s=0.5, elastic_poll_s=0.02)
    state, info = elastic.run_elastic(
        _make_build(STEPS, sleep_s=0.08), steps=STEPS, directory=d,
        save_every=2, members=[0, 1, 2], world_size=8)
    assert info["shrinks"] == 1 and info["parks"] == 0
    assert info["view"].members == (0,)
    assert np.isfinite(state["losses"]).all()
    assert "torchmpi_tpu_torch.faults.fencing" not in sys.modules or \
        sys.modules["torchmpi_tpu_torch.faults.fencing"].current() is None


def test_stale_staging_orphans_reaped(tmp_path):
    from torchmpi_tpu_torch.utils import checkpoint

    d = str(tmp_path)
    old = tmp_path / "ckpt_3_p0.npz.tmp.99999"
    old.write_bytes(b"dead writer's leavings")
    os.utime(old, (time.time() - 3600, time.time() - 3600))
    fresh = tmp_path / "ckpt_5_p0.npz.tmp.88888"
    fresh.write_bytes(b"live writer staging")
    torn = tmp_path / "ckpt_7_p0.npz.tmp"
    torn.write_bytes(b"PK torn artifact")
    os.utime(torn, (time.time() - 3600, time.time() - 3600))
    checkpoint.save(d, {"w": torch.ones(3)}, step=9)
    assert not old.exists() and fresh.exists() and torn.exists()
    assert checkpoint.latest_step(d) == 9


def test_blame_live_distinguishes_parked(tmp_path):
    """The watchdog's ``set_state("parked")`` lease through the port's
    ``blame --live`` and JAX's tool: the same verdict."""
    import importlib.util

    from torchmpi_tpu_torch import watchdog
    from torchmpi_tpu_torch.obs import tool as ttool

    spec = importlib.util.spec_from_file_location(
        "_obs_tool_membership", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "obs_tool.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    lease_dir = str(tmp_path / "leases")
    watchdog.reset()
    watchdog.activate("warn", deadline_s=5, poll_s=0.05,
                      lease_dir=lease_dir, rank=1)
    try:
        watchdog.set_state("parked", "waiting for a committed epoch > 4")
        assert watchdog.state() == "parked"
        with open(watchdog.lease_path(lease_dir, 1)) as f:
            lease = json.load(f)
        assert lease["state"] == "parked"
        assert "epoch > 4" in lease["state_detail"]
        outs = []
        for tool in (ttool, jtool):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tool.main(["blame", "--live", lease_dir])
            outs.append((rc, buf.getvalue()))
        for rc, out in outs:
            assert rc == 1
            assert "PARKED" in out and "epoch > 4" in out
            assert "NOT a corpse" in out
        watchdog.set_state("running")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ttool.main(["blame", "--live", lease_dir])
        assert rc == 0 and "all ranks healthy" in buf.getvalue()
    finally:
        watchdog.reset()


def test_elastic_quorum_config_env_and_validation(monkeypatch):
    from torchmpi_tpu_torch import runtime

    monkeypatch.setenv("TORCHMPI_TPU_ELASTIC_QUORUM", "majority")
    tmpi.init(tmpi.Config(dcn_size=1), device="cpu")
    assert runtime.config().elastic_quorum == "majority"
    tmpi.set_config(elastic_quorum="off")
    assert runtime.config().elastic_quorum == "off"
    tmpi.set_config(elastic_quorum="1")
    assert runtime.config().elastic_quorum == "majority"
    with pytest.raises(ValueError):
        tmpi.set_config(elastic_quorum="plurality")
    tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_ELASTIC_QUORUM", "bogus")
    with pytest.raises(ValueError):
        tmpi.init(tmpi.Config(dcn_size=1), device="cpu")
    monkeypatch.delenv("TORCHMPI_TPU_ELASTIC_QUORUM")


# -- the chaos tool's partition recipe and summaries (JAX :663, :693) --------


def _jax_chaos_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chaos_tool_membership", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "chaos_tool.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_tool_partition_recipe(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    out, jout = str(tmp_path / "part.json"), str(tmp_path / "jpart.json")
    assert tool.main(["gen", "--out", out, "--seed", "3",
                      "--partition", "~1:4:9"]) == 0
    text = capsys.readouterr().out
    assert "partition recipe" in text and "heals at step 9" in text
    assert _jax_chaos_tool().main(["gen", "--out", jout, "--seed", "3",
                                   "--partition", "~1:4:9"]) == 0
    capsys.readouterr()
    assert open(out).read() == open(jout).read()
    assert json.load(open(out))["rules"] == [
        {"site": "board.read", "kind": "partition", "prob": 1.0,
         "after": 4, "max_hits": 1, "delay_s": 0.0, "ranks": "~1",
         "heal_after": 9}]
    assert tool.main(["lint", out]) == 0
    capsys.readouterr()
    assert tool.main(["gen", "--out", out, "--partition", "1:4:3"]) == 2
    assert tool.main(["gen", "--out", out, "--partition", "x:y"]) == 2
    assert tool.main(["gen", "--out", out,
                      "--rule", "elastic.member:partition"]) == 2
    capsys.readouterr()
    bad = str(tmp_path / "bad.json")
    _write_plan(bad, [dict(_partition_rule("1"), site="ps.request"),
                      {"site": "board.write", "kind": "corrupt_silent"}])
    assert tool.main(["lint", bad]) == 1
    text = capsys.readouterr().out
    assert "membership board" in text and "no payload" in text


def test_chaos_tool_summarize_reports_partition_counters(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    dump = tmp_path / "metrics_host0.jsonl"
    with open(dump, "w") as f:
        for name in ("tm_elastic_quorum_lost_total",
                     "tm_elastic_parked_total", "tm_elastic_fenced_total",
                     "tm_elastic_healed_total"):
            f.write(json.dumps({"kind": "counter", "name": name,
                                "labels": {}, "value": 1}) + "\n")
    outs = []
    for t in (tool, _jax_chaos_tool()):
        assert t.main(["summarize", str(dump)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    for key in ("elastic_quorum_lost=1", "elastic_parked=1",
                "elastic_fenced=1", "elastic_healed=1"):
        assert key in outs[0]
