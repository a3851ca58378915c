"""Worker of tests/test_torch_elastic_world.py (the underscore keeps pytest
from collecting it): the port's counterpart of JAX's
tests/_elastic_worker.py and tests/_partition_worker.py, on the CPU.

Modes (argv: pid nproc port mode directory [extra ...]):

- ``elastic`` / ``elastic-rejoin`` (extra: plan): a gloo world of
  ``nproc`` processes (``Config.coordinator_address`` /
  ``num_processes`` / ``process_id``) trains JAX tests/test_elastic.py's
  MLP with momentum (its ``_make_build``, zero 0: the mean gradient,
  ``mu = MOM mu + g``, ``p -= LR mu``), one member a process, under a
  seeded ``elastic.member`` kill plan.  The
  dead rank raises ``MemberDeath``; in ``elastic`` it exits, in
  ``elastic-rejoin`` it ``admit``s itself back and re-enters the driver.
  The survivor shrinks (a new process group over a FileStore on the
  board), and in the rejoin case grows back.  Prints ``ELASTIC-SUMMARY``.
- ``clean``: one process restored from the copied checkpoint step.
- ``partition`` (extra: plan quorum): an independent world of one process
  a side, sharing only the board and the checkpoint directory: an
  ``ElasticGang(local=[pid])`` under an asymmetric board partition.
  Prints ``PARTITION-SUMMARY``.
- ``replay`` (extra: schedule JSON): the same program under an explicit
  view schedule, no board.
"""

import hashlib
import json
import os
import sys
import time

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
mode = sys.argv[4]
directory = sys.argv[5]

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torchmpi_tpu_torch as mpi  # noqa: E402

torch.set_num_threads(1)
DIM, H, B = 4, 8, 8
LR = 0.05
MOM = 0.9
STEPS = 28 if mode in ("partition", "replay") else 10
SLEEP_S = 0.15 if mode in ("partition", "replay") else 0.0


def _batch(m, step):
    rng = np.random.RandomState(10_000 + m * 97 + step)
    return (torch.from_numpy(rng.randn(B, DIM).astype(np.float32)),
            torch.from_numpy(rng.randn(B, 1).astype(np.float32)))


def _init_fn():
    rng = np.random.RandomState(0)
    params = {"w1": torch.from_numpy(
                  (rng.randn(DIM, H) * 0.3).astype(np.float32)),
              "b1": torch.zeros(H),
              "w2": torch.from_numpy(
                  (rng.randn(H, 1) * 0.3).astype(np.float32))}
    return {"params": params,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "losses": np.full((STEPS,), np.nan, np.float32)}


def _update(state, g, losses):
    """The momentum step of JAX's ``_make_build`` (zero 0) on the mean
    gradient ``g`` (one tensor a leaf, in the params' order)."""
    mu = {k: MOM * v + gk for (k, v), gk in zip(state["mu"].items(), g)}
    return {"params": {k: v - LR * mu[k]
                       for k, v in state["params"].items()},
            "mu": mu, "losses": losses}


def _grads(p, m, i):
    x, y = _batch(m, i)
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    h = torch.tanh(x @ leaves["w1"] + leaves["b1"])
    loss = torch.mean((h @ leaves["w2"] - y) ** 2)
    return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))


def build_world(comm, view):
    """One member a process: this process's member's batch, the mean
    gradient over the process world (gloo)."""
    me = mpi.runtime.process_index()

    def step_fn(state, i):
        p = state["params"]
        loss, g = _grads(p, me, i)
        g = [mpi.allreduce(t, op="mean") for t in g]
        losses = np.array(state["losses"])
        losses[i] = float(mpi.allreduce(loss, op="mean"))
        return _update(state, g, losses)

    return _init_fn, step_fn


def build_rows(comm, view):
    """One member a rank-major row of this process (the partition
    harness: each side trains every member of its view)."""
    members = view.members

    def step_fn(state, i):
        if SLEEP_S:
            time.sleep(SLEEP_S)
        p = state["params"]
        outs = [_grads(p, m, i) for m in members]
        stacks = [torch.stack([g[k] for _, g in outs])
                  for k in range(len(p))]
        mpi.parallel.gradsync.synchronize_gradients_rank_major(
            stacks, op="mean")
        losses = np.array(state["losses"])
        losses[i] = float(mpi.allreduce_rank_major(
            torch.stack([lo for lo, _ in outs]).reshape(-1, 1),
            op="mean")[0, 0])
        return _update(state, [st[0] for st in stacks], losses)

    return _init_fn, step_fn


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _params_digest(state):
    return _digest(np.concatenate(
        [state["params"][k].numpy().reshape(-1)
         for k in sorted(state["params"])]))


if mode in ("elastic", "elastic-rejoin", "clean"):
    cfg = dict(elastic="on")
    if nproc > 1:
        cfg.update(coordinator_address=f"127.0.0.1:{port}",
                   num_processes=nproc, process_id=pid)
    if mode != "clean":
        cfg.update(faults=sys.argv[6], obs="metrics",
                   obs_dir=os.path.join(directory, f"obs{pid}"))
    mpi.init(device="cpu", **cfg)
    from torchmpi_tpu_torch import elastic

    try:
        state, info = elastic.run_elastic(build_world, steps=STEPS,
                                          directory=directory, save_every=2)
    except elastic.MemberDeath as e:
        print(f"CHECK rank={pid} member-death ok (member {e.member} at "
              f"step {e.step})", flush=True)
        if mode != "elastic-rejoin":
            sys.exit(0)
        view = elastic.admit(directory, pid, deadline_s=120)
        print(f"CHECK rank={pid} admitted epoch={view.epoch} "
              f"step={view.step}", flush=True)
        state, info = elastic.run_elastic(build_world, steps=STEPS,
                                          directory=directory, save_every=2)
    shrink_total = 0
    if mode != "clean":
        from torchmpi_tpu_torch import obs

        shrink_total = int(obs.registry().counter_total(
            "tm_elastic_shrink_total"))
    r = info["recovered_step"]
    print("ELASTIC-SUMMARY " + json.dumps({
        "rank": pid, "shrinks": info["shrinks"],
        "rejoins": info["rejoins"], "reconciles": info["reconciles"],
        "recovered_step": r, "recoveries": info["recoveries"],
        "members": list(info["view"].members),
        "world_size": mpi.size(), "elastic_shrink_total": shrink_total,
        "losses": state["losses"].tolist(),
        "losses_digest": _digest(state["losses"][r:]),
        "params_digest": _params_digest(state)}), flush=True)
    mpi.stop()
    print(f"CHECK rank={pid} done", flush=True)
    sys.exit(0)

if mode == "replay":
    from torchmpi_tpu_torch.faults import membership

    mpi.init(device="cpu")
    sched = json.loads(sys.argv[6])  # [[start, [members ...]], ...]
    state = None
    for idx, (start, members) in enumerate(sched):
        end = sched[idx + 1][0] if idx + 1 < len(sched) else STEPS
        comm = mpi.runtime.resize_world(members)
        init_fn, step_fn = build_rows(comm, membership.MembershipView(
            epoch=idx, members=tuple(members), step=start))
        if state is None:
            state = init_fn()
        for i in range(start, end):
            state = step_fn(state, i)
    print("PARTITION-SUMMARY " + json.dumps({
        "rank": pid, "mode": "replay",
        "losses_digest": _digest(state["losses"]),
        "params_digest": _params_digest(state)}), flush=True)
    mpi.stop()
    sys.exit(0)

plan, quorum = sys.argv[6], sys.argv[7]
mpi.init(device="cpu", elastic="on",
         elastic_quorum="majority" if quorum == "on" else "off",
         elastic_deadline_s=1.0, elastic_poll_s=0.02, faults=plan,
         obs="metrics", obs_dir=os.path.join(directory, f"obs{pid}"))
from torchmpi_tpu_torch import elastic, obs  # noqa: E402

gang = elastic.ElasticGang(directory, members=[0, 1], world_size=2,
                           local=[pid])
state, info = elastic.run_elastic(build_rows, steps=STEPS,
                                  directory=directory, save_every=2,
                                  gang=gang, park_budget_s=120)
reg = obs.registry()
print("PARTITION-SUMMARY " + json.dumps({
    "rank": pid, "mode": f"partition-quorum-{quorum}",
    "shrinks": info["shrinks"], "rejoins": info["rejoins"],
    "parks": info["parks"], "recoveries": info["recoveries"],
    "recovered_step": info["recovered_step"],
    "members": list(info["view"].members), "epoch": info["view"].epoch,
    "quorum_lost_total": int(reg.counter_total(
        "tm_elastic_quorum_lost_total")),
    "parked_total": int(reg.counter_total("tm_elastic_parked_total")),
    "fenced_total": int(reg.counter_total("tm_elastic_fenced_total")),
    "healed_total": int(reg.counter_total("tm_elastic_healed_total")),
    "losses_digest": _digest(state["losses"]),
    "params_digest": _params_digest(state)}), flush=True)
mpi.stop()
print(f"CHECK rank={pid} done", flush=True)
