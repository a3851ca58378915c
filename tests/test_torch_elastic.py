"""The port's elastic gang (torchmpi_tpu_torch/elastic.py and
``runtime.resize_world``) against the JAX package's on the CPU: JAX's
tests/test_elastic.py past its board cases (those are in
tests/test_torch_membership.py, its two process cases in
tests/test_torch_elastic_world.py).

The sim cases run JAX's own harness (its ``_make_build``: a 2-layer MLP,
one device a member, of an 8-device mesh) and the port's counterpart (the
same MLP, one rank-major row a member) under the same chaos plan: the
``info`` (shrinks, rejoins, reconciles, recoveries, recovered step,
restarts, view) must be equal, and the losses equal JAX's to float32
rounding (rtol 1e-6: the two packages' float32 matmuls and means differ in
summation order).  Within the port, as in JAX's tests: the shrunk run is
bitwise a clean N-1 run restored from the same checkpoint (ZeRO-0 and the
mini-ZeRO-1 re-partition; ZeRO-3's data flow to 1e-6, and bitwise here),
the rejoin brings the original membership back, a twice-dead join is a
death notice, the ledger and a ``PeerTimeoutError`` naming a member shrink
the gang, a plain failure restores in place, ``resize_world`` strands the
plans, and the error-feedback residuals re-bucket without losing mass."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.faults import membership

import test_elastic as jte  # JAX's harness: _make_build, _kill_plan
from _torch_world import module_group

torch.set_num_threads(2)
STEPS = jte.STEPS
DIM, H, B = jte.DIM, jte.H, jte.B
LR, MOM = jte.LR, jte.MOM
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


def _reset():
    for name in ("torchmpi_tpu_torch.faults", "torchmpi_tpu.faults"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.reset()
    for name in ("torchmpi_tpu_torch.faults.fencing",
                 "torchmpi_tpu.faults.fencing"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.disarm()
    tmpi.stop()
    jmpi.stop()


@pytest.fixture(autouse=True)
def fresh():
    _reset()
    yield
    _reset()


def _arm(jax_side=False, **kw):
    """(Re-)init the port's runtime with elastic on (and JAX's, with the
    same knobs)."""
    tmpi.stop()
    tmpi.init(device="cpu", elastic="on", **kw)
    if jax_side:
        jmpi.stop()
        jmpi.init(jmpi.Config(elastic="on", **kw))


# ---------------------------------------------------------------------------
# The port's harness: JAX's _make_build, one rank-major row a member
# ---------------------------------------------------------------------------


def _flat(tree):
    return torch.cat([v.reshape(-1) for v in tree.values()])


def _unflat(flat, tree):
    out, off = {}, 0
    for k, v in tree.items():
        out[k] = flat[off:off + v.numel()].reshape(v.shape).clone()
        off += v.numel()
    return out


def _make_build(steps, *, zero=0):
    """``build(comm, view)``: JAX test_elastic.py's MLP, member ``m`` the
    row of the view's rank-major stack, its batch ``jte._member_batch(m,
    step)``.  ``zero`` 0: the synced mean gradient updates the replicated
    momentum and parameters; 1: the mean gradient reduce-scattered, each
    row's momentum / parameter shard updated, both all-gathered back (the
    shards re-derived from the full checkpointed state at the view's n:
    the re-partition); 3: ZeRO-3's data flow, the parameters gathered from
    each row's shard before the loss."""

    def build(comm, view):
        members = view.members
        n = len(members)
        assert comm.fixed_size() == n and \
            tmpi.runtime.world_rows() == tuple(members)

        def init_fn():
            rng = np.random.RandomState(0)
            params = {"w1": torch.from_numpy(
                          (rng.randn(DIM, H) * 0.3).astype(np.float32)),
                      "b1": torch.zeros(H),
                      "w2": torch.from_numpy(
                          (rng.randn(H, 1) * 0.3).astype(np.float32))}
            return {"params": params,
                    "mu": {k: torch.zeros_like(v) for k, v in
                           params.items()},
                    "losses": np.full((steps,), np.nan, np.float32)}

        def shards(flat):
            pad = (-flat.numel()) % n
            return torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1)

        def gather(sh, like):
            full = tmpi.allgather_rank_major(sh)[0].reshape(-1)
            return full[:like]

        def step_fn(state, i):
            p, mu = state["params"], state["mu"]
            total = sum(v.numel() for v in p.values())
            if zero == 3:
                p = _unflat(gather(shards(_flat(p)), total), p)
            grads, losses = [], []
            for m in members:
                x, y = map(torch.from_numpy, jte._member_batch(m, i))
                leaves = {k: v.detach().requires_grad_()
                          for k, v in p.items()}
                h = torch.tanh(x @ leaves["w1"] + leaves["b1"])
                loss = torch.mean((h @ leaves["w2"] - y) ** 2)
                grads.append(torch.autograd.grad(loss,
                                                 list(leaves.values())))
                losses.append(loss.detach())
            lmean = tmpi.allreduce_rank_major(
                torch.stack(losses).reshape(n, 1), op="mean")[0, 0]
            out = np.array(state["losses"])
            out[i] = float(lmean)
            if zero == 0:
                stacks = [torch.stack([g[k] for g in grads])
                          for k in range(len(p))]
                tmpi.parallel.gradsync.synchronize_gradients_rank_major(
                    stacks, op="mean")
                mu2 = {k: MOM * v + st[0] for (k, v), st in
                       zip(mu.items(), stacks)}
                p2 = {k: v - LR * mu2[k] for k, v in p.items()}
                return {"params": p2, "mu": mu2, "losses": out}
            gf = torch.stack([torch.cat([t.reshape(-1) for t in g])
                              for g in grads])
            pad = (-total) % n
            g_sh = tmpi.reduce_scatter_rank_major(
                torch.nn.functional.pad(gf, (0, pad))) / n
            mu_sh = shards(_flat(mu))
            p_sh = shards(_flat(p))
            mu2_sh = MOM * mu_sh + g_sh
            p2_sh = p_sh - LR * mu2_sh
            return {"params": _unflat(gather(p2_sh, total), p),
                    "mu": _unflat(gather(mu2_sh, total), mu),
                    "losses": out}

        return init_fn, step_fn

    return build


def _run(build, directory, members, **kw):
    from torchmpi_tpu_torch import elastic

    return elastic.run_elastic(build, steps=STEPS, directory=directory,
                               save_every=2, members=members, world_size=8,
                               **kw)


def _jrun(build, directory, members, **kw):
    from torchmpi_tpu import elastic

    return elastic.run_elastic(build, steps=STEPS, directory=directory,
                               save_every=2, members=members, world_size=8,
                               **kw)


def _info_js(info):
    return dict(info, view=info["view"].to_json())


def _copy_ckpt(src, dst, step):
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        if f.startswith(f"ckpt_{step}_"):
            shutil.copy(os.path.join(src, f), os.path.join(dst, f))


def _assert_losses_match_jax(state, jstate):
    np.testing.assert_allclose(state["losses"], jstate["losses"],
                               rtol=LOSS_RTOL, atol=0)


# ---------------------------------------------------------------------------
# The acceptance: a seeded shrink, bitwise to a clean N-1 run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero", [0, 1])
def test_shrink_bit_identical(tmp_path, zero):
    plan = jte._kill_plan(tmp_path / "plan.json", 2, 5, 4)
    d1, dj = str(tmp_path / "elastic"), str(tmp_path / "jax")
    os.makedirs(d1)
    os.makedirs(dj)
    _arm(jax_side=True, faults=plan)
    state1, info1 = _run(_make_build(STEPS, zero=zero), d1, [0, 1, 2, 3])
    jstate, jinfo = _jrun(jte._make_build(STEPS, zero=zero), dj,
                          [0, 1, 2, 3])
    assert _info_js(info1) == _info_js(jinfo)
    assert info1["shrinks"] == 1 and info1["reconciles"] == 1
    assert info1["view"].members == (0, 1, 3)
    r = info1["recovered_step"]
    assert 0 < r <= 5
    _assert_losses_match_jax(state1, jstate)

    d2 = str(tmp_path / "clean")
    _copy_ckpt(d1, d2, r)
    _reset()
    _arm()
    state2, info2 = _run(_make_build(STEPS, zero=zero), d2, [0, 1, 3])
    assert info2["recovered_step"] == r and info2["shrinks"] == 0
    assert np.array_equal(state1["losses"][r:], state2["losses"][r:])
    for k in state1["params"]:
        assert torch.equal(state1["params"][k], state2["params"][k])
        assert torch.equal(state1["mu"][k], state2["mu"][k])


def test_shrink_zero3_allclose(tmp_path):
    plan = jte._kill_plan(tmp_path / "plan.json", 2, 5, 4)
    d1, dj = str(tmp_path / "elastic"), str(tmp_path / "jax")
    os.makedirs(d1)
    os.makedirs(dj)
    _arm(jax_side=True, faults=plan)
    state1, info1 = _run(_make_build(STEPS, zero=3), d1, [0, 1, 2, 3])
    jstate, jinfo = _jrun(jte._make_build(STEPS, zero=3), dj, [0, 1, 2, 3])
    assert _info_js(info1) == _info_js(jinfo) and info1["shrinks"] == 1
    _assert_losses_match_jax(state1, jstate)
    r = info1["recovered_step"]
    d2 = str(tmp_path / "clean")
    _copy_ckpt(d1, d2, r)
    _reset()
    _arm()
    state2, _ = _run(_make_build(STEPS, zero=3), d2, [0, 1, 3])
    np.testing.assert_allclose(state1["losses"][r:], state2["losses"][r:],
                               rtol=1e-6)
    for k in state1["params"]:
        np.testing.assert_allclose(state1["params"][k].numpy(),
                                   state2["params"][k].numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(state1["params"][k], state2["params"][k])


def test_rejoin_at_step_boundary(tmp_path):
    plan = jte._kill_plan(tmp_path / "plan.json", 2, 2, 4)
    d, dj = str(tmp_path / "elastic"), str(tmp_path / "jax")
    os.makedirs(d)
    os.makedirs(dj)
    _arm(jax_side=True, faults=plan, obs="metrics",
         obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    obs.reset()
    board = membership.Board(os.path.join(d, "membership"))
    board.request_join(2)
    from torchmpi_tpu.faults import membership as jmem

    jmem.Board(os.path.join(dj, "membership")).request_join(2)
    state, info = _run(_make_build(STEPS), d, [0, 1, 2, 3])
    jstate, jinfo = _jrun(jte._make_build(STEPS), dj, [0, 1, 2, 3])
    assert _info_js(info) == _info_js(jinfo)
    assert info["shrinks"] == 1 and info["rejoins"] == 1
    assert info["view"].members == (0, 1, 2, 3)
    assert info["reconciles"] == 2
    assert board.join_requests() == []
    assert np.isfinite(state["losses"]).all()
    _assert_losses_match_jax(state, jstate)
    view = membership.wait_for_view(board, containing=2, deadline_s=2)
    assert 2 in view.members and view.epoch == info["view"].epoch
    reg = obs.registry()
    assert reg.counter_total("tm_elastic_shrink_total") == 1
    assert reg.counter_total("tm_elastic_rejoin_total") == 1
    assert reg.counter_total("tm_elastic_reconcile_total") == 2
    obs.deactivate()
    obs.reset()


def test_admit_rejects_stale_view_with_incarnation(tmp_path):
    _arm()
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "ckpt")
    board = membership.Board(os.path.join(d, "membership"))
    membership.reconcile(board, [0, 1], [0, 1], epoch=1, step=4,
                         deadline_s=2, poll_s=0.01)
    assert board.committed_view().members == (0, 1)
    with pytest.raises(membership.ReconcileTimeout):
        elastic.admit(d, 1, deadline_s=0.5, poll_s=0.01)
    assert board.incarnation(1) == 1
    assert board.join_details()[1]["incarnation"] == 1
    assert tmpi.runtime.world_tag() == ("stale", ())


def test_twice_dead_join_is_a_death_notice(tmp_path):
    _arm()
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    gang = elastic.ElasticGang(d, members=[0, 1], world_size=2)
    assert gang.view.members == (0, 1)
    board = gang.board
    inc = board.bump_incarnation(1)
    board.heartbeat(1, epoch=-1, step=-1, incarnation=inc)
    board.request_join(1, incarnation=inc)
    assert gang.poll(0) == ("shrink", [1])
    gang.shrink([1], step=0)
    assert gang.view.members == (0,)
    assert gang.poll(1) == ("rejoin", [1])
    gang.grow([1], step=1)
    assert gang.view.members == (0, 1)
    assert gang._inc[1] == inc
    assert board.join_requests() == []
    board.request_join(1, incarnation=inc)
    assert gang.poll(2) is None


def test_restarted_driver_sees_pending_join_as_death(tmp_path):
    _arm()
    from torchmpi_tpu_torch import elastic

    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    gang0 = elastic.ElasticGang(d, members=[0, 1], world_size=2)
    board = gang0.board
    inc = board.bump_incarnation(1)
    board.heartbeat(1, epoch=-1, step=-1, incarnation=inc)
    board.request_join(1, incarnation=inc)
    gang = elastic.ElasticGang(d, members=[0, 1], world_size=2)
    assert gang.poll(0) == ("shrink", [1])
    gang.shrink([1], step=0)
    assert gang.poll(1) == ("rejoin", [1])
    gang.grow([1], step=1)
    assert gang.view.members == (0, 1) and gang._inc[1] == inc


def test_ledger_escalation_shrinks(tmp_path):
    d, dj = str(tmp_path / "elastic"), str(tmp_path / "jax")
    os.makedirs(d)
    os.makedirs(dj)
    _arm(jax_side=True, faults="policy")
    from torchmpi_tpu import faults as jfaults
    from torchmpi_tpu_torch import faults

    for led in (faults.ledger(), jfaults.ledger()):
        for _ in range(led.dead_after):
            led.record("member:3", ok=False)
        assert led.decide("member:3") == "raise"
    state, info = _run(_make_build(STEPS), d, [0, 1, 2, 3])
    jstate, jinfo = _jrun(jte._make_build(STEPS), dj, [0, 1, 2, 3])
    assert _info_js(info) == _info_js(jinfo)
    assert info["shrinks"] == 1 and info["view"].members == (0, 1, 2)
    assert np.isfinite(state["losses"]).all()
    _assert_losses_match_jax(state, jstate)


def test_plain_restart_keeps_mesh_and_plans(tmp_path):
    from torchmpi_tpu_torch import runtime

    d = str(tmp_path / "elastic")
    os.makedirs(d)
    _arm()
    base = _make_build(STEPS)
    builds, boom = [], []

    def build(comm, view):
        builds.append(runtime.config_epoch())
        init_fn, step_fn = base(comm, view)

        def step(state, i):
            if i == 4 and not boom:
                boom.append(i)
                raise RuntimeError("transient, unattributable")
            return step_fn(state, i)

        return init_fn, step

    state, info = _run(build, d, [0, 1, 2, 3])
    assert info["restarts_used"] == 1 and info["shrinks"] == 0
    assert len(builds) == 1
    assert info["recovered_step"] == 4
    assert runtime.config_epoch() == builds[0]
    assert np.isfinite(state["losses"]).all()


def test_peer_timeout_implicates_member(tmp_path):
    d, dj = str(tmp_path / "elastic"), str(tmp_path / "jax")
    os.makedirs(d)
    os.makedirs(dj)
    _arm(jax_side=True, faults="policy")
    from torchmpi_tpu.faults import PeerTimeoutError as JPeerTimeout
    from torchmpi_tpu_torch.faults import PeerTimeoutError

    def timed_out(base_build, err):
        fired = []

        def build(comm, view):
            init_fn, step_fn = base_build(comm, view)

            def step(state, i):
                if i == 3 and len(view.members) == 4 and not fired:
                    fired.append(i)
                    raise err("ps.response", peer="member:1",
                              deadline_s=1.0)
                return step_fn(state, i)

            return init_fn, step

        return build

    state, info = _run(timed_out(_make_build(STEPS), PeerTimeoutError), d,
                       [0, 1, 2, 3])
    jstate, jinfo = _jrun(timed_out(jte._make_build(STEPS), JPeerTimeout),
                          dj, [0, 1, 2, 3])
    assert _info_js(info) == _info_js(jinfo)
    assert info["shrinks"] == 1 and info["view"].members == (0, 2, 3)
    assert info["restarts_used"] == 0
    _assert_losses_match_jax(state, jstate)


def test_reshard_ps(tmp_path):
    from torchmpi_tpu_torch import elastic

    _arm()
    params = {"w": np.arange(16, dtype=np.float32),
              "b": np.ones((4,), np.float32)}
    ps = tmpi.parameterserver.init(params, num_shards=2)
    ps2 = None
    try:
        ps2 = elastic.reshard_ps(params, num_shards=1, old_ps=ps)
        assert len(ps2.client.peers) == 1
        got = ps2.receive().wait()
        np.testing.assert_array_equal(np.asarray(got["w"]), params["w"])
        np.testing.assert_array_equal(np.asarray(got["b"]), params["b"])
    finally:
        if ps2 is not None:
            ps2.shutdown()


# ---------------------------------------------------------------------------
# resize_world and the plans
# ---------------------------------------------------------------------------


def test_resize_world_invalidates_plans():
    from torchmpi_tpu_torch import planner, runtime

    _arm()
    tmpi.allreduce_rank_major(torch.ones(8, 8))
    assert planner.stats()["entries"] >= 1
    epoch0 = runtime.config_epoch()
    comm = runtime.resize_world(range(6))
    assert comm.axes == ("ici",) and comm.fixed_size() == 6
    assert runtime.world_rows() == tuple(range(6))
    assert runtime.config_epoch() == epoch0 + 1
    assert planner.stats()["entries"] == 0
    y = tmpi.allreduce_rank_major(torch.ones(6, 8))
    assert y.shape == (6, 8) and torch.all(y == 6)
    with pytest.raises(ValueError):
        runtime.resize_world([])
    with pytest.raises(ValueError):
        runtime.resize_world(range(6), shape={"dcn": 2, "ici": 4})
    with pytest.raises(ValueError, match="needs store_dir"):
        runtime._resize_process_world([0], None, None, 1.0)


def test_whole_gang_hands_back_init_world(tmp_path):
    """A one-process run that ends with every row of its gang puts back
    the world init built (the two-level world, no fixed rows, plans
    dropped); one that ends shrunk keeps its fixed-size world."""
    from torchmpi_tpu_torch import planner, runtime

    plan = jte._kill_plan(tmp_path / "plan.json", 2, 2, 4)
    _arm(faults=plan)
    world0 = runtime.world_communicator()
    d = str(tmp_path / "whole")
    membership.Board(os.path.join(d, "membership")).request_join(2)
    from torchmpi_tpu_torch import elastic

    _, info = elastic.run_elastic(_make_build(STEPS), steps=STEPS,
                                  directory=d, save_every=2,
                                  members=range(4), world_size=4)
    assert info["shrinks"] == 1 and info["rejoins"] == 1
    assert info["view"].members == (0, 1, 2, 3)
    assert runtime.world_communicator() is world0
    assert runtime.world_rows() is None
    assert planner.stats()["entries"] == 0
    y = tmpi.allreduce_rank_major(torch.ones(8, 8))
    assert torch.all(y == 8)

    _reset()
    _arm(faults=jte._kill_plan(tmp_path / "plan2.json", 2, 2, 4))
    _, info = elastic.run_elastic(_make_build(STEPS), steps=STEPS,
                                  directory=str(tmp_path / "shrunk"),
                                  save_every=2, members=range(4),
                                  world_size=4)
    assert info["view"].members == (0, 1, 3)
    assert runtime.world_communicator().fixed_size() == 3
    assert runtime.world_rows() == (0, 1, 3)


def test_elastic_requires_opt_in(tmp_path):
    tmpi.init(device="cpu", dcn_size=1)
    from torchmpi_tpu_torch import elastic

    with pytest.raises(RuntimeError, match="elastic"):
        elastic.run_elastic(lambda c, v: (None, None), steps=1,
                            directory=str(tmp_path))
    with pytest.raises(RuntimeError, match="elastic"):
        elastic.admit(str(tmp_path), 0)


def test_elastic_config_env_and_validation(monkeypatch):
    from torchmpi_tpu_torch import runtime

    monkeypatch.setenv("TORCHMPI_TPU_ELASTIC", "1")
    monkeypatch.setenv("TORCHMPI_TPU_ELASTIC_DEADLINE", "7.5")
    tmpi.init(tmpi.Config(dcn_size=1), device="cpu")
    assert runtime.config().elastic == "on"
    assert runtime.config().elastic_deadline_s == 7.5
    tmpi.set_config(elastic="off")
    assert runtime.config().elastic == "off"
    with pytest.raises(ValueError):
        tmpi.set_config(elastic="sideways")
    with pytest.raises(ValueError):
        tmpi.set_config(elastic_poll_s=0)
    tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_ELASTIC", "bogus")
    with pytest.raises(ValueError):
        tmpi.init(tmpi.Config(dcn_size=1), device="cpu")
    monkeypatch.delenv("TORCHMPI_TPU_ELASTIC")


# ---------------------------------------------------------------------------
# Re-partition helpers
# ---------------------------------------------------------------------------


def _jax_rebucket(old, shape_to, seed):
    """JAX's rebucket of the same residuals on its own (dcn, ici) meshes."""
    import jax
    import jax.numpy as jnp
    from torchmpi_tpu import elastic as jel
    from torchmpi_tpu import runtime as jrt

    params = {"w": np.zeros((3, 5), np.float32),
              "b": np.zeros((7,), np.float32)}
    mesh = jrt.resize_world(jax.devices()[:4 * shape_to[0]],
                            shape={"dcn": shape_to[0], "ici": 4})
    return [np.asarray(a) for a in jel.rebucket_ef_residuals(
        [jnp.asarray(o) for o in old], params, (2, 4),
        axis_names=("dcn", "ici"), mesh=mesh)]


def test_rebucket_ef_residuals():
    from torchmpi_tpu_torch import elastic, runtime
    from torchmpi_tpu_torch.parallel import gradsync

    _arm(ici_size=4)
    jmpi.stop()
    jmpi.init(jmpi.Config(elastic="on", ici_size=4))
    params = [torch.zeros(3, 5), torch.zeros(7)]
    old = gradsync.init_dcn_residuals(params, ("dcn", "ici"), n=8)
    rng = np.random.RandomState(1)
    old = [torch.from_numpy(rng.randn(*r.shape).astype(np.float32))
           for r in old]
    runtime.resize_world(range(4), shape={"dcn": 1, "ici": 4})
    new = elastic.rebucket_ef_residuals(old, params, (2, 4),
                                        axis_names=("dcn", "ici"), n=4)
    fresh = gradsync.init_dcn_residuals(params, ("dcn", "ici"), n=4)
    assert [a.shape for a in new] == [a.shape for a in fresh]
    ext = 3 * 5 + 7
    old_mass = old[0].numpy().reshape(2, 4, -1).sum(0).reshape(-1)
    new_mass = new[0].numpy().reshape(1, 4, -1).sum(0).reshape(-1)
    np.testing.assert_allclose(new_mass[:ext], old_mass[:ext], rtol=1e-6)
    # JAX's rebucket of the same state (the params tree's leaves in
    # JAX's order, "b" before "w", are the port's order reversed, so the
    # comparison is of the shapes and the total mass).
    jnew = _jax_rebucket([o.numpy() for o in old], (1, 4), 1)
    assert [a.shape for a in jnew] == [tuple(a.shape) for a in new]
    np.testing.assert_allclose(jnew[0].sum(), new[0].numpy().sum(),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="bucket"):
        elastic.rebucket_ef_residuals(old + old, params, (2, 4),
                                      axis_names=("dcn", "ici"), n=4)


def test_rebucket_ef_residuals_round_trip():
    from torchmpi_tpu_torch import elastic, runtime
    from torchmpi_tpu_torch.parallel import gradsync

    _arm(ici_size=4)
    params = [torch.zeros(3, 5), torch.zeros(7)]
    old = gradsync.init_dcn_residuals(params, ("dcn", "ici"), n=8)
    rng = np.random.RandomState(4)
    old = [torch.from_numpy(rng.randn(*r.shape).astype(np.float32))
           for r in old]
    ext = 3 * 5 + 7

    def mass(bufs, outer):
        return bufs[0].numpy().reshape(outer, 4, -1).sum(0).reshape(-1)[
            :ext]

    runtime.resize_world(range(4), shape={"dcn": 1, "ici": 4})
    small = elastic.rebucket_ef_residuals(old, params, (2, 4),
                                          axis_names=("dcn", "ici"), n=4)
    runtime.resize_world(range(8), shape={"dcn": 2, "ici": 4})
    back = elastic.rebucket_ef_residuals(small, params, (1, 4),
                                         axis_names=("dcn", "ici"), n=8)
    assert [a.shape for a in back] == [a.shape for a in old]
    assert np.array_equal(mass(back, 2), mass(old, 2))
    again = elastic.rebucket_ef_residuals(back, params, (2, 4),
                                          axis_names=("dcn", "ici"), n=8)
    for a, b in zip(again, back):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The chaos tool's shrink recipe
# ---------------------------------------------------------------------------


def test_chaos_tool_shrink_recipe(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    out = str(tmp_path / "shrink.json")
    assert tool.main(["gen", "--out", out, "--seed", "3",
                      "--shrink", "2:5:4"]) == 0
    assert "kill rank 2 at step 5" in capsys.readouterr().out
    plan = json.load(open(out))
    assert plan["rules"] == [{"site": "elastic.member", "kind": "fail",
                              "prob": 1.0, "after": 22, "max_hits": 1,
                              "delay_s": 0.0}]
    jtool = jte._chaos_tool()  # JAX's scripts/chaos_tool.py
    jout = str(tmp_path / "jshrink.json")
    assert jtool.main(["gen", "--out", jout, "--seed", "3",
                       "--shrink", "2:5:4"]) == 0
    assert open(out).read() == open(jout).read()
    assert tool.main(["lint", out]) == 0
    capsys.readouterr()
    assert tool.main(["gen", "--out", out, "--shrink", "4:1:4"]) == 2
    assert tool.main(["gen", "--out", out]) == 2
    assert tool.main(["gen", "--out", out, "--shrink", "1:2:4",
                      "--shrink", "2:3:4"]) == 2
    assert tool.main(["gen", "--out", out,
                      "--rule", "elastic.member:corrupt"]) == 0
    assert tool.main(["lint", out]) == 1
