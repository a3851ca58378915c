"""The serving layer's fault half in the port (serving/scheduler.py's
``serving.replica`` and ``serving.admit`` sites, the router on the fault
layer's ledger): the cases of the JAX package's tests/test_serving.py :221,
:675 and tests/test_serving_fleet.py :373, :501, :545.

The model is tests/test_torch_serving.py's: the JAX fixture's flax weights
loaded into the port's model, so every greedy stream is held token for
token to the port's offline ``generate`` (itself held to JAX's there).  The
admission-drop case runs the same plan through the JAX server too: the same
requests are shed, with the same streams for the rest.
"""

import importlib
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmpi_tpu as jmpi
from torchmpi_tpu import serving as jserving
from torchmpi_tpu.models import TransformerLM as JaxLM
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import serving, weights as tweights
from torchmpi_tpu_torch.models import TransformerLM, generate

tfaults = importlib.import_module("torchmpi_tpu_torch.faults")

torch.set_num_threads(2)

VOCAB = 41
CFG = dict(vocab=VOCAB, embed=32, depth=2, num_heads=4, head_dim=8,
           max_len=64, pos_emb="rope")


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
    tfaults.reset()
    jmpi.stop()
    tmpi.stop()


def _port_lm(jm, seed, **cfg):
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    pm = TransformerLM(**cfg, device="cpu")
    pm.load_state_dict(tweights.from_flax_params(params, pm))
    return params, pm


@pytest.fixture(scope="module")
def lm():
    """(JAX model, its params, the port's model with those weights)."""
    jm = JaxLM(**CFG)
    params, pm = _port_lm(jm, 1, **CFG)
    return jm, params, pm


def _prompts(n, tp=5, seed=0):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(n, tp)).astype(np.int32)


def _offline(model, prompt, steps):
    out = generate(model, np.asarray(prompt).reshape(1, -1), steps)
    return out[0, np.asarray(prompt).size:].tolist()


def _plan(tmp_path, rules, seed=0, name="plan.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"version": 1, "seed": seed,
                                "note": "serving chaos", "rules": rules}))
    return str(path)


def _kill_rule(after=2):
    return {"site": "serving.replica", "kind": "fail", "prob": 1.0,
            "after": after, "max_hits": 1}


@pytest.fixture()
def armed(tmp_path):
    """Arm the port's runtime (CPU) with a plan and obs "metrics"; disarm
    and stop on exit."""

    def arm(rules, seed=0, obs=True):
        tmpi.stop()
        kw = dict(obs="metrics", obs_dir=str(tmp_path / "obs")) if obs \
            else {}
        tmpi.init(device="cpu", faults=_plan(tmp_path, rules, seed), **kw)
        tfaults.ledger().clear()
        if obs:
            from torchmpi_tpu_torch import obs as tobs

            tobs.reset()
            return tobs
        return None

    yield arm
    if "torchmpi_tpu_torch.obs" in sys.modules:
        from torchmpi_tpu_torch import obs as tobs

        tobs.deactivate()
        tobs.reset()
    tfaults.reset()
    tmpi.stop()


def test_replica_kill_drains_and_reroutes(lm, armed):
    _, _, model = lm
    obs = armed([_kill_rule()])
    prompts = _prompts(10, seed=5)
    lens = [4, 12, 4, 8, 12, 8, 4, 12, 8, 4]
    reqs = [serving.Request(f"k{i}", prompts[i], max_new=lens[i],
                            arrival_s=0.01 * i) for i in range(10)]
    srv = serving.Server(model, replicas=2, slots=3, slot_tokens=32)
    # The router took the armed fault layer's ledger.
    assert srv.router._ledger is tfaults.ledger()
    done = srv.run_trace(reqs, tick_seconds=0.01)
    assert len(done) == 10  # the run COMPLETES despite the kill
    dead = [e.name for e in srv.router.replicas if e.dead]
    assert len(dead) == 1  # exactly the planned hard failure
    reg = obs.registry()
    rerouted = reg.counter_total("tm_serving_rerouted_total")
    assert rerouted > 0
    assert sum(r.reroutes for r in reqs) == rerouted
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], lens[i]), \
            (i, req.reroutes)
    snap = reg.snapshot()
    ttft = [r for r in snap if r["name"] == "tm_serving_ttft_us"]
    assert ttft and sum(r["count"] for r in ttft) == 10
    assert reg.counter("tm_fault_injected_total", site="serving.replica",
                       kind="fail", peer=dead[0]) == 1
    # The dead replica's ledger row is the fault layer's: dead.
    assert tfaults.ledger().state(dead[0]) == "dead"


def test_replica_transient_drop_stalls_a_tick(lm, armed):
    """A transient fault at ``serving.replica`` is one failure on the
    router's ledger: the replica sits out that tick and keeps serving
    (below the dead threshold), every stream still exact."""
    _, _, model = lm
    obs = armed([{"site": "serving.replica", "kind": "drop", "prob": 1.0,
                  "after": 1, "max_hits": 1}])
    prompts = _prompts(4, seed=9)
    reqs = [serving.Request(f"t{i}", prompts[i], max_new=6,
                            arrival_s=0.0) for i in range(4)]
    srv = serving.Server(model, replicas=1, slots=4, slot_tokens=32)
    done = srv.run_trace(reqs, tick_seconds=0.01)
    assert len(done) == 4 and not any(e.dead for e in srv.router.replicas)
    assert sum(r.reroutes for r in reqs) == 0
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], 6)
    assert obs.registry().counter_total("tm_fault_injected_total") == 1
    h = tfaults.ledger().get("replica0")
    assert h.total_failures == 1 and h.state == "healthy"


def test_mid_speculation_kill_discards_draft_state(lm, armed):
    _, _, model = lm
    dcfg = dict(vocab=VOCAB, embed=16, depth=1, num_heads=2, head_dim=8,
                max_len=32, pos_emb="rope")
    _, draft_model = _port_lm(JaxLM(**dcfg), 8, **dcfg)
    obs = armed([_kill_rule(after=4)])
    prompts = _prompts(8, seed=43)
    lens = [8, 12, 8, 12, 8, 12, 8, 12]
    reqs = [serving.Request(f"c{i}", prompts[i], max_new=lens[i],
                            arrival_s=0.01 * i) for i in range(8)]
    srv = serving.Server(model, replicas=2, slots=3, slot_tokens=32,
                         spec_k=3, draft=serving.ModelDraft(draft_model))
    done = srv.run_trace(reqs, tick_seconds=0.01)
    assert len(done) == 8
    dead = [e for e in srv.router.replicas if e.dead]
    assert len(dead) == 1
    rerouted = obs.registry().counter_total("tm_serving_rerouted_total")
    assert rerouted > 0 and sum(r.reroutes for r in reqs) == rerouted
    assert dead[0].stats["spec_steps"] > 0
    assert dead[0]._draft.active_slots() == []
    assert dead[0].pool.in_use == 0
    live = next(e for e in srv.router.replicas if not e.dead)
    assert live._draft.active_slots() == []
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], lens[i])


def _shared_prefix_reqs(n=8, shared_len=17, seed=0, max_new=8):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, VOCAB, size=shared_len)
    reqs = []
    for i in range(n):
        tail = rng.integers(1, VOCAB, size=3)
        prompt = np.concatenate([shared, tail]).astype(np.int32)
        reqs.append(serving.Request(
            f"q{i}", prompt, max_new=max_new, arrival_s=0.0005 * i,
            temperature=0.8 if i % 2 else None,
            top_k=12 if i % 2 else None, seed=7 + i))
    return reqs


def _clone(reqs):
    return [serving.Request(r.rid, r.prompt, r.max_new,
                            arrival_s=r.arrival_s, temperature=r.temperature,
                            top_k=r.top_k, top_p=r.top_p, seed=r.seed)
            for r in reqs]


def test_prefix_cache_survives_replica_kill_bitwise(lm, armed):
    _, _, model = lm
    reqs = _shared_prefix_reqs()
    tmpi.stop()
    ref = _clone(reqs)  # no faults, cache off
    srv = serving.Server(model, replicas=1, slots=4, slot_tokens=64)
    assert len(srv.run_trace(ref, tick_seconds=0.001)) == len(ref)
    ref_toks = {r.rid: r.tokens for r in ref}
    armed([_kill_rule(after=6)], seed=3, obs=False)
    run = _clone(reqs)
    srv = serving.Server(model, replicas=2, slots=3, slot_tokens=64,
                         prefix_cache=16, prefix_block=8)
    done = srv.run_trace(run, tick_seconds=0.005)
    assert len(done) == len(run)
    assert sum(1 for e in srv.router.replicas if e.dead) == 1
    assert sum(r.reroutes for r in run) > 0
    assert {r.rid: r.tokens for r in run} == ref_toks
    for eng in srv.router.replicas:
        if eng._prefix is None:
            continue
        for node in eng._prefix._nodes:  # the drain released its pins
            assert eng.pool.block_refcount(node.bid) == 1


def test_serving_admit_drop_fault_sheds(lm, armed, tmp_path):
    jm, params, model = lm
    rules = [{"site": "serving.admit", "kind": "drop", "prob": 1.0,
              "after": 2, "max_hits": 2}]
    obs = armed(rules, seed=2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB, size=6).astype(np.int32)
               for _ in range(6)]
    reqs = [serving.Request(f"d{i}", prompts[i], max_new=4,
                            arrival_s=0.002 * i) for i in range(6)]
    srv = serving.Server(model, replicas=1, slots=3, slot_tokens=32)
    done = srv.run_trace(reqs, tick_seconds=0.001)
    assert len(done) == 6
    shed = [r for r in done if r.shed]
    assert [r.rid for r in shed] == ["d2", "d3"]  # after=2, 2 hits
    for r in shed:
        assert "serving.admit" in r.error and "injected drop" in r.error
    assert obs.registry().counter_total("tm_serving_shed_total") == 2
    assert obs.registry().counter_total("tm_fault_injected_total") == 2
    for r in done:
        if not r.shed:
            assert r.tokens == _offline(model, r.prompt, r.max_new)
    # The same plan through the JAX server sheds the same requests and
    # serves the rest the same streams.
    jmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, faults=_plan(tmp_path, rules, 2,
                                                   "jplan.json")))
    try:
        jreqs = [jserving.Request(f"d{i}", prompts[i], max_new=4,
                                  arrival_s=0.002 * i) for i in range(6)]
        jsrv = jserving.Server(jm, params, replicas=1, slots=3,
                               slot_tokens=32)
        jdone = jsrv.run_trace(jreqs, tick_seconds=0.001)
        assert [r.rid for r in jdone if r.shed] == ["d2", "d3"]
        assert {r.rid: r.tokens for r in jdone} == \
            {r.rid: r.tokens for r in done}
        assert [r.error for r in jdone if r.shed] == \
            [r.error for r in shed]
    finally:
        importlib.import_module("torchmpi_tpu.faults").reset()
        jmpi.stop()


def test_chaos_lint_flags_corrupt_at_admit(tmp_path):
    from torchmpi_tpu_torch.faults import inject, tool

    assert "serving.admit" in inject.SITES
    assert "serving.admit" not in inject.PAYLOAD_SITES
    bad = inject.FaultPlan.from_json(
        {"version": 1, "seed": 0,
         "rules": [{"site": "serving.admit", "kind": "corrupt"}]})
    assert any("no payload" in p for p in inject.lint_plan(bad))
    good = inject.FaultPlan.from_json(
        {"version": 1, "seed": 0,
         "rules": [{"site": "serving.admit", "kind": "drop"}]})
    assert inject.lint_plan(good) == []
    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(
        {"version": 1, "seed": 0,
         "rules": [{"site": "serving.admit", "kind": "corrupt"}]}))
    assert tool.main(["lint", str(bad_path)]) == 1


def test_non_fault_step_error_stays_loud(lm, armed):
    """Only the fault layer's errors take the resilience path: a model
    bug in a replica step raises out of ``run_trace``."""
    _, _, model = lm
    armed([], obs=False)
    srv = serving.Server(model, replicas=2, slots=2, slot_tokens=32)
    eng = srv.router.replicas[0]

    def broken():
        raise ValueError("model bug")

    eng.step = broken
    reqs = [serving.Request("b0", _prompts(1)[0], max_new=3)]
    with pytest.raises(ValueError, match="model bug"):
        srv.run_trace(reqs, tick_seconds=0.01)
