"""The port's continuous-batching serving layer (torchmpi_tpu_torch/
serving/) on the CPU, the cases of the JAX package's tests/test_serving.py
and tests/test_serving_fleet.py that need neither the fault layer, the
telemetry nor TP replicas (ROADMAP queue A, items 10 and 9 (b)).

The model is JAX's fixture (vocab 41, embed 32, depth 2, 4 heads of 8,
RoPE, max_len 64), its flax weights loaded into the port's model with
``weights.from_flax_params``.  Every greedy stream is held token for token
to the port's offline ``generate`` of that prompt alone, and the port's
offline streams to JAX's ``generate`` on the same prompts.  Sampled
streams are held to themselves across layouts, speculation and the prefix
cache, bitwise (ROADMAP queue C note 2), and to the port's offline
sampled ``generate`` at the request's seed.  The slot primitives start
from one cache (``weights.from_flax_cache``) on both sides: identical
tokens, caches within 1e-5; a clamped out-of-range write lands on JAX's
bits.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmpi_tpu as jmpi
from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.models import generate as jax_generate
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import serving, weights as tweights
from torchmpi_tpu_torch.faults.health import HealthLedger
from torchmpi_tpu_torch.models import TransformerLM, generate
from torchmpi_tpu_torch.serving.prefix_cache import PrefixCache
from torchmpi_tpu_torch.serving.slots import SlotPool

# The modules (the packages export functions of the same name).
jgen = importlib.import_module("torchmpi_tpu.models.generate")
pgen = importlib.import_module("torchmpi_tpu_torch.models.generate")

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 41
CFG = dict(vocab=VOCAB, embed=32, depth=2, num_heads=4, head_dim=8,
           max_len=64, pos_emb="rope")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
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


def _offline(model, prompt, steps, eos_id=None, **kw):
    """The static offline oracle: the port's ``generate`` on [1, Tp]."""
    out = generate(model, np.asarray(prompt).reshape(1, -1), steps,
                   eos_id=eos_id, **kw)
    return out[0, np.asarray(prompt).size:].tolist()


def _clone(reqs):
    return [serving.Request(r.rid, r.prompt, r.max_new,
                            arrival_s=r.arrival_s, eos_id=r.eos_id,
                            temperature=r.temperature, top_k=r.top_k,
                            top_p=r.top_p, seed=r.seed) for r in reqs]


def _run_server(model, reqs, slots=3, slot_tokens=32, **kw):
    srv = serving.Server(model, replicas=1, slots=slots,
                         slot_tokens=slot_tokens, **kw)
    done = srv.run_trace(reqs, tick_seconds=0.001)
    assert len(done) == len(reqs)
    return srv.router.replicas[0]


# ---------------------------------------------------------------------------
# Slot pool, block ledger, prefix tree, admission / fleet controllers
# ---------------------------------------------------------------------------


def test_slot_pool_lifecycle():
    pool = SlotPool(3, slot_tokens=16)
    assert pool.fits(16) and not pool.fits(17) and not pool.fits(0)
    got = [pool.alloc() for _ in range(3)]
    assert sorted(got) == [0, 1, 2]
    assert pool.alloc() is None
    assert pool.in_use == 3 and pool.occupancy_pct() == 100.0
    pool.free(1)
    assert pool.alloc() == 1  # LIFO reuse
    pool.free(2)
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(2)
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(7)
    for bad in ((0, 16), (2, 0), (1, 8, -1)):
        with pytest.raises(ValueError):
            SlotPool(*bad)


def test_block_ledger_refcount_protocol():
    pool = SlotPool(2, 16, prefix_blocks=3)
    a, b = pool.block_alloc(), pool.block_alloc()
    assert (a, b) == (0, 1) and pool.block_refcount(a) == 1
    assert pool.block_ref(a) == 2 and pool.block_deref(a) == 1
    assert pool.block_deref(a) == 0 and pool.block_refcount(a) == 0
    with pytest.raises(ValueError, match="not live"):
        pool.block_deref(a)  # double release
    with pytest.raises(ValueError, match="not live"):
        pool.block_ref(99)
    c, d = pool.block_alloc(), pool.block_alloc()
    assert (c, d) == (2, 3)  # ids never reissued
    assert pool.block_alloc() is None and pool.blocks_in_use == 3
    assert SlotPool(1, 8).prefix_blocks == 0


def test_prefix_cache_match_insert_evict():
    pool = SlotPool(1, 16, prefix_blocks=2)
    pc = PrefixCache(pool, block_tokens=4)
    frags = []
    chain, n_new, n_ev = pc.insert(list(range(10)), 10,
                                   lambda i: frags.append(i) or f"f{i}")
    assert (len(chain), n_new, n_ev, frags) == (2, 2, 0, [0, 1])
    hit = pc.match(list(range(9)))  # one block short of the whole prompt
    assert [n.frag for n in hit] == ["f0", "f1"]
    assert pc.match(list(range(5)))[0].frag == "f0"
    assert pc.match([9, 9, 9, 9, 9]) == [] and pc.stats["misses"] == 1
    pc.pin(hit)
    # Full ledger, every block held or interior: nothing cached.
    chain, n_new, _ = pc.insert([7] * 8, 8, lambda i: f"g{i}")
    assert (chain, n_new) == ([], 0)
    pc.release(hit)
    chain, n_new, n_ev = pc.insert([7] * 8, 8, lambda i: f"g{i}")
    assert n_ev >= 1 and chain and chain[0].frag == "g0"
    with pytest.raises(ValueError, match="block_tokens"):
        PrefixCache(SlotPool(1, 8, prefix_blocks=2), block_tokens=9)
    with pytest.raises(ValueError, match="prefix_blocks"):
        PrefixCache(SlotPool(1, 16), block_tokens=4)


def test_admission_and_fleet_controllers():
    ac = serving.AdmissionController(1000.0, window=8, min_samples=4)
    for _ in range(3):
        ac.observe(0.5)  # 500,000 us, over budget, but too few samples
    ac.check("r0", 2)
    ac.observe(0.5)
    with pytest.raises(serving.AdmissionRejected, match="shed") as e:
        ac.check("r1", 3)
    assert e.value.queue_depth == 3 and ac.shed == 1
    assert not serving.AdmissionController(0.0).armed
    with pytest.raises(ValueError, match="high_water"):
        serving.FleetController(None, engine_factory=None, max_replicas=2,
                                high_water=1, low_water=1)
    with pytest.raises(ValueError, match="min_replicas"):
        serving.FleetController(None, engine_factory=None, max_replicas=2,
                                min_replicas=3)


def test_serving_config_fields():
    cfg = tmpi.Config.from_env()
    assert (cfg.serving_slots, cfg.serving_slot_tokens,
            cfg.serving_replicas, cfg.serving_sample, cfg.serving_spec_k,
            cfg.serving_prefill_buckets, cfg.serving_prefix_cache,
            cfg.serving_slo_ttft_us, cfg.serving_autoscale) == \
        (8, 0, 1, 0.0, 0, 0, 0, 0.0, 0)
    for bad in (dict(serving_prefix_cache=-1), dict(serving_autoscale=-2),
                dict(serving_slo_ttft_us=-0.5), dict(serving_slots=0),
                dict(serving_spec_k=-1)):
        with pytest.raises(ValueError):
            tmpi.Config.from_env(**bad)
    env = dict(os.environ, TORCHMPI_TPU_SERVING_SLOTS="5",
               TORCHMPI_TPU_SERVING_SAMPLE="0.7",
               TORCHMPI_TPU_SERVING_PREFIX_CACHE="16")
    out = subprocess.run(
        [sys.executable, "-c",
         "import torchmpi_tpu_torch as t; c = t.Config.from_env(); "
         "print(c.serving_slots, c.serving_sample, c.serving_prefix_cache)"],
        capture_output=True, text=True, env=env, cwd=_REPO, timeout=120)
    assert out.stdout.split() == ["5", "0.7", "16"], out.stderr


def test_serving_never_imported_unless_used():
    """A session that never serves never imports the serving package (nor
    the fault layer it brings): the JAX package's discipline."""
    code = ("import sys, torchmpi_tpu_torch as t; "
            "from torchmpi_tpu_torch.models import generate; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('torchmpi_tpu_torch.serving', 'torchmpi_tpu_torch.faults'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=_REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


# ---------------------------------------------------------------------------
# Continuous batching == offline generate, token for token
# ---------------------------------------------------------------------------


def test_continuous_matches_offline(lm):
    jm, params, model = lm
    prompts = _prompts(6)
    lens = [4, 12, 4, 8, 12, 8]
    reqs = [serving.Request(f"r{i}", prompts[i], max_new=lens[i],
                            arrival_s=0.002 * i) for i in range(6)]
    srv = serving.Server(model, replicas=1, slots=3, slot_tokens=32)
    done = srv.run_trace(reqs, tick_seconds=0.001)
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    for steps in (4, 8, 12):
        jax_out = np.asarray(jax_generate(jm, params, prompts, steps=steps))
        for i, req in enumerate(reqs):
            if lens[i] != steps:
                continue
            exp = _offline(model, prompts[i], steps)
            assert exp == jax_out[i, 5:].tolist(), i
            assert req.tokens == exp, (i, req.tokens, exp)
            assert req.ttft_s is not None and req.ttft_s >= 0
            assert req.latency_s() >= req.ttft_s
    assert srv.router.replicas[0].pool.in_use == 0
    stats = srv.last_stats
    assert stats["tokens"] == sum(lens) and stats["ticks"] > 0
    assert len(stats["itl_s"]) == sum(lens) - len(lens)


def test_eos_retirement_frees_slot_and_reuse_is_bitwise(lm):
    _, _, model = lm
    engine = serving.ReplicaEngine(model, slots=1, slot_tokens=32)
    pa, pb = _prompts(2, seed=3)
    free_run = _offline(model, pa, 8)
    eos = next(int(t) for t in free_run[1:] if t != free_run[0])
    exp_a = _offline(model, pa, 8, eos_id=eos)
    sess_a, done = engine.admit(serving.Request("a", pa, max_new=8,
                                                eos_id=eos))
    assert sess_a.slot == 0 and not done
    emitted = list(sess_a.emitted)
    while engine.pool.in_use:
        _, finished = engine.step()
        if finished:
            emitted = finished[0].emitted
    assert emitted[-1] == eos and len(emitted) < 8
    assert emitted == exp_a[:len(emitted)]
    assert engine.pool.free_count == 1
    # Reuse the same block, no zeroing, for an unrelated request.
    sess_b, done = engine.admit(serving.Request("b", pb, max_new=9))
    assert sess_b.slot == 0 and not done
    toks = list(sess_b.emitted)
    while engine.pool.in_use:
        _, finished = engine.step()
        if finished:
            toks = finished[0].emitted
    assert toks == _offline(model, pb, 9)


def test_request_that_cannot_fit_a_block_is_rejected(lm):
    _, _, model = lm
    engine = serving.ReplicaEngine(model, slots=2, slot_tokens=16)
    with pytest.raises(ValueError, match="slot block"):
        engine.admit(serving.Request("big", _prompts(1)[0], max_new=12))
    prompts = _prompts(3, seed=11)
    reqs = [serving.Request("ok0", prompts[0], max_new=4),
            serving.Request("big", prompts[1], max_new=99),
            serving.Request("ok1", prompts[2], max_new=4)]
    srv = serving.Server(model, replicas=1, slots=2, slot_tokens=32)
    done = srv.run_trace(reqs, tick_seconds=0.001)
    assert len(done) == 3
    bad = next(r for r in done if r.rid == "big")
    assert bad.error and "slot block" in bad.error and not bad.tokens
    for rid, i in (("ok0", 0), ("ok1", 2)):
        good = next(r for r in done if r.rid == rid)
        assert good.error is None
        assert good.tokens == _offline(model, prompts[i], 4)


def test_failed_prefill_does_not_leak_slot(lm, monkeypatch):
    eng_mod = importlib.import_module("torchmpi_tpu_torch.serving.engine")
    _, _, model = lm
    engine = serving.ReplicaEngine(model, slots=1, slot_tokens=32)
    monkeypatch.setattr(
        eng_mod, "slot_prefill",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("exploded")))
    with pytest.raises(RuntimeError, match="exploded"):
        engine.admit(serving.Request("x", _prompts(1)[0], max_new=4))
    assert engine.pool.free_count == 1


def test_engine_refusals():
    model = TransformerLM(vocab=VOCAB, embed=16, depth=1, num_heads=2,
                          head_dim=8, max_len=32, pos_emb="learned",
                          device="cpu")
    with pytest.raises(ValueError, match="rope"):
        serving.ReplicaEngine(model, slots=2, slot_tokens=16)
    serving.ReplicaEngine(model, slots=2, slot_tokens=32)
    with pytest.raises(NotImplementedError, match=r"queue A, item 9 \(b\)"):
        serving.Server.sharded(None, tp=2, num_heads=4, slot_tokens=32)


def test_learned_positions_serve_token_exact():
    """A learned-position model at full-size blocks: per-row position
    embeddings in the slot step."""
    cfg = dict(CFG, pos_emb="learned", max_len=32)
    jm = JaxLM(**cfg)
    params, model = _port_lm(jm, 2, **cfg)
    prompts = _prompts(3, seed=13)
    reqs = [serving.Request(f"l{i}", prompts[i], max_new=6,
                            arrival_s=0.001 * i) for i in range(3)]
    _run_server(model, reqs, slots=2)
    want = np.asarray(jax_generate(jm, params, prompts, steps=6))
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], 6) == \
            want[i, 5:].tolist()


# ---------------------------------------------------------------------------
# Router: health and the healed replica
# ---------------------------------------------------------------------------


def test_router_prefers_healthy_replicas(lm):
    _, _, model = lm
    e0 = serving.ReplicaEngine(model, name="r0", slots=2, slot_tokens=16)
    e1 = serving.ReplicaEngine(model, name="r1", slots=2, slot_tokens=16)
    router = serving.Router([e0, e1], ledger=HealthLedger(suspect_after=1,
                                                          dead_after=3))
    assert router.pick() in (e0, e1)
    router.record(e1, False)
    assert router.decide(e1) == "degrade"
    assert router.pick() is e0
    router.mark_dead(e1)
    assert router.decide(e1) == "raise" and router.pick() is e0
    with pytest.raises(ValueError, match="unique"):
        serving.Router([e0, e0])


def test_healed_replica_readmitted(lm):
    _, _, model = lm
    e0 = serving.ReplicaEngine(model, name="r0", slots=2, slot_tokens=16)
    e1 = serving.ReplicaEngine(model, name="r1", slots=2, slot_tokens=16)
    router = serving.Router([e0, e1], ledger=HealthLedger(suspect_after=2,
                                                          dead_after=3))
    router.mark_dead(e1)
    e1.drain()
    assert e1.dead and router.decide(e1) == "raise"
    assert router.pick() is e0 and router.live() == [e0]
    assert router.record(e1, ok=False) == "raise" and e1.dead
    assert router.record(e1, ok=True) == "ok" and not e1.dead
    assert router.live() == [e0, e1]
    srv = serving.Server.__new__(serving.Server)
    srv.router = router
    srv.last_stats = {}
    prompts = _prompts(2, seed=9)
    reqs = [serving.Request(f"h{i}", prompts[i], max_new=4)
            for i in range(2)]
    done = srv.run_trace(reqs, tick_seconds=0.01)
    assert len(done) == 2 and {r.replica for r in reqs} == {"r0", "r1"}
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], 4)


# ---------------------------------------------------------------------------
# Sampled decode: reproducible, layout-independent, greedy untouched
# ---------------------------------------------------------------------------


def _sampled_reqs(prompts, max_new=6, seed0=100):
    return [serving.Request(f"p{i}", prompts[i], max_new=max_new,
                            arrival_s=0.001 * i, temperature=0.9, top_k=12,
                            top_p=0.9, seed=seed0 + i)
            for i in range(len(prompts))]


def test_sampled_decode_reproducible_across_layouts(lm):
    """Token i draws from (seed, i), never from the slot, neighbours or
    replica: the same streams under 1 and 2 replicas, 3 and 2 slots, in
    reversed arrival order; and each equals the offline sampled
    ``generate`` at the request's seed."""
    _, _, model = lm
    prompts = _prompts(6, seed=21)
    streams = []
    for replicas, slots, order in ((1, 3, 1), (2, 2, -1), (1, 3, 1)):
        reqs = _sampled_reqs(prompts)[::order]
        srv = serving.Server(model, replicas=replicas, slots=slots,
                             slot_tokens=32)
        assert len(srv.run_trace(reqs, tick_seconds=0.001)) == 6
        streams.append({r.rid: list(r.tokens) for r in reqs})
    assert streams[0] == streams[1] == streams[2]
    greedy = {f"p{i}": _offline(model, prompts[i], 6) for i in range(6)}
    assert any(streams[0][k] != greedy[k] for k in greedy)
    for i in range(6):
        assert streams[0][f"p{i}"] == _offline(
            model, prompts[i], 6, temperature=0.9, top_k=12, top_p=0.9,
            seed=[100 + i])


def test_greedy_ignores_stray_filter_knobs(lm):
    _, _, model = lm
    prompts = _prompts(3, seed=23)
    reqs = [serving.Request(f"g{i}", prompts[i], max_new=6,
                            temperature=0.0, top_k=3, top_p=0.5, seed=9)
            for i in range(3)]
    _run_server(model, reqs)
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], 6)


def test_invalid_sampling_rejected(lm):
    _, _, model = lm
    engine = serving.ReplicaEngine(model, slots=1, slot_tokens=32)
    with pytest.raises(serving.RequestRejected, match="top_p"):
        engine.admit(serving.Request("bad", _prompts(1)[0], max_new=4,
                                     temperature=0.5, top_p=0.0))
    with pytest.raises(serving.RequestRejected, match="top_k"):
        engine.admit(serving.Request("bad", _prompts(1)[0], max_new=4,
                                     temperature=0.5, top_k=-2))
    assert engine.pool.free_count == 1


# ---------------------------------------------------------------------------
# Speculative decoding: bitwise the plain stream, cheaper per token
# ---------------------------------------------------------------------------


def test_spec_ngram_bitwise_and_cheaper(lm):
    _, _, model = lm
    prompts = _prompts(6, seed=31)

    def reqs():
        out = [serving.Request(f"n{i}", prompts[i], max_new=12)
               for i in range(4)]
        out += [serving.Request(f"n{i}", prompts[i], max_new=12,
                                temperature=0.8, top_k=10, seed=50 + i)
                for i in range(4, 6)]
        return out

    plain_reqs, spec_reqs = reqs(), reqs()
    plain = _run_server(model, plain_reqs)
    spec = _run_server(model, spec_reqs, spec_k=4)
    assert {r.rid: r.tokens for r in plain_reqs} == \
        {r.rid: r.tokens for r in spec_reqs}
    assert spec.stats["spec_steps"] > 0 and spec.stats["spec_drafted"] > 0
    assert 0 < spec.stats["spec_accepted"] <= spec.stats["spec_drafted"]
    assert spec.units < plain.units


def test_spec_fills_slot_block_exactly(lm):
    _, _, model = lm
    prompts = _prompts(2, seed=33)
    reqs = [serving.Request(f"e{i}", prompts[i], max_new=11)
            for i in range(2)]  # 5 + 11 == 16 == slot_tokens
    _run_server(model, reqs, slots=2, slot_tokens=16, spec_k=4)
    for i, req in enumerate(reqs):
        assert req.tokens == _offline(model, prompts[i], 11)


def test_spec_model_draft_bitwise(lm):
    _, _, model = lm
    dcfg = dict(vocab=VOCAB, embed=16, depth=1, num_heads=2, head_dim=8,
                max_len=32, pos_emb="rope")
    _, draft_model = _port_lm(JaxLM(**dcfg), 7, **dcfg)
    draft = serving.ModelDraft(draft_model)
    prompts = _prompts(4, seed=37)

    def reqs():
        out = [serving.Request(f"m{i}", prompts[i], max_new=8)
               for i in range(2)]
        out += [serving.Request(f"m{i}", prompts[i], max_new=8,
                                temperature=0.7, top_p=0.9, seed=60 + i)
                for i in range(2, 4)]
        return out

    plain_reqs, spec_reqs = reqs(), reqs()
    _run_server(model, plain_reqs)
    eng = _run_server(model, spec_reqs, spec_k=3, draft=draft)
    assert {r.rid: r.tokens for r in plain_reqs} == \
        {r.rid: r.tokens for r in spec_reqs}
    assert eng.stats["spec_steps"] > 0
    assert 0 < eng._draft.unit_weight < 1
    assert eng.units > eng.stats["prefills"] + eng.stats["steps"]
    assert eng._draft.active_slots() == []


# ---------------------------------------------------------------------------
# Bucketed prefill; the prefix cache
# ---------------------------------------------------------------------------


def test_bucketed_prefill_count_and_bitwise(lm):
    _, _, model = lm
    rng = np.random.RandomState(41)
    plens = [3, 5, 9, 3, 5, 9]
    prompts = [rng.randint(0, VOCAB, size=(L,)).astype(np.int32)
               for L in plens]

    def reqs():
        return [serving.Request(f"b{i}", prompts[i], max_new=4)
                for i in range(6)]

    plain_reqs, buck_reqs = reqs(), reqs()
    plain = _run_server(model, plain_reqs)
    buck = _run_server(model, buck_reqs, prefill_bucket=8)
    assert plain.stats["prefill_compiles"] == 3
    assert buck.stats["prefill_compiles"] == 2
    assert {r.rid: r.tokens for r in plain_reqs} == \
        {r.rid: r.tokens for r in buck_reqs}
    for i, req in enumerate(plain_reqs):
        assert req.tokens == _offline(model, prompts[i], 4)


def _shared_prefix_reqs(n=6, shared_len=17, seed=0, max_new=6):
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


def test_prefix_hit_bitwise_and_prefill_win(lm):
    _, _, model = lm
    reqs = _shared_prefix_reqs()
    off_reqs, on_reqs = _clone(reqs), _clone(reqs)
    off = _run_server(model, off_reqs, slots=4, slot_tokens=64)
    on = _run_server(model, on_reqs, slots=4, slot_tokens=64,
                     prefix_cache=16, prefix_block=8)
    assert {r.rid: r.tokens for r in on_reqs} == \
        {r.rid: r.tokens for r in off_reqs}
    for r in on_reqs:
        if r.temperature is None:
            assert r.tokens == _offline(model, r.prompt, r.max_new)
    assert on.stats["prefix_hits"] > 0
    assert on.stats["prefill_tokens"] < off.stats["prefill_tokens"]
    assert on.pool.blocks_in_use == on._prefix.n_nodes
    for node in on._prefix._nodes:
        assert on.pool.block_refcount(node.bid) == 1


def test_shared_blocks_pinned_during_decode_released_after(lm):
    _, _, model = lm
    eng = serving.ReplicaEngine(model, slots=2, slot_tokens=64,
                                prefix_cache=8, prefix_block=8)
    rng = np.random.default_rng(3)
    shared = rng.integers(1, VOCAB, size=16)
    pa = np.concatenate([shared, rng.integers(1, VOCAB, size=3)])
    pb = np.concatenate([shared, rng.integers(1, VOCAB, size=4)])
    sess_a, done = eng.admit(serving.Request("a", pa, max_new=8))
    shared_chain = sess_a.prefix_chain[:2]
    assert not done and len(shared_chain) == 2
    before = [n.frag.k[0].clone() for n in shared_chain]
    sess_b, done = eng.admit(serving.Request("b", pb, max_new=8))
    assert not done and eng.stats["prefix_hits"] == 1
    for node in shared_chain:
        assert eng.pool.block_refcount(node.bid) == 3
    while eng.active:
        eng.step()
    for b, node in zip(before, shared_chain):
        assert eng.pool.block_refcount(node.bid) == 1
        assert torch.equal(b, node.frag.k[0])  # copy-on-extend: intact
    assert sess_b.emitted == _offline(model, pb, 8)
    eng.admit(serving.Request("c", pa, max_new=4))
    for node in shared_chain:
        assert eng.pool.block_refcount(node.bid) == 2
    while eng.active:
        eng.step()
    assert all(eng.pool.block_refcount(n.bid) == 1 for n in shared_chain)
    assert eng.pool.in_use == 0


# ---------------------------------------------------------------------------
# Autoscale: scale events token-exact, a retired replica stays out
# ---------------------------------------------------------------------------


def test_autoscale_up_down_streams_exact_retired_stays_out(lm):
    _, _, model = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, VOCAB, size=6).astype(np.int32)
               for _ in range(20)]
    reqs = [serving.Request(f"s{i}", prompts[i], max_new=6,
                            arrival_s=0.0005 * i) for i in range(20)]

    def factory(name):
        return serving.ReplicaEngine(model, name=name, slots=2,
                                     slot_tokens=32)

    srv = serving.Server(model, replicas=1, slots=2, slot_tokens=32,
                         autoscale=3, engine_factory=factory,
                         scale_high_water=2, scale_low_water=0,
                         scale_sustain=2)
    assert len(srv.run_trace(reqs, tick_seconds=0.001)) == 20
    assert "scale_up" in srv._fleet.events
    assert any(r.replica.startswith("scale") for r in reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == _offline(model, prompts[i], 6), r.rid
    retired = [e for e in srv.router.replicas
               if getattr(e, "retired", False)]
    if "scale_down" in srv._fleet.events:
        assert retired
    for eng in retired:
        srv.router.readmit(eng)
        assert eng.dead and eng not in srv.router.live()
    with pytest.raises(ValueError, match="engine_factory"):
        serving.Server(model, replicas=1, slots=2, slot_tokens=32,
                       autoscale=2, engines=[factory("pre0")])


def test_slo_gate_sheds_on_the_unit_clock(lm):
    """An armed SLO gate sheds arrivals once the window's p95 TTFT is over
    budget; shed requests complete at once with the typed error, admitted
    ones stay token-exact."""
    _, _, model = lm
    prompts = _prompts(16, seed=51)
    reqs = [serving.Request(f"o{i}", prompts[i], max_new=4,
                            arrival_s=0.5 * i) for i in range(16)]
    srv = serving.Server(model, replicas=1, slots=2, slot_tokens=32,
                         slo_ttft_us=1.0)
    srv._admission.min_samples = 2
    done = srv.run_trace(reqs, unit_seconds=1.0)
    assert len(done) == 16
    shed = [r for r in reqs if r.shed]
    served = [r for r in reqs if not r.shed]
    assert shed and served and srv._admission.shed == len(shed)
    assert all("shed" in r.error and not r.tokens for r in shed)
    assert all(r.tokens == _offline(model, r.prompt, 4) for r in served)


# ---------------------------------------------------------------------------
# Slot primitives from one cache; the clamp
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def gqa_lm():
    """JAX's fixture with 2 kv heads and a window of 6."""
    cfg = dict(CFG, num_kv_heads=2, window=6)
    jm = JaxLM(**cfg)
    params, pm = _port_lm(jm, 1, **cfg)
    return jm, params, pm


def test_slot_primitives_match_jax_from_one_cache(gqa_lm):
    jm, params, pm = gqa_lm
    st, S = 32, 3
    dm = jm.clone(decode=True, max_len=st)
    rng = np.random.RandomState(1)
    # A pool cache in a mid-trace state: rows filled to different depths
    # by JAX's own prefills.
    pool = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda: dm.init(
            jax.random.PRNGKey(0), jnp.zeros((S, 1), jnp.int32),
            pos_offset=jnp.zeros((S,), jnp.int32)))["cache"])
    # One prompt of 11 prefilled by both and copied into every row; the
    # rows then decode from depths 7, 4 and 11, so rows 0 and 1 hold stale
    # entries past their depth that the per-row mask must hide.
    prompt = rng.randint(0, jm.vocab, size=(1, 11)).astype(np.int32)
    jone, jfirst = jgen.slot_prefill(dm, params, prompt)
    pone, pfirst = pgen.slot_prefill(pm, torch.from_numpy(prompt).long(),
                                     max_len=st)
    assert int(_np(pfirst)[0]) == int(np.asarray(jfirst)[0])
    np.testing.assert_allclose(
        _np(pone.k[1]), np.asarray(jone["Block_1"]["SPAttention_0"]["k"]),
        **TOL)
    for s_ in range(S):
        pool = jgen.slot_write(pool, jone, s_)
    depths = [7, 4, 11]
    pcache = tweights.from_flax_cache(jax.tree.map(np.asarray, pool), "cpu")
    toks = rng.randint(0, jm.vocab, size=(S,)).astype(np.int32)
    pos = np.asarray(depths, np.int32)
    for _ in range(3):  # decode steps at per-row depths
        pool, nxt = jgen.slot_decode_step(dm, params, pool, toks, pos)
        _, pn = pgen.slot_decode_step(
            pm, pcache, torch.from_numpy(toks).long(),
            torch.from_numpy(pos).long())
        np.testing.assert_array_equal(_np(pn), np.asarray(nxt))
        toks, pos = np.asarray(nxt).astype(np.int32), pos + 1
    vt = np.concatenate([toks[:, None], rng.randint(
        0, jm.vocab, size=(S, 3))], axis=1).astype(np.int32)
    pool, jout = jgen.slot_verify_step(dm, params, pool, vt, pos)
    _, pout = pgen.slot_verify_step(pm, pcache, torch.from_numpy(vt).long(),
                                    torch.from_numpy(pos).long())
    np.testing.assert_array_equal(_np(pout), np.asarray(jout))
    back = tweights.to_flax_cache(pcache)
    for blk in back:
        for name in ("k", "v"):
            np.testing.assert_allclose(
                back[blk]["SPAttention_0"][name],
                np.asarray(pool[blk]["SPAttention_0"][name]), **TOL)
    # Prefix-cache fragments: slice the prompt's first 8 positions, write
    # them onto a fresh row, extend the rest of the prompt: the same token
    # as the full prefill.
    frag = jgen.slot_cache_slice(jone, 0, 8)
    row = jax.tree.map(lambda a: jnp.zeros_like(a), jone)
    row = jgen.slot_cache_write(row, frag, 0)
    jext, jtok = jgen.slot_extend(dm, params, row, prompt[:, 8:],
                                  pos_offset=np.asarray([8], np.int32))
    prow = pgen.slot_cache_write(pm.init_cache(1, st),
                                 pgen.slot_cache_slice(pone, 0, 8), 0)
    pext, ptok = pgen.slot_extend(pm, prow,
                                  torch.from_numpy(prompt[:, 8:]).long(),
                                  pos_offset=torch.tensor([8]))
    assert int(_np(ptok)[0]) == int(np.asarray(jtok)[0]) == \
        int(np.asarray(jfirst)[0])
    np.testing.assert_allclose(
        _np(pext.v[0]), np.asarray(jext["Block_0"]["SPAttention_0"]["v"]),
        **TOL)


def test_out_of_range_writes_clamp_as_jax(gqa_lm):
    """Out-of-range starts clamp as ``dynamic_update_slice``'s do: a
    fragment written past a row's end and a row written past the pool's
    last slot land on the same bits as JAX's; a decode step at positions
    past the cache end writes the same (last) positions."""
    jm, params, pm = gqa_lm
    st = 16
    dm = jm.clone(decode=True, max_len=st)
    rng = np.random.RandomState(5)
    row = {f"Block_{i}": {"SPAttention_0": {
        "k": rng.randn(1, st, 2, 8).astype(np.float32),
        "v": rng.randn(1, st, 2, 8).astype(np.float32),
        "idx": np.asarray(0, np.int32)}} for i in range(2)}
    frag = jax.tree.map(lambda a: a[:, :5] + 1.0 if a.ndim else a, row)
    want = jgen.slot_cache_write(row, frag, 14)
    got = pgen.slot_cache_write(tweights.from_flax_cache(row, "cpu"),
                                tweights.from_flax_cache(frag, "cpu"), 14)
    for blk, layer in tweights.to_flax_cache(got).items():
        np.testing.assert_array_equal(
            layer["SPAttention_0"]["k"],
            np.asarray(want[blk]["SPAttention_0"]["k"]))
    pool = jax.tree.map(lambda a: np.repeat(a, 3, 0) if a.ndim else a, row)
    frag_row = jax.tree.map(lambda a: a * 2.0, row)
    want = jgen.slot_write(pool, frag_row, 9)
    got = pgen.slot_write(tweights.from_flax_cache(pool, "cpu"),
                          tweights.from_flax_cache(frag_row, "cpu"), 9)
    for blk, layer in tweights.to_flax_cache(got).items():
        np.testing.assert_array_equal(
            layer["SPAttention_0"]["v"],
            np.asarray(want[blk]["SPAttention_0"]["v"]))
    zero = jax.tree.map(lambda a: np.zeros_like(a), pool)
    toks = np.array([3, 4, 5], np.int32)
    pos = np.array([2, st + 4, st - 1], np.int32)
    jpool, _ = jgen.slot_decode_step(dm, params, zero, toks, pos)
    pcache, _ = pgen.slot_decode_step(
        pm, tweights.from_flax_cache(zero, "cpu"),
        torch.from_numpy(toks).long(), torch.from_numpy(pos).long())
    for blk, layer in tweights.to_flax_cache(pcache).items():
        jk = np.asarray(jpool[blk]["SPAttention_0"]["k"])
        np.testing.assert_array_equal(layer["SPAttention_0"]["k"] != 0,
                                      jk != 0)
        np.testing.assert_allclose(layer["SPAttention_0"]["k"], jk, **TOL)
    assert pgen.clamp_slot_positions(-3, 16) == 0
    assert pgen.clamp_slot_positions(40, 16, 4) == 12
    np.testing.assert_array_equal(
        _np(pgen.clamp_slot_positions(torch.tensor([-1, 5, 99]), 16, 2)),
        np.asarray(jgen.clamp_slot_positions(jnp.asarray([-1, 5, 99]),
                                             16, 2)))
