"""The port's tensor-parallel serving replicas (serving/tp_engine.py,
``Server.sharded``, ``planner.plan_serving_replica``) on the CPU.

JAX's cases (tests/test_serving.py:596-660, tests/test_serving_fleet.py:414)
on JAX's tree (``init_tp_lm``, vocab 64, embed 32, depth 2, 4 heads of 8,
seed 5) carried across with ``weights.from_numpy_tree``; the replicas are
rank-major stacks of 2 ranks in a world of one process.

- Every greedy stream of a 2-replica server equals JAX's offline
  ``tp_generate`` of its prompt alone (on the 8-device CPU mesh's first 2
  devices), both replicas serve, and speculation plus bucketed prefill
  leave the streams unchanged (one prefill length).
- The prefix cache: streams with it on equal the streams with it off,
  greedy and sampled, with hits, every block released.
- Sampled streams (ROADMAP queue C note 2): bitwise across slot layouts
  and arrival orders, on the stock route and on the ring (its plain
  version on the CPU: the sums run feature-major), and the sampler's
  frequencies at the TP logits within 5 standard errors of the filtered
  softmax (4,000 draws).
- One plan row a replica, keyed on its communicator; JAX's refusals.
The process-world replicas are held to these in
tests/test_torch_parallel_decode_world.py.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import serving
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import TransformerLM

from _torch_world import module_group

jtpg = importlib.import_module("torchmpi_tpu.models.tp_generate")
ptpg = importlib.import_module("torchmpi_tpu_torch.models.tp_generate")
pgen = importlib.import_module("torchmpi_tpu_torch.models.generate")

torch.set_num_threads(2)

V = 64


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with module_group():
        jmpi.init(jmpi.Config(dcn_size=1))
        tmpi.init(device="cpu")
        yield


_TREE = {}


def _tree():
    if not _TREE:
        params = jtpg.init_tp_lm(jax.random.PRNGKey(5), vocab=V, embed=32,
                                 depth=2, num_heads=4, head_dim=8)
        params = jax.tree.map(np.asarray, params)
        _TREE["t"] = (params, tweights.from_numpy_tree(params, "cpu"))
    return _TREE["t"]


def _clone(reqs, **over):
    return [serving.Request(r.rid, r.prompt, max_new=r.max_new,
                            arrival_s=over.get("arrival", {}).get(
                                r.rid, r.arrival_s),
                            temperature=r.temperature, top_k=r.top_k,
                            top_p=r.top_p, seed=r.seed) for r in reqs]


def test_sharded_server_matches_jax_tp_oracle():
    params, tparams = _tree()
    rng = np.random.RandomState(13)
    prompts = rng.randint(0, V, size=(6, 5)).astype(np.int32)
    lens = [4, 8, 4, 8, 4, 8]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    oracle = {f"t{i}": np.asarray(jtpg.tp_generate(
        params, prompts[i].reshape(1, -1), steps=lens[i], mesh=mesh,
        axis="model", num_heads=4))[0, 5:].tolist() for i in range(6)}

    reqs = [serving.Request(f"t{i}", prompts[i], max_new=lens[i],
                            arrival_s=0.001 * i) for i in range(6)]
    srv = serving.Server.sharded(tparams, tp=2, num_heads=4, slot_tokens=32,
                                 replicas=2, slots=2)
    done = srv.run_trace(reqs, tick_seconds=0.001)
    assert len(done) == 6
    assert {r.replica for r in reqs} == {"tp0", "tp1"}
    for req in reqs:
        assert req.tokens == oracle[req.rid], req.rid

    # Speculation + bucketing over the same sharded stack: bitwise.
    reqs2 = _clone(reqs)
    srv2 = serving.Server.sharded(tparams, tp=2, num_heads=4,
                                  slot_tokens=32, replicas=1, slots=2,
                                  spec_k=3, prefill_bucket=8)
    assert len(srv2.run_trace(reqs2, tick_seconds=0.001)) == 6
    for req in reqs2:
        assert req.tokens == oracle[req.rid]
    eng = srv2.router.replicas[0]
    assert eng.stats["spec_steps"] > 0
    assert eng.stats["prefill_compiles"] == 1  # one 8-bucket

    # One decision-only plan row a replica, keyed on its communicator.
    with tmpi.communicator("tp0") as comm:
        p1 = tmpi.planner.plan_serving_replica("tp0", comm, ("model",), n=2)
        assert p1 is tmpi.planner.plan_serving_replica("tp0", comm,
                                                       ("model",), n=2)
    assert p1.kind == "serving" and p1.backend == "rank_major"
    assert p1.extra["devices"] == 2 and p1.extra["axes"] == ("model",)
    rows = [r for r in tmpi.planner.describe() if r["kind"] == "serving"]
    assert {"model=2"} == {r["topology"] for r in rows}


def test_sharded_server_defaults_and_refusals():
    params, tparams = _tree()
    with pytest.raises(ValueError, match="tp must be >= 1"):
        serving.Server.sharded(tparams, tp=0, num_heads=4, slot_tokens=32)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        serving.Server.sharded(tparams, tp=2, num_heads=4, slot_tokens=32,
                               replicas=4, devices=[0, 1, 2, 3])
    # As many replicas as the ranks hold: a communicator of 4 ranks, tp 2.
    with tmpi.communicator("four", shape={"ici": 4}):
        srv = serving.Server.sharded(tparams, tp=2, num_heads=4,
                                     slot_tokens=32, slots=1)
        assert [e.name for e in srv.router.replicas] == ["tp0", "tp1"]
    with pytest.raises(ValueError, match="slot_tokens"):
        serving.TPReplicaEngine(tparams, num_heads=4, communicator="tp0",
                                slots=2)
    # The dense engine keeps JAX's refusal of a mesh-parallel model.
    moe = TransformerLM(vocab=8, embed=16, depth=1, num_heads=2,
                        head_dim=8, max_len=16, moe_axis="ici",
                        moe_axis_size=2, device="cpu")
    with pytest.raises(ValueError, match="TPReplicaEngine"):
        serving.ReplicaEngine(moe, slots=2)


def _prefix_reqs():
    rng = np.random.default_rng(0)
    shared = rng.integers(1, V, size=17)
    reqs = []
    for i in range(6):
        tail = rng.integers(1, V, size=3 + i)
        reqs.append(serving.Request(
            f"q{i}", np.concatenate([shared, tail]).astype(np.int32),
            max_new=6, arrival_s=0.0,
            temperature=0.8 if i % 2 else None,
            top_k=12 if i % 2 else None, seed=7 + i))
    return reqs


def test_tp_prefix_cache_bitwise():
    """The radix tree drives the TP cache layout too (JAX's
    test_tp_prefix_bitwise): streams with the cache on equal the
    cache-off ones, greedy and sampled."""
    _, tparams = _tree()

    def run(**kw):
        srv = serving.Server.sharded(tparams, tp=2, num_heads=4,
                                     slot_tokens=64, replicas=1, slots=4,
                                     **kw)
        out = _clone(_prefix_reqs())
        assert len(srv.run_trace(out, tick_seconds=0.001)) == len(out)
        return {r.rid: r.tokens for r in out}, srv.router.replicas[0]

    off_toks, _ = run()
    on_toks, eng = run(prefix_cache=16, prefix_block=8)
    assert on_toks == off_toks
    assert eng.stats["prefix_hits"] > 0
    for node in eng._prefix._nodes:
        assert eng.pool.block_refcount(node.bid) == 1


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_tp_sampled_streams_bitwise_across_layouts(backend):
    """On the stock route and on the ring (its plain version here): the
    sums run feature-major, so a slot's bits do not depend on the pool's
    slot count."""
    _, tparams = _tree()
    rng = np.random.RandomState(3)
    reqs = [serving.Request(f"s{i}", rng.randint(0, V, size=4 + i % 3),
                            max_new=5 + i % 4, arrival_s=0.001 * i,
                            temperature=0.9, top_p=0.9 if i % 2 else None,
                            seed=100 + i) for i in range(8)]
    streams = []
    for slots, order in ((4, 1), (2, -1)):
        arr = {r.rid: a for r, a in zip(reqs, [r.arrival_s
                                               for r in reqs][::order])}
        rs = _clone(reqs, arrival=arr)
        serving.Server.sharded(tparams, tp=2, num_heads=4, slot_tokens=32,
                               replicas=1, slots=slots,
                               backend=backend).run_trace(
            rs, tick_seconds=0.001)
        streams.append({r.rid: r.tokens for r in rs})
    assert streams[0] == streams[1]
    assert len({tuple(t) for t in streams[0].values()}) > 1


def test_tp_sampler_frequencies_follow_the_filtered_softmax():
    """4,000 rows of one prompt, each its own seed, through the TP prefill:
    the first token's frequencies within 5 standard errors of the top-k
    filtered softmax of the TP logits at temperature 0.7."""
    _, tparams = _tree()
    R, T, k = 4000, 0.7, 8
    prompt = np.tile(np.array([[3, 14, 15, 9]], np.int32), (R, 1))
    with tmpi.communicator("tp0"):
        stacks = ptpg.shard_tp_lm_rank_major(tparams, 2, "model")[0]
        st = ptpg._Stack(stacks, ptpg._Form("model", 2, None), 4)
        x, _ = st.prefill(torch.from_numpy(prompt[:1]), 8)
        logits = st.logits(x[:, :, -1])[0]
        samp = (torch.arange(R), torch.zeros(R, dtype=torch.long),
                torch.full((R,), T), torch.full((R,), k, dtype=torch.long),
                torch.full((R,), 2.0))
        _, first = ptpg._slot_prefill(st, torch.from_numpy(prompt), 8,
                                      sampling=samp)
    p = torch.softmax(pgen._filter_logits(logits[None], T, k, None)[0] / T,
                      dim=-1).numpy()
    freq = np.bincount(first.numpy(), minlength=V) / R
    se = np.sqrt(p * (1 - p) / R) + 1e-12
    assert np.all(np.abs(freq - p) <= 5 * se + 1e-9)
    assert np.count_nonzero(freq) <= k
