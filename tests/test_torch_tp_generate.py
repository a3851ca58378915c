"""The port's tensor-parallel decoders and their dense oracle
(torchmpi_tpu_torch/models/tp_generate.py, models/oracle.py) against the
JAX package on the CPU.

JAX's tree (``init_tp_lm``, vocab 64, embed 32, depth 2, 8 heads: JAX's
``oracle.setup``) is carried across with ``weights.from_numpy_tree``; the
same seeded numpy prompts go through JAX's ``tp_generate`` /
``tp_beam_search`` / slot primitives under ``shard_map`` on the 8-device
CPU mesh (the model axis ("dcn", "ici") on 1 x 8, or "ici" on 2 x 4) and
through the port's rank-major forms on 8 ranks of one process (a pushed
communicator {"model": 8}, or {"dcn": 2, "ici": 4} with the axis "ici").

Tolerances: greedy and beam tokens, eos padding and the slot primitives'
tokens identical; logits and the oracle's log-probabilities within 1e-5
of JAX's (float32); the head-local caches within 1e-5.  The process-world
forms are held to the rank-major ones in
tests/test_torch_parallel_decode_world.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import weights as tweights

from _torch_world import module_group

jtpg = importlib.import_module("torchmpi_tpu.models.tp_generate")
jor = importlib.import_module("torchmpi_tpu.models.oracle")
ptpg = importlib.import_module("torchmpi_tpu_torch.models.tp_generate")
pgen = importlib.import_module("torchmpi_tpu_torch.models.generate")
por = importlib.import_module("torchmpi_tpu_torch.models.oracle")

torch.set_num_threads(2)

N = 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with module_group():
        jmpi.init(jmpi.Config(dcn_size=1))
        tmpi.init(device="cpu")
        yield


def _mesh(shape):
    return Mesh(np.array(jax.devices()[:N]).reshape(shape), ("dcn", "ici"))


FLAT = dict(mesh_shape=(1, N), jax_axis=("dcn", "ici"), key="flat",
            comm={"model": N}, axis="model")
HIER = dict(mesh_shape=(2, 4), jax_axis="ici", key="hier",
            comm={"dcn": 2, "ici": 4}, axis="ici")

_TREES = {}


def _tree(seed=0, **kw):
    """JAX's setup tree and prompt, and the tree carried to torch."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _TREES:
        params, prompt = jor.setup(seed=seed, **kw)
        params = jax.tree.map(np.asarray, params)
        _TREES[key] = (params, prompt,
                       tweights.from_numpy_tree(params, "cpu"))
    return _TREES[key]


def _port(fn, lay, *args, **kw):
    with tmpi.communicator(lay["key"], shape=lay["comm"]):
        return fn(*args, axis=lay["axis"], n=N, **kw).numpy()


def _jax(fn, lay, *args, **kw):
    return np.asarray(fn(*args, mesh=_mesh(lay["mesh_shape"]),
                         axis=lay["jax_axis"], **kw))


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------


def test_oracle_matches_jax_oracle():
    params, prompt, tparams = _tree()
    np.testing.assert_allclose(
        por.dense_forward(tparams, prompt, 8).numpy(),
        np.asarray(jor.dense_forward(params, jnp.asarray(prompt), 8)), **TOL)
    toks = jor.dense_greedy(params, prompt, 6, num_heads=8)
    np.testing.assert_array_equal(
        por.dense_greedy(tparams, prompt, 6, num_heads=8), toks)
    np.testing.assert_allclose(
        por.seq_logprob(tparams, toks, 8, prompt.shape[1]),
        jor.seq_logprob(params, toks, 8, prompt.shape[1]), **TOL)
    # The port's own seeded setup: a tree of JAX's layout and scales.
    mine, p2 = por.setup(seed=3, device="cpu")
    assert mine["embed"].shape == (64, 32) and p2.shape == (2, 4)
    assert mine["blocks"][0]["w1"].shape == (32, 128)
    assert abs(float(mine["embed"].std()) - 64 ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# tp_generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lay", [FLAT, HIER], ids=["flat", "hier"])
def test_tp_generate_matches_jax_and_oracle(lay):
    params, prompt, tparams = _tree(seed=3 if lay is HIER else 0)
    steps = 6
    want = _jax(jtpg.tp_generate, lay, params, prompt, steps, num_heads=8)
    np.testing.assert_array_equal(
        want, jor.dense_greedy(params, prompt, steps, num_heads=8))
    got = _port(ptpg.tp_generate_rank_major, lay, tparams, prompt, steps,
                num_heads=8)
    np.testing.assert_array_equal(got, want)


def test_tp_logits_match_the_jax_oracle():
    """The TP prefill's and steps' logits against JAX's dense oracle on
    the same tokens."""
    params, prompt, tparams = _tree(seed=1)
    with tmpi.communicator("flat", shape={"model": N}):
        st = ptpg._Stack(ptpg.shard_tp_lm_rank_major(tparams, N, "model")[0],
                         ptpg._Form("model", N, None), 8)
        p = torch.from_numpy(prompt)
        x, cache = st.prefill(p, prompt.shape[1] + 4)
        logits = [st.logits(x[:, :, -1])]
        toks = [logits[-1].argmax(-1)]
        pos = torch.full((prompt.shape[0],), prompt.shape[1])
        for i in range(3):
            x = st.decode(cache, toks[-1][:, None], pos + i)
            logits.append(st.logits(x[:, :, 0]))
            toks.append(logits[-1].argmax(-1))
    seq = prompt
    for lg, tok in zip(logits, toks):
        want = np.asarray(jor.dense_forward(params, jnp.asarray(seq), 8))
        np.testing.assert_allclose(lg.numpy(), want, **TOL)
        seq = np.concatenate([seq, tok.numpy()[:, None].astype(np.int32)], 1)


def test_tp_generate_eos_freeze():
    params, prompt, tparams = _tree(seed=5)
    free = jor.dense_greedy(params, prompt, 6, num_heads=8)
    eos = int(free[0, prompt.shape[1] + 1])
    want = _jax(jtpg.tp_generate, FLAT, params, prompt, 6, num_heads=8,
                eos_id=eos)
    got = _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 6,
                num_heads=8, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    tail = got[0, prompt.shape[1] + 2:]
    np.testing.assert_array_equal(tail, np.full_like(tail, eos))


def test_tp_generate_sampling_valid_and_reproducible():
    """JAX's sampling smoke on the port: in-vocab, prompt kept, a seed
    replays its stream; top_k=1 is greedy; row b of seed s samples as the
    single-device ``generate`` keys it, (s + b, i)."""
    params, prompt, tparams = _tree(seed=7)
    kw = dict(num_heads=8, temperature=1.0, top_k=5, seed=9)
    a = _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 6, **kw)
    b = _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 6, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :prompt.shape[1]], prompt)
    assert a.min() >= 0 and a.max() < 64
    greedy = jor.dense_greedy(params, prompt, 6, num_heads=8)
    k1 = _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 6,
               num_heads=8, temperature=5.0, top_k=1, seed=3)
    np.testing.assert_array_equal(k1, greedy)
    row1 = _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt[1:], 6,
                 num_heads=8, temperature=1.0, top_k=5, seed=10)
    np.testing.assert_array_equal(row1[0], a[1])


# ---------------------------------------------------------------------------
# tp_beam_search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beams,eos,penalty", [(1, None, 0.0),
                                               (3, None, 0.6),
                                               (4, "mid", 1.0)])
def test_tp_beam_matches_jax(beams, eos, penalty):
    params, prompt, tparams = _tree(seed=4)
    greedy = jor.dense_greedy(params, prompt, 6, num_heads=8)
    eos_id = int(greedy[0, prompt.shape[1] + 1]) if eos else None
    kw = dict(num_heads=8, beams=beams, eos_id=eos_id,
              length_penalty=penalty)
    want = _jax(jtpg.tp_beam_search, FLAT, params, prompt, 6, **kw)
    got = _port(ptpg.tp_beam_search_rank_major, FLAT, tparams, prompt, 6,
                **kw)
    np.testing.assert_array_equal(got, want)
    if beams == 1:
        np.testing.assert_array_equal(got, greedy)
    if eos_id is not None:
        for row in got:
            hit = np.nonzero(row[prompt.shape[1]:] == eos_id)[0]
            if hit.size:
                tail = row[prompt.shape[1] + hit[0]:]
                np.testing.assert_array_equal(tail, np.full_like(tail,
                                                                 eos_id))


def test_tp_beam_exhaustive_at_steps2():
    """beams = vocab at steps 2 is exhaustive: the best score over all
    V^2 continuations (the port's oracle), within 1e-5."""
    params, prompt, tparams = _tree(seed=6, vocab=16, B=2)
    V = 16
    got = _port(ptpg.tp_beam_search_rank_major, FLAT, tparams, prompt, 2,
                num_heads=8, beams=V)
    Tp = prompt.shape[1]
    cands = np.array([[a, b] for a in range(V) for b in range(V)],
                     np.int32)
    best = np.full(prompt.shape[0], -np.inf)
    for b in range(prompt.shape[0]):
        seqs = np.concatenate([np.repeat(prompt[b:b + 1], len(cands), 0),
                               cands], 1)
        best[b] = por.seq_logprob(tparams, seqs, 8, Tp).max()
    np.testing.assert_allclose(por.seq_logprob(tparams, got, 8, Tp), best,
                               **TOL)


# ---------------------------------------------------------------------------
# The slot primitives
# ---------------------------------------------------------------------------


def _full_cache_jax(jc, n):
    """JAX's pool cache (per layer (k, v) [S, t_max, H, dh]) as the port's
    rank-major [n, S, t_max, H / n, dh]."""
    out = []
    for k, v in jc:
        k, v = np.asarray(k), np.asarray(v)
        S, L, H, dh = k.shape
        out.append(tuple(a.reshape(S, L, n, H // n, dh).transpose(2, 0, 1, 3,
                                                                  4)
                         for a in (k, v)))
    return out


def test_tp_slot_prefill_and_decode_match_jax():
    params, prompt, tparams = _tree(seed=8)
    mesh = _mesh((1, N))
    axis = ("dcn", "ici")
    jplaced, _ = jtpg.shard_tp_lm(params, mesh, axis)
    t_max = 16
    # Prefill row 0 (padded to 6, true length 4), the port's likewise.
    padded = np.zeros((1, 6), np.int32)
    padded[0, :4] = prompt[0]
    jc, jfirst = jtpg.tp_slot_prefill(jplaced, padded, mesh=mesh, axis=axis,
                                      num_heads=8, t_max=t_max, true_len=4)
    with tmpi.communicator("flat", shape={"model": N}):
        stacks = ptpg.shard_tp_lm_rank_major(tparams, N, "model")[0]
        pc, pfirst = ptpg.tp_slot_prefill_rank_major(
            stacks, padded, axis="model", num_heads=8, t_max=t_max,
            true_len=4)
        assert int(pfirst[0]) == int(np.asarray(jfirst)[0])
        for (jk, jv), k, v in zip(_full_cache_jax(jc, N), pc.k, pc.v):
            np.testing.assert_allclose(k.numpy()[:, :, :4], jk[:, :, :4],
                                       **TOL)
            np.testing.assert_allclose(v.numpy()[:, :, :4], jv[:, :, :4],
                                       **TOL)
        # A pool of 2 slots: row 0 the prefilled request, row 1 idle; one
        # [S, 1] step, then a [S, 3] verify step.
        jpool = [(jnp.concatenate([k, jnp.zeros_like(k)]),
                  jnp.concatenate([v, jnp.zeros_like(v)])) for k, v in jc]
        ppool = ptpg._Stack(stacks, ptpg._Form("model", N, None),
                            8).zero_cache(2, t_max)
        pgen.slot_write(ppool, pc, 0)
        toks = np.array([[int(pfirst[0])], [0]], np.int32)
        pos = np.array([4, 0], np.int32)
        jpool, jout = jtpg.tp_slot_decode(jplaced, jpool, toks, pos,
                                          mesh=mesh, axis=axis, num_heads=8)
        ppool, pout = ptpg.tp_slot_decode_rank_major(
            stacks, ppool, toks, torch.from_numpy(pos).long(), axis="model",
            num_heads=8)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        ver = np.array([[int(np.asarray(jout)[0, 0]), 3, 5], [1, 2, 3]],
                       np.int32)
        pos = np.array([5, 1], np.int32)
        jpool, jout = jtpg.tp_slot_decode(jplaced, jpool, ver, pos,
                                          mesh=mesh, axis=axis, num_heads=8)
        ppool, pout = ptpg.tp_slot_decode_rank_major(
            stacks, ppool, ver, torch.from_numpy(pos).long(), axis="model",
            num_heads=8)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        for (jk, jv), k, v in zip(_full_cache_jax(jpool, N), ppool.k,
                                  ppool.v):
            np.testing.assert_allclose(k.numpy()[:, 0, :8], jk[:, 0, :8],
                                       **TOL)
            np.testing.assert_allclose(v.numpy()[:, 1, :4], jv[:, 1, :4],
                                       **TOL)


# ---------------------------------------------------------------------------
# Refusals (JAX's) and the rest of the surface
# ---------------------------------------------------------------------------


def test_tp_refusals_match_jax():
    params, prompt, tparams = _tree()
    with pytest.raises(ValueError, match="batch, time"):
        _jax(jtpg.tp_generate, FLAT, params, prompt[0], 2, num_heads=8)
    with pytest.raises(ValueError, match="batch, time"):
        _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt[0], 2,
              num_heads=8)
    # Heads that do not split over the axis.
    with pytest.raises(ValueError, match="must divide by the model-axis"):
        _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 2,
              num_heads=12)
    for beams, match in ((0, "beams must be >= 1"), (65, "exceeds vocab")):
        with pytest.raises(ValueError, match=match):
            _jax(jtpg.tp_beam_search, FLAT, params, prompt, 2, num_heads=8,
                 beams=beams)
        with pytest.raises(ValueError, match=match):
            _port(ptpg.tp_beam_search_rank_major, FLAT, tparams, prompt, 2,
                  num_heads=8, beams=beams)
    with pytest.raises(ValueError, match="top_k"):
        _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 2,
              num_heads=8, top_k=0, temperature=1.0)
    # steps <= 0 returns the prompt.
    np.testing.assert_array_equal(
        _port(ptpg.tp_generate_rank_major, FLAT, tparams, prompt, 0,
              num_heads=8), prompt)
    # The port compiles nothing to drop.
    assert ptpg.clear_serving_caches() is None


def test_tp_process_world_of_one_is_rank_major_at_one():
    """The process-world form in a world of one process: its one rank
    holds the whole tree, and decodes as the rank-major form at n = 1."""
    params, prompt, tparams = _tree(seed=2)
    got = ptpg.tp_generate(tparams, prompt, 5, axis=None, num_heads=8)
    with tmpi.communicator("one", shape={"model": 1}):
        one = ptpg.tp_generate_rank_major(tparams, prompt, 5, axis="model",
                                          num_heads=8, n=1)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    np.testing.assert_array_equal(
        got.numpy(), jor.dense_greedy(params, prompt, 5, num_heads=8))
