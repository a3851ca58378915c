"""The port's decode stack (torchmpi_tpu_torch/models/generate.py and the
decode path of models/transformer.py) against the JAX package on the CPU.

One flax parameter tree (seeded init) is loaded into the port's model with
``weights.from_flax_params``; the same seeded numpy prompts go through
both.  Fixture sizes are JAX's own: tests/test_generate.py (vocab 37,
embed 32, depth 2, 4 heads of 8, learned positions, max_len 32) and
tests/test_serving.py (vocab 41, RoPE, max_len 64), plus GQA and a
sliding window.

Tolerances: logits and caches within 1e-5 (float32); greedy tokens, beam
tokens and eos padding identical; beam scores within 1e-5; the sampling
filters' masks bitwise on JAX's edge cases.  Sampled decode cannot
match JAX's PRNG (ROADMAP queue C note 2): it is held to the filtered
softmax by a frequency test, and to itself.  The slot primitives and the
clamp are held to JAX in tests/test_torch_serving.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmpi_tpu as jmpi
from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.models import beam_search as jax_beam
from torchmpi_tpu.models import generate as jax_generate
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import TransformerLM

# The modules (the packages export functions of the same name).
jgen = importlib.import_module("torchmpi_tpu.models.generate")
pgen = importlib.import_module("torchmpi_tpu_torch.models.generate")

torch.set_num_threads(2)

LEARNED = dict(vocab=37, embed=32, depth=2, num_heads=4, head_dim=8,
               max_len=32)
ROPE_GQA = dict(vocab=41, embed=32, depth=2, num_heads=4, head_dim=8,
                max_len=64, pos_emb="rope", num_kv_heads=2, window=6)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
    jmpi.stop()
    tmpi.stop()


_MODELS = {}


def _pair(cfg_name, seed=1, **over):
    """(jax model, params, port model) for a named config, built once."""
    key = (cfg_name, seed, tuple(sorted(over.items())))
    if key not in _MODELS:
        cfg = dict({"learned": LEARNED, "rope": ROPE_GQA}[cfg_name], **over)
        jm = JaxLM(**cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 4), jnp.int32))["params"]
        params = jax.tree.map(np.asarray, params)
        pm = TransformerLM(**cfg, device="cpu")
        pm.load_state_dict(tweights.from_flax_params(params, pm))
        _MODELS[key] = (jm, params, pm)
    return _MODELS[key]


def _prompts(vocab, B, T, seed):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(B, T)).astype(np.int32)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The decode forward: prefill + steps, logits and caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_name", ["learned", "rope"])
def test_decode_forward_logits_and_cache(cfg_name):
    jm, params, pm = _pair(cfg_name)
    V = jm.vocab
    prompt = _prompts(V, 2, 5, 3)
    jd = jm.clone(decode=True)
    logits, upd = jax.jit(lambda p, t: jd.apply(
        {"params": p}, t, pos_offset=0, mutable=["cache"]))(
        params, prompt)
    cache = pm.init_cache(2)
    got = pm(torch.from_numpy(prompt).long(), 0, cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(logits), **TOL)
    jcache = upd["cache"]
    step = jax.jit(lambda p, c, t, i: jd.apply(
        {"params": p, "cache": c}, t, pos_offset=i, mutable=["cache"]))
    tok = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
    for i in range(5, 12):
        jl, jupd = step(params, jcache, tok[:, None], i)
        jcache = jupd["cache"]
        pl = pm(torch.from_numpy(tok[:, None]).long(), i, cache=cache)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    back = tweights.to_flax_cache(cache)
    for blk, layer in jcache.items():
        for name in ("k", "v"):
            np.testing.assert_allclose(back[blk]["SPAttention_0"][name],
                                       np.asarray(layer["SPAttention_0"]
                                                  [name]), **TOL)
        assert int(back[blk]["SPAttention_0"]["idx"]) == int(
            layer["SPAttention_0"]["idx"]) == 12


def test_cache_converter_round_trip():
    jm, params, pm = _pair("rope")
    rng = np.random.RandomState(0)
    tree = {f"Block_{i}": {"SPAttention_0": {
        "k": rng.randn(3, 64, 2, 8).astype(np.float32),
        "v": rng.randn(3, 64, 2, 8).astype(np.float32),
        "idx": np.asarray(7, np.int32)}} for i in range(2)}
    cache = tweights.from_flax_cache({"cache": tree}, "cpu")
    assert (cache.rows, cache.max_len, cache.idx) == (3, 64, 7)
    back = tweights.to_flax_cache(cache)
    for blk in tree:
        for name in ("k", "v", "idx"):
            np.testing.assert_array_equal(back[blk]["SPAttention_0"][name],
                                          tree[blk]["SPAttention_0"][name])
    tree["Block_1"]["SPAttention_0"]["idx"] = np.asarray(8, np.int32)
    with pytest.raises(ValueError, match="idx"):
        tweights.from_flax_cache(tree, "cpu")


# ---------------------------------------------------------------------------
# generate: greedy token for token, eos, edges, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_name,over", [
    ("learned", {}), ("rope", {}), ("learned", {"attn_impl": "flash"}),
], ids=["learned", "rope-gqa-window", "flash-alias"])
def test_generate_greedy_matches_jax(cfg_name, over):
    jm, params, pm = _pair(cfg_name, **over)
    prompt = _prompts(jm.vocab, 3, 5, 0)
    want = np.asarray(jax_generate(jm, params, prompt, steps=12))
    got = _np(pgen.generate(pm, prompt, 12))
    np.testing.assert_array_equal(got, want)


def test_generate_eos_and_step_edges():
    jm, params, pm = _pair("learned")
    prompt = _prompts(jm.vocab, 4, 5, 20)
    free = _np(pgen.generate(pm, prompt, 10))
    eos = int(free[0, 5 + 3])
    want = np.asarray(jax_generate(jm, params, prompt, steps=10,
                                   eos_id=eos))
    np.testing.assert_array_equal(_np(pgen.generate(pm, prompt, 10,
                                                    eos_id=eos)), want)
    np.testing.assert_array_equal(_np(pgen.generate(pm, prompt, 0)), prompt)
    one = _np(pgen.generate(pm, prompt, 1))
    assert one.shape == (4, 6)
    np.testing.assert_array_equal(one, free[:, :6])


def test_generate_refusals():
    jm, params, pm = _pair("learned")
    with pytest.raises(ValueError, match="max_len"):
        pgen.generate(pm, np.zeros((1, 30), np.int32), 10)
    for kw, match in ((dict(top_k=0), "top_k"), (dict(top_p=0.0), "top_p"),
                      (dict(top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=match):
            pgen.generate(pm, np.zeros((1, 4), np.int32), 2, **kw)
    ring = TransformerLM(vocab=8, embed=16, depth=1, num_heads=2,
                         head_dim=8, max_len=16, attn_impl="ring",
                         seq_axis="ici", device="cpu")
    with pytest.raises(ValueError, match="local"):
        pgen.generate(ring, np.zeros((1, 2), np.int32), 2)
    uly = TransformerLM(vocab=8, embed=16, depth=1, num_heads=2,
                        head_dim=8, max_len=16, attn_impl="ulysses",
                        seq_axis="ici", device="cpu")
    with pytest.raises(ValueError, match="generate_parallel"):
        pgen.generate(uly, np.zeros((1, 2), np.int32), 2)
    with pytest.raises(ValueError, match="init_cache"):
        TransformerLM(**LEARNED, decode=True, device="cpu")(
            torch.zeros(1, 2, dtype=torch.long))


def test_sampled_generate_reproducible_and_filters_collapse():
    """top_k=1 and a tiny nucleus collapse sampling to greedy (JAX's
    test_top_k_and_top_p_sampling); a seed replays its stream; row b of
    an int seed s samples as seed s + b alone."""
    jm, params, pm = _pair("learned")
    prompt = _prompts(jm.vocab, 2, 5, 8)
    greedy = _np(pgen.generate(pm, prompt, 8))
    np.testing.assert_array_equal(_np(pgen.generate(
        pm, prompt, 8, temperature=5.0, top_k=1, seed=4)), greedy)
    np.testing.assert_array_equal(_np(pgen.generate(
        pm, prompt, 8, temperature=0.05, top_p=1e-6, seed=5)), greedy)
    a = _np(pgen.generate(pm, prompt, 8, temperature=1.0, top_k=8,
                          top_p=0.9, seed=7))
    b = _np(pgen.generate(pm, prompt, 8, temperature=1.0, top_k=8,
                          top_p=0.9, seed=[7, 8]))
    np.testing.assert_array_equal(a, b)
    row1 = _np(pgen.generate(pm, prompt[1:], 8, temperature=1.0, top_k=8,
                             top_p=0.9, seed=8))
    np.testing.assert_array_equal(row1[0], a[1])
    assert (a[:, 5:] != greedy[:, 5:]).any()
    assert a.min() >= 0 and a.max() < jm.vocab


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(beams=3), dict(beams=1), dict(beams=4, eos_id=3),
    dict(beams=4, eos_id=3, length_penalty=1.5),
], ids=["beams3", "beams1", "eos", "length-penalty"])
def test_beam_search_matches_jax(kw):
    jm, params, pm = _pair("learned")
    prompt = _prompts(jm.vocab, 3, 5, 10)
    want = np.asarray(jax_beam(jm, params, prompt, steps=6, **kw))
    got = _np(pgen.beam_search(pm, prompt, 6, **kw))
    np.testing.assert_array_equal(got, want)


def test_beam_expand_scores_and_ties():
    """One expansion from the same log-probs: scores within 1e-5, the
    same parents and tokens, ties (equal totals) to the lower index as
    ``lax.top_k``."""
    rng = np.random.RandomState(2)
    B, K, V = 2, 3, 7
    lp = rng.randn(B, K).astype(np.float32)
    step = np.log(rng.dirichlet(np.ones(V), size=(B, K))).astype(
        np.float32)
    step[0, 1] = step[0, 0]
    lp[0, 1] = lp[0, 0]  # beams 0 and 1 of row 0 tie everywhere
    fin = np.array([[False, True, False], [False, False, False]])
    ln = np.array([[2, 1, 2], [2, 2, 2]], np.int32)
    want = jgen._beam_expand(jnp.asarray(lp), jnp.asarray(fin),
                             jnp.asarray(ln), jnp.asarray(step), 3,
                             jnp.int32)
    got = pgen._beam_expand(torch.from_numpy(lp), torch.from_numpy(fin),
                            torch.from_numpy(ln).long(),
                            torch.from_numpy(step), 3)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ---------------------------------------------------------------------------
# Sampling filters (JAX's edge cases, bitwise) and the sampler
# ---------------------------------------------------------------------------


def test_filter_logits_edge_cases_bitwise():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 23).astype(np.float32)
    row = np.zeros((1, 10), np.float32)
    row[0, 0], row[0, 1] = 2.0, 1.9
    cases = [(logits, 1.0, 1, None), (logits, 1.0, None, 1.0),
             (logits, 0.7, 5, 0.9), (logits, 1.0, 23, None),
             (row, 1.0, 2, 0.5), (logits, 0.05, None, 1e-6)]
    for x, t, k, p in cases:
        want = np.asarray(jgen._filter_logits(jnp.asarray(x), t, k, p))
        got = _np(pgen._filter_logits(torch.from_numpy(x), t, k, p))
        np.testing.assert_array_equal(got, want)
    f = _np(pgen._filter_logits(torch.from_numpy(row), 1.0, 2, 0.5))
    assert np.isfinite(f[0, 0]) and not np.isfinite(f[0, 1:]).any()
    toks = _np(pgen._sample(torch.from_numpy(logits), torch.zeros(5).long(),
                            0.0, 5, 0.9))
    np.testing.assert_array_equal(toks, logits.argmax(-1))


def test_filter_logits_rows_matches_jax_and_sentinels():
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 19).astype(np.float32)
    temps = np.array([0.8, 0.5, 1.3, 0.8], np.float32)
    ks = np.array([3, 0, 19, 7], np.int32)
    ps = np.array([0.7, 0.9, 2.0, 1.0], np.float32)
    want = np.asarray(jgen._filter_logits_rows(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(ks),
        jnp.asarray(ps)))
    got = _np(pgen._filter_logits_rows(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(ks).long(), torch.from_numpy(ps)))
    np.testing.assert_array_equal(got, want)
    uniform = _np(pgen._filter_logits_rows(
        torch.from_numpy(logits), torch.full((4,), 0.8),
        torch.full((4,), 3).long(), torch.full((4,), 0.7)))
    np.testing.assert_array_equal(uniform, _np(pgen._filter_logits(
        torch.from_numpy(logits), 0.8, 3, 0.7)))
    noop = _np(pgen._filter_logits_rows(
        torch.from_numpy(logits), torch.zeros(4), torch.zeros(4).long(),
        torch.full((4,), 2.0)))
    np.testing.assert_array_equal(noop, logits)


def test_sampler_frequencies_match_filtered_softmax():
    """N = 40,000 draws of token index i = 0..N-1 from one seed at V 6,
    temperature 0.7, top_k 4, top_p 0.95: each token's frequency within
    5 standard errors (sqrt(p (1 - p) / N) <= 0.0025) of the filtered
    softmax, and filtered tokens never drawn."""
    N, V = 40_000, 6
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, 1.4]])
    t, k, p = 0.7, 4, 0.95
    filt = pgen._filter_logits(logits, t, k, p)
    probs = torch.softmax(filt / t, dim=-1)[0].numpy()
    rows = logits.expand(N, V)
    toks = pgen._sample_rows(
        rows, torch.full((N,), 12345).long(), torch.arange(N),
        torch.full((N,), t), torch.full((N,), k).long(),
        torch.full((N,), p)).numpy()
    freq = np.bincount(toks, minlength=V) / N
    se = np.sqrt(probs * (1 - probs) / N)
    assert (np.abs(freq - probs) <= 5 * se + 1e-12).all(), (freq, probs)
    assert (freq[probs == 0] == 0).all() and (probs == 0).sum() >= 1


def test_sampler_keys_ignore_the_row():
    """A row's draw depends on (seed, idx) only: the same rows in another
    order and batch size draw the same tokens."""
    rng = np.random.RandomState(9)
    logits = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    seeds, idxs = torch.arange(100, 106), torch.arange(6) * 3
    temps, ks, ps = (torch.full((6,), 0.9), torch.full((6,), 10).long(),
                     torch.full((6,), 0.9))
    full = pgen._sample_rows(logits, seeds, idxs, temps, ks, ps)
    perm = torch.tensor([4, 1, 5])
    part = pgen._sample_rows(logits[perm], seeds[perm], idxs[perm],
                             temps[perm], ks[perm], ps[perm])
    np.testing.assert_array_equal(_np(part), _np(full[perm]))
