"""The port's pipeline-parallel decoder (torchmpi_tpu_torch/models/
pp_generate.py) against the JAX package's ``pp_generate`` on the CPU.

Every case of tests/test_pp_generate.py on JAX's seeded ``init_tp_lm``
trees (vocab 64, embed 32, depth 8, 8 heads) carried across with
``weights.from_numpy_tree``: JAX under ``shard_map`` on the 8-device CPU
mesh (8 stages over ("dcn", "ici") on 1 x 8, or 4 over "ici" on 2 x 4),
the port rank-major on 8 ranks of one process (a pushed communicator
{"pp": 8}, or {"dcn": 2, "ici": 4} with the stage axis "ici").  Greedy
tokens and eos padding identical, to JAX and to the dense oracle: micro
groups of one and of two rows, EOS after prefill and a token predicted
during the teacher-forced prefill (which must not freeze its row).  The
bf16 trees are held, as JAX holds them, against the dense oracle on the
same tree.  The schedule's sampling key (row b's token i from (seed + b,
i)) makes its sampled streams ``generate``'s: checked against the
tensor-parallel decoder, which keys them alike.  The process-world form
is held to this one in tests/test_torch_parallel_decode_world.py.
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

jppg = importlib.import_module("torchmpi_tpu.models.pp_generate")
jor = importlib.import_module("torchmpi_tpu.models.oracle")
pppg = importlib.import_module("torchmpi_tpu_torch.models.pp_generate")
ptpg = importlib.import_module("torchmpi_tpu_torch.models.tp_generate")
por = importlib.import_module("torchmpi_tpu_torch.models.oracle")

torch.set_num_threads(2)

N = 8
FLAT = dict(mesh_shape=(1, N), jax_axis=("dcn", "ici"), key="pp8",
            comm={"pp": N}, axis="pp")
HIER = dict(mesh_shape=(2, 4), jax_axis="ici", key="pp_hier",
            comm={"dcn": 2, "ici": 4}, axis="ici")


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with module_group():
        jmpi.init(jmpi.Config(dcn_size=1))
        tmpi.init(device="cpu")
        yield


def _tree(**kw):
    params, prompt = jor.setup(**kw)
    params = jax.tree.map(np.asarray, params)
    return params, prompt, tweights.from_numpy_tree(params, "cpu")


def _jax(lay, *args, **kw):
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(lay["mesh_shape"]),
                ("dcn", "ici"))
    return np.asarray(jppg.pp_generate(*args, mesh=mesh,
                                       axis=lay["jax_axis"], num_heads=8,
                                       **kw))


def _port(lay, *args, **kw):
    with tmpi.communicator(lay["key"], shape=lay["comm"]):
        return pppg.pp_generate_rank_major(*args, axis=lay["axis"], n=N,
                                           num_heads=8, **kw).numpy()


@pytest.mark.parametrize("lay,seed,B,steps", [
    (FLAT, 0, 8, 5),   # 8 micro-groups of 1 row
    (FLAT, 2, 16, 3),  # micro-groups of 2 rows
    (HIER, 3, 4, 4),   # 4 stages over ici, 2 layers a stage
], ids=["groups-of-1", "groups-of-2", "ici-with-dcn"])
def test_pp_generate_matches_jax(lay, seed, B, steps):
    params, prompt, tparams = _tree(seed=seed, depth=8, B=B)
    want = _jax(lay, params, prompt, steps)
    np.testing.assert_array_equal(
        want, jor.dense_greedy(params, prompt, steps, num_heads=8))
    np.testing.assert_array_equal(_port(lay, tparams, prompt, steps), want)


def test_pp_generate_eos_freeze():
    params, prompt, tparams = _tree(seed=5, depth=8, B=8)
    free = jor.dense_greedy(params, prompt, 6, num_heads=8)
    eos = int(free[0, prompt.shape[1] + 1])
    want = _jax(FLAT, params, prompt, 6, eos_id=eos)
    got = _port(FLAT, tparams, prompt, 6, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    tail = got[0, prompt.shape[1] + 2:]
    np.testing.assert_array_equal(tail, np.full_like(tail, eos))


def test_pp_generate_eos_predicted_during_prefill():
    """A token predicted at a teacher-forced position must not freeze the
    row (JAX's case): only generated tokens trip EOS."""
    params, prompt, tparams = _tree(seed=11, depth=8, B=8)
    pred = int(np.asarray(jnp.argmax(jor.dense_forward(
        params, jnp.asarray(prompt[:, :2]), 8), axis=-1))[0])
    want = _jax(FLAT, params, prompt, 4, eos_id=pred)
    np.testing.assert_array_equal(
        want, jor.dense_greedy(params, prompt, 4, num_heads=8, eos_id=pred))
    np.testing.assert_array_equal(_port(FLAT, tparams, prompt, 4,
                                        eos_id=pred), want)


@pytest.mark.parametrize("which", ["bf16", "mixed"])
def test_pp_generate_bf16_trees_match_the_oracle(which):
    """A bf16 tree runs bf16 (caches in the promoted compute dtype), and a
    tree of bf16 embeddings and float32 blocks runs too, each equal to
    the dense oracle on the same tree (JAX's two cases)."""
    _, prompt, tparams = _tree(seed=13 if which == "bf16" else 17, depth=8,
                               B=8)
    if which == "bf16":
        tree = tmpi._tree.map(lambda a: a.to(torch.bfloat16), tparams)
    else:
        tree = dict(tparams, embed=tparams["embed"].to(torch.bfloat16))
    want = por.dense_greedy(tree, prompt, 3, num_heads=8)
    np.testing.assert_array_equal(_port(FLAT, tree, prompt, 3), want)


def test_pp_sampling_is_generates_stream():
    """Sampled: in-vocab, the prompt kept, a seed replays its stream, and
    the stream is the one the tensor-parallel decoder draws with the same
    seed (both key row b's token i on (seed + b, i))."""
    _, prompt, tparams = _tree(seed=7, depth=8, B=8)
    kw = dict(temperature=1.0, top_k=5, seed=9)
    a = _port(FLAT, tparams, prompt, 4, **kw)
    b = _port(FLAT, tparams, prompt, 4, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :prompt.shape[1]], prompt)
    assert a.min() >= 0 and a.max() < 64
    with tmpi.communicator("tp8", shape={"model": N}):
        tp = ptpg.tp_generate_rank_major(tparams, prompt, 4, axis="model",
                                         n=N, num_heads=8, **kw).numpy()
    np.testing.assert_array_equal(a, tp)


def test_pp_generate_shape_errors_match_jax():
    params, prompt, tparams = _tree(depth=8, B=8)
    for fn, tree in ((_jax, params), (_port, tparams)):
        with pytest.raises(ValueError, match="micro-groups"):
            fn(FLAT, tree, prompt[:6], 2)
    bad, _, tbad = _tree(depth=6, B=8)
    with pytest.raises(ValueError, match="depth 6 must divide"):
        _jax(FLAT, bad, prompt, 2)
    with pytest.raises(ValueError, match="depth 6 must divide"):
        _port(FLAT, tbad, prompt, 2)
    with pytest.raises(ValueError, match="batch, time"):
        _port(FLAT, tparams, prompt[0], 2)
    np.testing.assert_array_equal(_port(FLAT, tparams, prompt, 0), prompt)
    # No beam search on PP (JAX offers none either): the module has none.
    assert not hasattr(pppg, "pp_beam_search")
