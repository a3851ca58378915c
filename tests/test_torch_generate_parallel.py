"""The port's mesh-parallel decoders (``generate_parallel``,
``beam_search_parallel`` and their rank-major forms; the model's MoE and
Ulysses decode) against the JAX package on the CPU.

JAX's cases of tests/test_generate.py:98-258 and :507-600 on their own
models (vocab 29 / 41 / 23, embed 32, depth 2, 4 or 8 heads of 8, max_len
24), the flax parameters carried across with ``weights.from_flax_params``:
JAX under ``shard_map`` on the 2 x 4 CPU mesh, the port rank-major on the
8 ranks of a dcn 2 x ici 4 world of one process (the batch over dcn; the
experts, or the Ulysses heads, over ici).  Greedy and beam tokens
identical: expert-parallel decode (capacity factor 8, top-2) against JAX's
and against the full-forward greedy loop on the same grid, Ulysses decode
from the head-sharded cache against JAX's and against the single-device
decode, beams=1 equal to greedy, the Ulysses beam search against JAX's.
Sampling: each batch shard folds its index into its rows' seeds, so
identical rows on two shards differ, and top_k=1 sampling is greedy.  The
single-device decoders keep JAX's refusals, pointing at these.  The
process-world forms are held to these in
tests/test_torch_parallel_decode_world.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.models import beam_search_parallel as jax_beam_parallel
from torchmpi_tpu.models import generate as jax_generate
from torchmpi_tpu.models import generate_parallel as jax_gen_parallel
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import TransformerLM, beam_search, \
    beam_search_parallel_rank_major, generate, generate_parallel_rank_major

from _torch_world import module_group

torch.set_num_threads(2)

N = 8
MOE = dict(vocab=29, embed=32, depth=2, num_heads=4, head_dim=8, max_len=24,
           moe_axis="ici", moe_experts_per_device=1, moe_k=2,
           moe_capacity_factor=8.0)
ULY = dict(vocab=41, embed=32, depth=2, num_heads=4, head_dim=8, max_len=24)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with module_group():
        jmpi.init(jmpi.Config(dcn_size=2))
        tmpi.init(tmpi.Config(dcn_size=2), device="cpu")
        yield


def _port_model(cfg, params, **over):
    model = TransformerLM(**cfg, **over, device="cpu")
    model.load_state_dict(tweights.from_flax_params(params, model))
    return model


_MOE = {}


def _moe(seed):
    """JAX's MoE model and its params, initialised under ``shard_map`` as
    JAX's test does, and the port's model of them."""
    if seed not in _MOE:
        mesh = jmpi.world_mesh()
        jm = JaxLM(**MOE)
        prompt = np.zeros((4, 5), np.int32)
        params = jax.jit(shard_map(
            lambda tok: jm.init(jax.random.PRNGKey(seed), tok)["params"],
            mesh=mesh, in_specs=P("dcn"), out_specs=P(), check_vma=False))(
            jax.device_put(prompt, NamedSharding(mesh, P("dcn"))))
        params = jax.tree.map(np.asarray, params)
        _MOE[seed] = (jm, params, _port_model(MOE, params, moe_axis_size=4))
    return _MOE[seed]


def test_generate_parallel_ep_matches_jax_and_the_full_forward():
    jm, params, pm = _moe(4)
    prompt = np.random.RandomState(3).randint(0, 29, size=(4, 5)).astype(
        np.int32)
    want = np.asarray(jax_gen_parallel(jm, params, prompt, steps=7,
                                       mesh=jmpi.world_mesh(),
                                       batch_axis="dcn"))
    got = generate_parallel_rank_major(pm, prompt, 7, n=N,
                                       batch_axis="dcn").numpy()
    np.testing.assert_array_equal(got, want)
    # The naive oracle: the full forward's greedy token on the growing
    # prefix, the batch over dcn, replicated over ici, on the same grid.
    toks = torch.from_numpy(prompt).long()
    for _ in range(7):
        st = toks.view(2, 1, 2, -1).expand(2, 4, 2, toks.shape[1])
        with torch.no_grad():
            lg = pm.forward_rank_major(st.contiguous())
        toks = torch.cat([toks, lg[:, 0, :, -1].argmax(-1).reshape(4, 1)], 1)
    np.testing.assert_array_equal(got, toks.numpy())
    # beams=1 is the greedy parallel decode (JAX's EP beam oracle).
    beam1 = beam_search_parallel_rank_major(pm, prompt, 6, n=N, beams=1,
                                            batch_axis="dcn").numpy()
    np.testing.assert_array_equal(beam1, got[:, :11])


def _ulysses(heads, vocab, seed, B, T):
    cfg = dict(ULY, num_heads=heads, vocab=vocab)
    prompt = np.random.RandomState(seed - 1 if heads == 4 else seed).randint(
        0, vocab, size=(B, T)).astype(np.int32)
    params = jax.tree.map(np.asarray, JaxLM(**cfg).init(
        jax.random.PRNGKey(seed), jnp.asarray(prompt))["params"])
    return cfg, params, prompt


def test_generate_parallel_ulysses_matches_jax_and_local():
    cfg, params, prompt = _ulysses(4, 41, 8, 4, 6)
    jul = JaxLM(**cfg, attn_impl="ulysses", seq_axis="ici")
    want = np.asarray(jax_gen_parallel(jul, params, prompt, steps=9,
                                       mesh=jmpi.world_mesh(),
                                       batch_axis="dcn"))
    ul = _port_model(cfg, params, attn_impl="ulysses", seq_axis="ici")
    got = generate_parallel_rank_major(ul, prompt, 9, n=N,
                                       batch_axis="dcn").numpy()
    np.testing.assert_array_equal(got, want)
    dense = _port_model(cfg, params)
    np.testing.assert_array_equal(got, generate(dense, prompt, 9).numpy())
    # Without batch_axis every rank holds every row.
    np.testing.assert_array_equal(
        generate_parallel_rank_major(ul, prompt, 9, n=N).numpy(), want)
    # The head-sharded cache: num_heads / 4 heads a rank.
    from torchmpi_tpu_torch.models.generate import _Decoder

    dec = _Decoder(ul, N * 2, (2, 4))
    assert dec.cache.k[0].shape == (16, 24, 1, 8)
    # The decode's logits against the single-device model's.
    pos0 = torch.from_numpy(prompt).long()
    with torch.no_grad():
        rows = pos0.view(2, 1, 2, 6).expand(2, 4, 2, 6).contiguous()
        lg = ul.decode_rank_major(rows, 0, dec.cache)
        ref = dense(pos0)
    np.testing.assert_allclose(lg[:, 0].reshape(4, 6, -1).numpy(),
                               ref.numpy(), rtol=1e-5, atol=1e-5)


def test_beam_parallel_ulysses_matches_jax_and_dense_beam():
    cfg, params, prompt = _ulysses(8, 23, 24, 2, 4)
    jul = JaxLM(**cfg, attn_impl="ulysses", seq_axis="ici")
    kw = dict(beams=4, eos_id=2, length_penalty=1.0)
    want = np.asarray(jax_beam_parallel(jul, params, prompt, steps=6,
                                        mesh=jmpi.world_mesh(), **kw))
    ul = _port_model(cfg, params, attn_impl="ulysses", seq_axis="ici")
    got = beam_search_parallel_rank_major(ul, prompt, 6, n=N, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    dense = _port_model(cfg, params)
    np.testing.assert_array_equal(
        got, beam_search(dense, prompt, 6, **kw).numpy())


def test_generate_parallel_sampling_shards_differ_and_top_k_1_is_greedy():
    cfg = dict(vocab=31, embed=32, depth=1, num_heads=2, head_dim=8,
               max_len=20)
    model = TransformerLM(**cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    prompt = np.zeros((4, 2), np.int32)  # identical rows on purpose
    out = generate_parallel_rank_major(model, prompt, 10, n=N,
                                       batch_axis="dcn", temperature=1.0,
                                       seed=11).numpy()
    assert out.shape == (4, 12)
    # Rows 0 / 1 on dcn shard 0, rows 2 / 3 on shard 1: the folded seeds
    # decorrelate the shards; within a shard, row b draws from seed s + b.
    assert not np.array_equal(out[0], out[2])
    assert not np.array_equal(out[0], out[1])
    again = generate_parallel_rank_major(model, prompt, 10, n=N,
                                         batch_axis="dcn", temperature=1.0,
                                         seed=11).numpy()
    np.testing.assert_array_equal(out, again)
    # No batch_axis: every rank holds all rows, and samples as generate.
    np.testing.assert_array_equal(
        generate_parallel_rank_major(model, prompt, 10, n=N,
                                     temperature=1.0, seed=11).numpy(),
        generate(model, prompt, 10, temperature=1.0, seed=11).numpy())
    # The filters ride the parallel decode: top_k=1 is greedy.
    p2 = np.random.RandomState(5).randint(0, 31, size=(4, 3)).astype(
        np.int32)
    np.testing.assert_array_equal(
        generate_parallel_rank_major(model, p2, 6, n=N, batch_axis="dcn",
                                     temperature=2.0, top_k=1).numpy(),
        generate(model, p2, 6).numpy())


def test_single_device_decoders_refuse_as_jax():
    """JAX's refusals: plain generate / beam_search on an MoE or a
    Ulysses model point at the parallel decoders; ring impls have no
    decode; a batch that does not split over batch_axis raises."""
    jm, params, pm = _moe(4)
    prompt = np.zeros((4, 3), np.int32)
    for fn, kw, name in ((jax_generate, {}, "generate_parallel"),):
        with pytest.raises(ValueError, match=name):
            fn(jm, params, prompt, 2, **kw)
    with pytest.raises(ValueError, match="generate_parallel"):
        generate(pm, prompt, 2)
    with pytest.raises(ValueError, match="beam_search_parallel"):
        beam_search(pm, prompt, 2, beams=2)
    cfg, params, _ = _ulysses(4, 41, 8, 4, 6)
    ul = _port_model(cfg, params, attn_impl="ulysses", seq_axis="ici")
    with pytest.raises(ValueError, match="generate_parallel"):
        generate(ul, prompt, 2)
    with pytest.raises(ValueError, match="beam_search_parallel"):
        beam_search(ul, prompt, 2, beams=2)
    ring = TransformerLM(**cfg, attn_impl="ring", seq_axis="ici",
                         device="cpu")
    with pytest.raises(ValueError, match="local'/'flash"):
        generate_parallel_rank_major(ring, prompt, 2, n=N)
    with pytest.raises(ValueError, match="batch_axis size 2"):
        generate_parallel_rank_major(pm, prompt[:3], 2, n=N,
                                     batch_axis="dcn")
    with pytest.raises(ValueError, match="exceeds vocab"):
        beam_search_parallel_rank_major(pm, prompt, 2, n=N, beams=30)
    # A Ulysses decode needs the heads to split over the axis.
    odd = TransformerLM(**dict(cfg, num_heads=2), attn_impl="ulysses",
                        seq_axis="ici", device="cpu")
    with pytest.raises(ValueError, match="divisible by axis size 4"):
        generate_parallel_rank_major(odd, prompt, 2, n=N)
