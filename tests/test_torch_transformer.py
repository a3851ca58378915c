"""The port's TransformerLM (torchmpi_tpu_torch.models) against the JAX
package's, on the CPU.

One flax parameter tree (seeded init) is loaded into the port's module with
``weights.from_flax_params``; a numpy-seeded token batch goes through both
models with stage B's dense loss (``x @ head``, softmax cross-entropy).  The
gradient tree maps onto the port's parameters through the same loader.

Tolerances: float32 rtol 1e-4 (loss and every gradient).  bf16 compute
(float32 parameters, as the flagship runs): the two frameworks round the
bf16 products at different points, so the loss is held to rtol 1e-2 and
each gradient to a relative L2 error of 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.models.transformer import apply_rope as jax_rope
import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.models import Block, SPAttention, TransformerLM
from torchmpi_tpu_torch.models.transformer import apply_rope

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _stopped_runtimes():
    """Neither package's runtime left running by an earlier test file in
    this worker: both sides of every comparison here read their default
    Config (or the one a test sets up itself), and this module leaves
    nothing running either."""
    jmpi.stop()
    tmpi.stop()
    yield
    jmpi.stop()
    tmpi.stop()


# depth 2, embed 64, vocab 128, T 64, RoPE + window + GQA.
CFG = dict(vocab=128, embed=64, depth=2, num_heads=4, head_dim=16,
           num_kv_heads=2, max_len=64, window=24, pos_emb="rope")
B, T = 2, 64


def jax_loss(model, params, tok):
    logits = model.apply({"params": params}, tok).astype(jnp.float32)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], tok[:, 1:]).mean()


def torch_loss(model, tok):
    logits = model(tok).float()
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tok[:, 1:].reshape(-1))


def _jax_params(cfg, seed=0):
    model = JaxLM(**cfg, attn_impl="local")
    tok = jnp.zeros((1, T), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), tok)["params"]
    return jax.tree.map(np.asarray, params)


def _tokens(seed=5):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab"], size=(B, T)).astype(np.int32)


def _port_model(cfg, params, attn_impl, dtype):
    model = TransformerLM(**cfg, attn_impl=attn_impl, dtype=dtype,
                          device="cpu")
    model.load_state_dict(tmpi.weights.from_flax_params(params, model))
    return model


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# (JAX attn_impl, port attn_impl, dtype).  The JAX flash side runs its
# Pallas kernels in interpret mode; in bf16 the port's flash path is held
# against the JAX dense path (the attention math is the same, in float32).
CASES = [("flash", "flash", "float32"), ("local", "local", "float32"),
         ("local", "flash", "bfloat16"), ("local", "local", "bfloat16")]


@pytest.mark.parametrize("jax_impl,attn_impl,dtype", CASES,
                         ids=["-".join(c) for c in CASES])
def test_transformer_loss_and_grads_match_jax(jax_impl, attn_impl, dtype):
    params = _jax_params(CFG)
    tok = _tokens()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmodel = JaxLM(**CFG, attn_impl=jax_impl, dtype=jdt)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(jmodel, p, jnp.asarray(tok))))(params)

    model = _port_model(CFG, params, attn_impl, tdt)
    loss_t = torch_loss(model, torch.from_numpy(tok).long())
    loss_t.backward()
    want = tmpi.weights.from_flax_params(jax.tree.map(np.asarray, grads_j),
                                         model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    if dtype == "float32":
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)
    else:
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-2)
        for n in want:
            assert _rel_l2(got[n], want[n]) < 5e-2, n


def test_learned_positions_mha_forward_matches_jax():
    """The other layouts: learned position table, fused qkv (MHA)."""
    cfg = dict(CFG, num_kv_heads=None, pos_emb="learned", window=None)
    params = _jax_params(cfg, seed=1)
    assert "qkv" in params["Block_0"]["SPAttention_0"]
    tok = _tokens(6)
    want = JaxLM(**cfg).apply({"params": params}, jnp.asarray(tok))
    model = _port_model(cfg, params, "flash", torch.float32)
    got = model(torch.from_numpy(tok).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    h, head = model(torch.from_numpy(tok).long(), return_prehead=True)
    assert head is model.head and h.shape == (B, T, CFG["embed"])


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 3, 10).astype(np.float32)
    pos = (rng.randint(0, 50, size=(2, 7)) if per_row
           else np.arange(5, 12)).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        apply_rope(torch.zeros(1, 2, 1, 3), torch.arange(2))


def test_later_slices_raise():
    # Decode runs (tests/test_torch_generate.py); the decoders it still
    # refuses are JAX's ring refusal and the mesh-parallel ones of queue A,
    # item 9 (b).
    mha = {k: v for k, v in CFG.items() if k != "num_kv_heads"}
    with pytest.raises(ValueError, match=r"queue A, item 9 \(b\)"):
        TransformerLM(**mha, decode=True, attn_impl="ulysses",
                      seq_axis="ici", device="cpu")
    with pytest.raises(ValueError, match="local'/'flash"):
        TransformerLM(**mha, decode=True, attn_impl="ring", seq_axis="ici",
                      device="cpu")
    # The sequence-parallel impls run (tests/test_torch_sequence.py); with
    # CFG's grouped-query heads they refuse as JAX's do.
    with pytest.raises(ValueError, match="num_kv_heads"):
        TransformerLM(**CFG, attn_impl="ring", device="cpu")
    with pytest.raises(ValueError):
        TransformerLM(**CFG, attn_impl="nope", device="cpu")


@pytest.mark.parametrize("build", [
    lambda **kw: TransformerLM(**CFG, **kw),
    lambda **kw: Block(64, 4, 16, num_kv_heads=2, rope=True, **kw),
    lambda **kw: SPAttention(64, 4, 16, attn_impl="flash", **kw),
], ids=["TransformerLM", "Block", "SPAttention"])
def test_modules_default_to_the_card(build):
    """Every public module builds on the card unless asked for the CPU;
    without a card the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device would work")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    m = build(device="cpu")
    assert {p.device.type for p in m.parameters()} == {"cpu"}


def test_from_flax_params_rejects_a_mismatched_tree():
    params = _jax_params(CFG)
    model = TransformerLM(**dict(CFG, depth=1), device="cpu")
    with pytest.raises(ValueError):
        tmpi.weights.from_flax_params(params, model)
