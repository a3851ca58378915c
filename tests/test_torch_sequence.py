"""The port's sequence-parallel attention (torchmpi_tpu_torch/parallel/
sequence.py, rank-major), the flash forward's residual form, the model's
sequence-parallel impls and the ``longcontext_lm`` step against the JAX
package on the CPU.

- ``flash_fwd_residual_plain`` (the residual kernel's plain version, which
  the wrapper takes for CPU tensors) against JAX ``flash_attention(...,
  return_residuals=True)`` in Pallas interpret mode: causal, window, GQA
  and a fully masked pair; num, m and l within 1e-5.
- Ring and Ulysses, dense and flash blocks, rank-major stacks ``[n, B,
  T_local, H, D]`` against JAX's under ``shard_map`` on a 4-device
  sub-mesh (the flash ring in interpret mode): not causal, causal, window;
  and 8 ranks.  The output and the gradients of ``sum(o * w)`` with
  respect to q, k and v, at JAX's own tolerances (3e-5 forward, 5e-5
  gradients).
- ``TransformerLM(attn_impl=..., seq_axis="ici").forward_rank_major``
  against JAX's sequence-parallel model under ``shard_map``
  (``test_transformer_ring_matches_local``'s model and tolerance 3e-4).
- One ``longcontext_lm`` step, rank-major on 4 ranks at T 64, against the
  JAX example's step on 4 devices (its code, on the same weights and
  batch): the loss within 1e-5, the synced gradients (the world-size
  factor on both sides, ROADMAP queue C note 22) within 1e-4 of each
  leaf's largest, the parameters after one Adam step within 1e-5.
- The errors JAX raises, with JAX's messages: GQA with a
  sequence-parallel impl, an unknown ``block_impl``, heads not divisible
  by the axis size.

The process-world forms (gloo) are held to these rank-major ones in
tests/test_torch_sequence_world.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.ops import flash as jflash
from torchmpi_tpu.parallel import sequence as jseq
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.examples import longcontext_lm as tlc
from torchmpi_tpu_torch.models import TransformerLM
from torchmpi_tpu_torch.ops import flash as tflash
from torchmpi_tpu_torch.parallel import sequence as tseq

torch.set_num_threads(2)

FWD = dict(rtol=3e-5, atol=3e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """One JAX runtime (the flat 1 x 8 mesh) for the module, and no port
    runtime: the rank-major forms need none.  Both are stopped around the
    module."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    yield
    jmpi.stop()
    tmpi.stop()


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("ici",))


def _stack(x, n):
    """[B, T, ...] numpy -> the rank-major torch stack [n, B, T / n, ...]."""
    B, T = x.shape[:2]
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(B, n, T // n, *x.shape[2:]).swapaxes(0, 1)))


def _unstack(xs):
    """[n, B, T_local, ...] torch -> [B, n * T_local, ...] numpy."""
    x = xs.detach().numpy().swapaxes(0, 1)
    return x.reshape(x.shape[0], -1, *x.shape[3:])


# ---------------------------------------------------------------------------
# The residual form of row 1
# ---------------------------------------------------------------------------

# (B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset, block)
RESIDUAL_CASES = [
    (2, 32, 32, 2, 2, 8, True, None, 32, 0, 8),    # a ring step behind
    (1, 40, 24, 4, 2, 16, True, None, 24, 24, 8),  # diagonal, GQA, ragged
    (1, 32, 32, 2, 2, 8, True, 12, 32, 16, 8),     # window across shards
    (1, 16, 16, 2, 2, 8, True, None, 0, 16, 8),    # fully masked pair
    (2, 24, 40, 4, 1, 8, False, None, 0, 0, 8),    # not causal, GQA 4
]


@pytest.mark.parametrize("case", RESIDUAL_CASES,
                         ids=["behind", "diagonal-gqa", "window", "masked",
                              "full-gqa"])
def test_residual_plain_matches_jax(case):
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, block = case
    rng = np.random.RandomState(40)
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k = rng.randn(B, Tkv, Hkv, D).astype(np.float32)
    v = rng.randn(B, Tkv, Hkv, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    want = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, q_offset=qo, kv_offset=ko, block_q=block,
        block_k=block, window=window, return_residuals=True)
    got = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale, q_offset=qo, kv_offset=ko,
        window=window, return_residuals=True)
    for g, w, name in zip(got, want, ("num", "m", "l")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if case[9] >= case[8] + Tq:  # every key after every query
        assert (got[1] == tflash.NEG_INF).all() and (got[2] == 0).all()
        assert (got[0] == 0).all()


def test_plain_forward_divides_the_residuals():
    """``flash_fwd_plain`` is the residual form divided by l: one dense
    definition serves both."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 24, 2, 8, generator=g) for _ in range(3))
    kw = dict(scale=0.3, causal=True, window=5, q_offset=8, kv_offset=0)
    num, m, l = tflash.flash_fwd_residual_plain(q, k, v, **kw)
    o, lse = tflash.flash_fwd_plain(q, k, v, **kw)
    assert (l == 0).any() and (l > 0).any()
    denom = torch.where(l > 0, l, torch.ones_like(l))
    assert torch.equal(o, num / denom.transpose(1, 2)[..., None])
    assert torch.equal(lse, tflash.lse_from_residuals(m, l))


# ---------------------------------------------------------------------------
# Ring and Ulysses, rank-major, against JAX under shard_map
# ---------------------------------------------------------------------------

IMPLS = {
    "ring-dense": ("ring", "dense"),
    "ring-flash": ("ring", "flash"),
    "ulysses-dense": ("ulysses", "dense"),
    "ulysses-flash": ("ulysses", "flash"),
}
# (n, B, T, H, D, causal, window): JAX's own sizes (tests/test_flash.py
# :149 and :277, tests/test_sequence.py :216 and :259).
MODES = {
    "full": (4, 2, 32, 4, 8, False, None),
    "causal": (4, 1, 32, 4, 8, True, None),
    "window": (4, 1, 32, 4, 8, True, 6),
    "8ranks": (8, 2, 64, 8, 8, True, None),
}
# JAX's flash ring runs each of its 2n ring steps through the Pallas
# interpreter: 25-45 s a case with gradients at 4 ranks, ~400 s at 8.  So
# the port's flash ring meets JAX's flash ring in the window mode (causal,
# a band across shards, whole shards masked), and JAX's dense ring in the
# others, which JAX's own tests hold to its flash ring within 3e-5
# (tests/test_flash.py:149, :277).
# Ulysses' flash form is JAX's flash_attention_grad on a head shard, ~7 s
# a case interpreted at 4 ranks and 12 s at 8: its 8-rank case meets JAX's
# dense Ulysses (held to the flash one within 3e-5 by
# tests/test_sequence.py:173), and causal is held through the window mode.
JAX_BLOCK = {case: "dense" for case in (
    ("ring-flash", "full"), ("ring-flash", "causal"), ("ring-flash", "8ranks"),
    ("ulysses-flash", "8ranks"))}
CASES = [(i, m) for i in IMPLS for m in MODES
         if (i, m) != ("ulysses-flash", "causal")]


def _jax_attention(kind, block, n, q, k, v, w, causal, window):
    """JAX's o and the gradients of psum(sum(o * w)) under shard_map over
    ``n`` devices (one jit of both)."""
    spec = P(None, "ici")

    def body(q, k, v, w):
        if kind == "ring":
            o = jseq.ring_attention(q, k, v, "ici", causal=causal,
                                    block_impl=block, window=window,
                                    block_q=8, block_k=8)
        else:
            o = jseq.ulysses_attention(q, k, v, "ici", causal=causal,
                                       block_impl=block, window=window)
        return lax.psum(jnp.sum(o * w), "ici"), o

    f = shard_map(body, mesh=_mesh(n), in_specs=(spec,) * 4,
                  out_specs=(P(), spec), check_vma=False)
    (_, o), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v, w)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl,mode", CASES,
                         ids=[f"{i}-{m}" for i, m in CASES])
def test_rank_major_matches_jax(impl, mode):
    kind, block = IMPLS[impl]
    n, B, T, H, D, causal, window = MODES[mode]
    rng = np.random.RandomState(50)
    q, k, v, w = (rng.randn(B, T, H, D).astype(np.float32) * 0.5
                  for _ in range(4))
    o_j, g_j = _jax_attention(kind, JAX_BLOCK.get((impl, mode), block), n,
                              q, k, v, w, causal, window)

    fn = (tseq.ring_attention_rank_major if kind == "ring"
          else tseq.ulysses_attention_rank_major)
    xs = [_stack(a, n).requires_grad_() for a in (q, k, v)]
    o = fn(*xs, causal=causal, block_impl=block, window=window)
    (o * _stack(w, n)).sum().backward()
    np.testing.assert_allclose(_unstack(o), o_j, **FWD, err_msg="o")
    for x, g, name in zip(xs, g_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_unstack(x.grad), g, **GRAD,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses",
                                  "ulysses_flash"])
def test_transformer_sequence_parallel_matches_jax(impl):
    """JAX's ``test_transformer_ring_matches_local`` for the port: the
    sequence-parallel model over 8 rank-major ranks against JAX's local
    model on the whole sequence, on JAX's init (vocab 256, embed 128,
    depth 2, 8 heads of 16, learned positions, B 2, T 64), rtol and atol
    3e-4."""
    n, T = 8, 64
    tokens = np.random.RandomState(0).randint(0, 256, size=(2, T)).astype(
        np.int32)
    local = JaxLM(attn_impl="local")
    variables = local.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = np.asarray(local.apply(variables, jnp.asarray(tokens)))

    model = TransformerLM(attn_impl=impl, seq_axis="ici", device="cpu")
    model.load_state_dict(tweights.from_flax_params(variables, model))
    with torch.no_grad():
        got = model.forward_rank_major(_stack(tokens, n).long())
    np.testing.assert_allclose(_unstack(got), want, rtol=3e-4, atol=3e-4)


def test_transformer_ring_matches_jax_ring():
    """The dense ring model against JAX's ring model under ``shard_map`` on
    8 devices (JAX's sequence-parallel forward itself, same weights)."""
    n, T = 8, 64
    tokens = np.random.RandomState(1).randint(0, 256, size=(2, T)).astype(
        np.int32)
    variables = JaxLM(attn_impl="local").init(jax.random.PRNGKey(1),
                                              jnp.asarray(tokens))
    jlm = JaxLM(attn_impl="ring", seq_axis="ici")
    spec = P(None, "ici")
    want = np.asarray(jax.jit(shard_map(
        lambda vs, tok: jlm.apply(vs, tok, pos_offset=lax.axis_index("ici")
                                  * (T // n)),
        mesh=_mesh(n), in_specs=(P(), spec), out_specs=spec,
        check_vma=False))(variables, jnp.asarray(tokens)))
    model = TransformerLM(attn_impl="ring", seq_axis="ici", device="cpu")
    model.load_state_dict(tweights.from_flax_params(variables, model))
    with torch.no_grad():
        got = model.forward_rank_major(_stack(tokens, n).long())
    np.testing.assert_allclose(_unstack(got), want, rtol=3e-4, atol=3e-4)


def test_rank_major_grid_folds_dcn_into_the_batch():
    """A [n_dcn, n_ici, B, T] stack: the sequence over ici, each dcn rank
    its own rows; equal to the [n_ici, n_dcn * B, T] stack's forward."""
    g = torch.Generator().manual_seed(4)
    model = TransformerLM(vocab=64, embed=32, depth=1, num_heads=4,
                          head_dim=8, max_len=32, attn_impl="ring",
                          seq_axis="ici", pos_emb="rope", device="cpu",
                          generator=g)
    tok = torch.randint(0, 64, (2, 4, 3, 8), generator=g)
    with torch.no_grad():
        grid = model.forward_rank_major(tok)
        flat = model.forward_rank_major(
            tok.transpose(0, 1).reshape(4, 6, 8))
    torch.testing.assert_close(
        grid, flat.view(4, 2, 3, 8, 64).transpose(0, 1), rtol=1e-6,
        atol=1e-6)


# ---------------------------------------------------------------------------
# The example's step
# ---------------------------------------------------------------------------

LC_N, LC_T, LC_B, LC_VOCAB, LC_LR = 4, 64, 16, 64, 3e-3


def _jax_example_step(model, tx, mesh, t_local):
    """examples/longcontext_lm.py's ``step`` (:80-103), returning the
    synced gradients too."""
    axes = mesh.axis_names

    def step(variables, opt_state, tokens, key, p):
        offset = lax.axis_index("ici") * t_local

        def loss_fn(vs):
            logits = model.apply(vs, tokens, pos_offset=offset)
            gpos = offset + jnp.arange(t_local)
            mask = (gpos[None, :] > p[:, None]).astype(jnp.float32)
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.broadcast_to(key[:, None], tokens.shape))
            return (lax.psum((losses * mask).sum(), axes)
                    / lax.psum(mask.sum(), axes))

        loss, grads = jax.value_and_grad(loss_fn)(variables)
        grads = jmpi.nn.synchronize_gradients(grads, axes, op="sum")
        updates, opt_state = tx.update(grads, opt_state, variables)
        return optax.apply_updates(variables, updates), loss, grads

    spec, vec = P("dcn", "ici"), P("dcn")
    return jax.jit(shard_map(step, mesh=mesh,
                             in_specs=(P(), P(), spec, vec, vec),
                             out_specs=(P(), P(), P()), check_vma=False))


def test_longcontext_step_matches_jax():
    mesh = Mesh(np.array(jax.devices()[:LC_N]).reshape(1, LC_N),
                ("dcn", "ici"))
    jlm = JaxLM(vocab=LC_VOCAB, embed=128, depth=2, num_heads=8,
                head_dim=16, max_len=LC_T, attn_impl="ring", seq_axis="ici")
    variables = JaxLM(vocab=LC_VOCAB, embed=128, depth=2, num_heads=8,
                      head_dim=16, max_len=LC_T, attn_impl="local").init(
        jax.random.PRNGKey(0), jnp.zeros((1, LC_T), jnp.int32))
    tx = optax.adam(LC_LR)
    batch = tlc.make_batch(np.random.RandomState(0), LC_B, LC_T, LC_VOCAB)
    new_vars, loss_j, grads_j = _jax_example_step(
        jlm, tx, mesh, LC_T // LC_N)(variables, tx.init(variables),
                                     *map(jnp.asarray, batch))

    model = TransformerLM(vocab=LC_VOCAB, embed=128, depth=2, num_heads=8,
                          head_dim=16, max_len=LC_T, attn_impl="ring",
                          seq_axis="ici", device="cpu")
    model.load_state_dict(tweights.from_flax_params(variables, model))
    ttx = toptim.adam(LC_LR)
    step = tlc.make_train_step(model, ttx, rank_major=True, grid_size=LC_N)
    _, loss, grads = step([ttx.init(p.detach()) for p in model.parameters()],
                          *tlc.shard_batch(*batch, 1, LC_N,
                                           torch.device("cpu"),
                                           rank_major=True))

    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    want_g = tweights.from_flax_params(jax.tree.map(np.asarray, grads_j),
                                       model)
    for name, g in zip(names, grads):
        w = want_g[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (name, err)
    # Adam's first step moves an entry by lr * g / (|g| + 1e-8): where g
    # is rounding noise (below 1e-6 of its leaf's largest; the k third of
    # each qkv bias has gradient 0 in exact arithmetic, as softmax ignores
    # a shift of every key by the same vector) the two frameworks' noise
    # moves it anywhere within lr.  Those entries are held to that bound;
    # every other entry within 1e-5 (ROADMAP queue C note 20).
    want_p = tweights.from_flax_params(jax.tree.map(np.asarray, new_vars),
                                       model)
    old = tweights.from_flax_params(variables, model)
    noise = 0
    for (name, prm), g_port in zip(model.named_parameters(), grads):
        got, want = prm.detach().numpy(), want_p[name].numpy()
        g = np.maximum(np.abs(want_g[name].numpy()), np.abs(g_port.numpy()))
        quiet = g < 1e-6 * g.max()
        noise += int((quiet & (g > 0)).sum())
        np.testing.assert_allclose(got[~quiet], want[~quiet], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        for side in (got, want):
            moved = np.abs(side - old[name].numpy())[quiet]
            assert (moved <= LC_LR * (1 + 1e-5)).all(), name
    assert 0 < noise < 1e-3 * sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Errors, with JAX's messages
# ---------------------------------------------------------------------------


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_gqa_with_a_sequence_parallel_impl_raises_as_jax():
    tok = jnp.zeros((1, 8), jnp.int32)
    want = _jax_error(lambda: JaxLM(attn_impl="ring", num_kv_heads=4,
                                    seq_axis="ici").init(
        jax.random.PRNGKey(0), tok))
    with pytest.raises(ValueError) as e:
        TransformerLM(attn_impl="ring", num_kv_heads=4, seq_axis="ici",
                      device="cpu")
    assert str(e.value) == want


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_unknown_block_impl_raises_as_jax(kind):
    n = 4
    x = np.zeros((1, 16, 4, 8), np.float32)
    jfn = jseq.ring_attention if kind == "ring" else jseq.ulysses_attention
    spec = P(None, "ici")
    want = _jax_error(lambda: jax.jit(shard_map(
        lambda q, k, v: jfn(q, k, v, "ici", block_impl="nope"),
        mesh=_mesh(n), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False))(x, x, x))
    fn = (tseq.ring_attention_rank_major if kind == "ring"
          else tseq.ulysses_attention_rank_major)
    xs = _stack(x, n)
    with pytest.raises(ValueError) as e:
        fn(xs, xs, xs, block_impl="nope")
    assert str(e.value) == want


def test_heads_not_divisible_raise_as_jax():
    n = 4
    x = np.zeros((1, 16, 5, 8), np.float32)
    spec = P(None, "ici")
    want = _jax_error(lambda: jax.jit(shard_map(
        lambda q, k, v: jseq.ulysses_attention(q, k, v, "ici"),
        mesh=_mesh(n), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False))(x, x, x))
    xs = _stack(x, n)
    with pytest.raises(ValueError) as e:
        tseq.ulysses_attention_rank_major(xs, xs, xs)
    assert str(e.value) == want
