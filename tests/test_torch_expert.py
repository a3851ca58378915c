"""The port's expert-parallel MoE layer (torchmpi_tpu_torch/parallel/
expert.py, rank-major), the model's ``moe_axis`` and the ``moe_lm`` step
against the JAX package on the CPU.

- ``moe_layer_rank_major`` against JAX's ``moe_layer`` under ``shard_map``
  (every case of tests/test_expert.py, at its tolerances): the forward at
  k 1 and 2, capacity factor 2.0 and 0.5, with the expert group over
  ("dcn", "ici") on the 1 x 8 mesh and over "ici" (and "dcn") on the 2 x 4
  mesh, 2 experts a rank; the gate and expert gradients; ``k = 0``
  raising with JAX's message; ``return_aux``; the load-balance loss.
- ``topk_dispatch`` bitwise (buffers, combine weights, experts, slots,
  valid) when both sides get the same probabilities, with overflow, tied
  probabilities (ties to the lower expert index, as ``lax.top_k``) and
  k = 3.
- The model: ``weights.from_flax_params`` on a JAX ``TransformerLM(
  moe_axis=...)``; ``forward_rank_major`` against JAX's ``shard_map``
  apply (3e-4, as ``test_moe_transformer_matches_single_device``); the aux
  losses against JAX's sown ``"losses"``; one ``moe_lm`` step's loss and
  synced gradients against the JAX example's step (the world-size factor
  on both sides, ROADMAP queue C note 23); the sp x ep x dp model of the
  JAX package's driver artifact (dense ring, RoPE, window, MoE over ici)
  rank-major on 2 x 2 against JAX.

The process-world form (gloo) is held to the rank-major one in
tests/test_torch_expert_world.py.
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
from torchmpi_tpu.parallel import expert as jep
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.examples import moe_lm as tmoe
from torchmpi_tpu_torch.models import TransformerLM
from torchmpi_tpu_torch.parallel import expert as tep

torch.set_num_threads(2)

T, D, E_LOCAL = 16, 8, 2  # tokens a rank, width, experts a rank (JAX's)
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """One JAX runtime (the 2 x 4 world) for the module, and no port
    runtime: the rank-major forms need none.  Both are stopped around the
    module."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=2))
    yield
    jmpi.stop()
    tmpi.stop()


def _mesh(n_dcn, n_ici):
    return Mesh(np.array(jax.devices()[:n_dcn * n_ici]).reshape(n_dcn, n_ici),
                ("dcn", "ici"))


# (mesh grid, JAX axis names, the port's axis_name)
GROUPS = {
    "world-1x8": ((1, 8), ("dcn", "ici"), ("dcn", "ici")),
    "ici-2x4": ((2, 4), "ici", "ici"),
    "dcn-2x4": ((2, 4), "dcn", "dcn"),
}


def _setup(grid, axis, seed):
    """JAX's ``_setup``: gate [D, E], one dense a expert [E, D, D], tokens
    [n_dcn, n_ici, T, D]; E = the group's size x E_LOCAL."""
    n_dcn, n_ici = grid
    G = (n_dcn * n_ici if not isinstance(axis, str)
         else n_dcn if axis == "dcn" else n_ici)
    rng = np.random.RandomState(seed)
    E = G * E_LOCAL
    gate_w = rng.randn(D, E).astype(np.float32)
    W = rng.randn(E, D, D).astype(np.float32) * 0.3
    X = rng.randn(n_dcn, n_ici, T, D).astype(np.float32)
    return gate_w, W, X


def _expert_fn(w_e, tokens):
    return jnp.tanh(tokens @ w_e)


def _experts(w, tokens):
    return torch.tanh(tokens @ w)


def _jax_layer(body, grid, axis, X, gate_w, W, out_specs):
    """``body(x [T, D], gate_w, W_local)`` under shard_map over the grid:
    x sharded over both axes, W over the group's axis."""
    spec_x = P("dcn", "ici")
    return jax.jit(shard_map(
        lambda x, gw, w: body(x[0, 0], gw, w), mesh=_mesh(*grid),
        in_specs=(spec_x, P(), P(axis)), out_specs=out_specs,
        check_vma=False))(X, gate_w, W)


FWD_CASES = [(g, k, cf) for g in GROUPS for k in (1, 2)
             for cf in (2.0, 0.5)]


@pytest.mark.parametrize("group,k,cf", FWD_CASES,
                         ids=[f"{g}-k{k}-cf{cf}" for g, k, cf in FWD_CASES])
def test_forward_matches_jax(group, k, cf):
    grid, jaxis, taxis = GROUPS[group]
    gate_w, W, X = _setup(grid, jaxis, seed=3 if k == 2 else 0)
    want = _jax_layer(
        lambda x, gw, w: jep.moe_layer(x, gw, _expert_fn, w, jaxis,
                                       capacity_factor=cf, k=k)[None, None],
        grid, jaxis, X, gate_w, W, P("dcn", "ici"))
    got = tep.moe_layer_rank_major(
        torch.from_numpy(X), torch.from_numpy(gate_w), _experts,
        torch.from_numpy(W), taxis, capacity_factor=cf, k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("group,k", [("world-1x8", 1), ("world-1x8", 2),
                                     ("ici-2x4", 2)])
def test_gradients_match_jax(group, k):
    """The gate's and the experts' gradients of sum(out ** 2) over every
    rank, through the dispatch's scatter-add, both all-to-alls and the
    gate (JAX's gate gradients summed over the ranks, as its test does)."""
    grid, jaxis, taxis = GROUPS[group]
    gate_w, W, X = _setup(grid, jaxis, seed=1 if k == 1 else 4)
    axes = ("dcn", "ici")

    def body(x, gw, w):
        def loss(gw_, w_):
            out = jep.moe_layer(x, gw_, _expert_fn, w_, jaxis, k=k)
            return jnp.sum(out ** 2)

        g1, g2 = jax.grad(loss, argnums=(0, 1))(gw, w)
        # Each expert's gradient: its owner's, plus the replicas' over the
        # other axis (the rank-major weights are one tensor).
        other = tuple(a for a in axes if a not in
                      ((jaxis,) if isinstance(jaxis, str) else jaxis))
        if other:
            g2 = lax.psum(g2, other)
        return lax.psum(g1, axes), g2

    g_gate, g_w = _jax_layer(body, grid, jaxis, X, gate_w, W,
                             (P(), P(jaxis)))
    gw_t = torch.from_numpy(gate_w).requires_grad_()
    w_t = torch.from_numpy(W).requires_grad_()
    out = tep.moe_layer_rank_major(torch.from_numpy(X), gw_t, _experts, w_t,
                                   taxis, k=k)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(g_w), **GRAD)
    np.testing.assert_allclose(gw_t.grad.numpy(), np.asarray(g_gate), **GRAD)
    assert float(gw_t.grad.abs().sum()) > 0  # the gate receives gradient


def test_k_zero_raises_as_jax():
    grid, jaxis, taxis = GROUPS["world-1x8"]
    gate_w, W, X = _setup(grid, jaxis, seed=0)
    with pytest.raises(ValueError, match="k >= 1") as want:
        _jax_layer(lambda x, gw, w: jep.moe_layer(
            x, gw, _expert_fn, w, jaxis, k=0)[None, None],
            grid, jaxis, X, gate_w, W, P("dcn", "ici"))
    with pytest.raises(ValueError, match="k >= 1") as got:
        tep.moe_layer_rank_major(torch.from_numpy(X),
                                 torch.from_numpy(gate_w), _experts,
                                 torch.from_numpy(W), taxis, k=0)
    assert str(got.value) == str(want.value)


def test_return_aux_matches_jax():
    grid, jaxis, taxis = GROUPS["world-1x8"]
    gate_w, W, X = _setup(grid, jaxis, seed=6)

    def body(x, gw, w):
        out, aux = jep.moe_layer(x, gw, _expert_fn, w, jaxis, k=2,
                                 return_aux=True)
        return out[None, None], aux[None, None]

    out_j, aux_j = _jax_layer(body, grid, jaxis, X, gate_w, W,
                              (P("dcn", "ici"), P("dcn", "ici")))
    out, aux = tep.moe_layer_rank_major(
        torch.from_numpy(X), torch.from_numpy(gate_w), _experts,
        torch.from_numpy(W), taxis, k=2, return_aux=True)
    assert aux.shape == (1, 8) and (aux > 0).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD)
    np.testing.assert_allclose(aux.numpy(), np.asarray(aux_j), rtol=1e-6)


def test_load_balance_loss_matches_jax():
    """JAX's invariants (uniform routing gives 1.0, collapsed routing about
    E, [T, k] routes accepted), each value equal to JAX's."""
    rng = np.random.RandomState(0)
    E = 8
    uniform = np.zeros((32, E), np.float32)
    peaked = np.where(np.arange(E) == 0, 10.0, 0.0)[None].repeat(
        32, 0).astype(np.float32)
    cases = [(uniform, np.arange(32) % E),
             (peaked, np.zeros(32, np.int64)),
             (uniform, rng.randint(0, E, size=(32, 2))),
             (rng.randn(32, E).astype(np.float32),
              rng.randint(0, E, size=(32, 3)))]
    got = [float(tep.load_balance_loss(torch.from_numpy(lg),
                                       torch.from_numpy(eo), E))
           for lg, eo in cases]
    want = [float(jep.load_balance_loss(jnp.asarray(lg), jnp.asarray(eo), E))
            for lg, eo in cases]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(1.0, rel=1e-6)
    assert got[1] > 4.0
    # Leading dims: one loss a rank.
    stack = np.stack([cases[3][0]] * 2)
    both = tep.load_balance_loss(torch.from_numpy(stack),
                                 torch.from_numpy(np.stack([cases[3][1]] * 2)),
                                 E)
    assert both.shape == (2,) and torch.equal(both[0], both[1])
    assert float(both[0]) == pytest.approx(got[3], rel=1e-6)


# (T, E, capacity, k, renormalize, ties)
DISPATCH_CASES = {
    "k1-overflow": (24, 4, 4, 1, False, False),
    "k2": (24, 4, 12, 2, True, False),
    "k2-overflow": (32, 8, 3, 2, True, False),
    "k3-overflow": (24, 4, 8, 3, True, False),
    "k2-ties": (32, 6, 5, 2, True, True),
    "k3-ties-raw": (16, 5, 4, 3, False, True),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_topk_dispatch_bitwise(case):
    """The same probabilities on both sides: every output bit for bit,
    including the slot order under overflow and the tie rule."""
    Tn, E, C, k, renorm, ties = DISPATCH_CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.randn(2, Tn, D).astype(np.float32)
    logits = rng.randn(2, Tn, E).astype(np.float32)
    if ties:  # a few levels: most rows hold equal probabilities
        logits = np.round(logits)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    got = tep.topk_dispatch(torch.from_numpy(x), None, E, C, k,
                            renormalize=renorm, probs=torch.from_numpy(probs))
    names = ("buffers", "combine_w", "expert_of", "slot_of", "valid")
    n_tied = 0
    for r in range(2):
        want = jep.topk_dispatch(jnp.asarray(x[r]), None, E, C, k,
                                 renormalize=renorm,
                                 probs=jnp.asarray(probs[r]))
        for name, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w),
                                          err_msg=name)
        if "overflow" in case:
            assert not bool(want[4].all())
        sorted_p = -np.sort(-probs[r], axis=-1)
        n_tied += int((sorted_p[:, k - 1] == sorted_p[:, k]).sum())
    assert (n_tied > 0) == ties


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

MOE_LM = dict(vocab=64, embed=32, depth=1, num_heads=4, head_dim=8,
              max_len=8)


def _jax_moe_variables(model, tokens, mesh, spec):
    return jax.jit(shard_map(
        lambda tok: model.init(jax.random.PRNGKey(0), tok), mesh=mesh,
        in_specs=spec, out_specs=P(), check_vma=False))(tokens)


def _jax_apply(model, variables, tokens, mesh, spec, **kw):
    """Logits and each layer's sown loss, rank by rank."""
    def fwd(vs, tok):
        logits, sown = model.apply(vs, tok, mutable=["losses"], **{
            k: v(tok) for k, v in kw.items()})
        aux = jnp.stack(jax.tree.leaves(sown["losses"]))
        return logits, aux[None]

    logits, aux = jax.jit(shard_map(
        fwd, mesh=mesh, in_specs=(P(), spec),
        out_specs=(spec, P(("dcn", "ici"))), check_vma=False))(
        variables, tokens)
    return np.asarray(logits), np.asarray(aux)


def test_moe_transformer_matches_jax():
    """JAX's ``test_moe_transformer_matches_single_device`` model (one batch
    row a rank, experts over both axes of 8 ranks): the converted weights,
    ``forward_rank_major``'s logits (3e-4) and each layer's aux loss."""
    n, Tt = 8, 8
    tokens = np.random.RandomState(0).randint(0, 64, size=(n, Tt)).astype(
        np.int32)
    mesh, spec = _mesh(1, n), P(("dcn", "ici"))
    jlm = JaxLM(**MOE_LM, moe_axis=("dcn", "ici"), moe_experts_per_device=1)
    variables = _jax_moe_variables(jlm, tokens, mesh, spec)
    logits_j, aux_j = _jax_apply(jlm, variables, tokens, mesh, spec)

    model = TransformerLM(**MOE_LM, moe_axis=("dcn", "ici"),
                          moe_axis_size=n, device="cpu")
    state = tweights.from_flax_params(variables, model)
    moe = variables["params"]["Block_0"]["MoEMLP_0"]
    for name in ("gate", "w1", "w2"):
        assert np.array_equal(state[f"blocks.0.moe.{name}"].numpy(),
                              np.asarray(moe[name]))
    model.load_state_dict(state)
    with torch.no_grad():
        got = model.forward_rank_major(torch.from_numpy(tokens).long()[:, None])
    np.testing.assert_allclose(got[:, 0].numpy(), logits_j, rtol=3e-4,
                               atol=3e-4)
    (aux,) = model.moe_aux_losses()
    assert aux.shape == (n,)
    np.testing.assert_allclose(aux.numpy(), aux_j[:, 0], rtol=1e-5)


def test_flax_fan_in_of_the_expert_kernels():
    """The port draws the expert kernels at flax's fan-in, which counts the
    expert dim (lecun_normal on a 3-D kernel), as the JAX init does."""
    n, E = 4, 256
    cfg = dict(vocab=64, embed=E, depth=1, num_heads=4, head_dim=8,
               max_len=8, moe_axis="ici")
    moe = TransformerLM(**cfg, moe_axis_size=n,
                        device="cpu").blocks[0].moe
    variables = _jax_moe_variables(
        JaxLM(**cfg), np.zeros((n, 8), np.int32),
        Mesh(np.array(jax.devices()[:n]), ("ici",)), P("ici"))
    jax_moe = variables["params"]["Block_0"]["MoEMLP_0"]
    # (tensor, flax's fan-in, relative spread of the std estimate)
    for name, fan_in, tol in (("w1", E * n, 0.01), ("w2", 4 * E * n, 0.01),
                              ("gate", E, 0.1)):
        want = 1 / np.sqrt(fan_in)
        for side in (getattr(moe, name).detach().numpy(),
                     np.asarray(jax_moe[name])):
            assert abs(float(side.std()) / want - 1) < tol, name


def test_rank_major_rows_start_at_position_zero():
    """Without a sequence-parallel impl every rank holds its own rows from
    position 0: a dense model's rank-major forward equals its forward on
    the ranks' rows folded into the batch."""
    g = torch.Generator().manual_seed(2)
    model = TransformerLM(**MOE_LM, device="cpu", generator=g)
    tok = torch.randint(0, 64, (2, 3, 2, 8), generator=g)
    with torch.no_grad():
        got = model.forward_rank_major(tok)
        want = model(tok.reshape(12, 8))
    torch.testing.assert_close(got.reshape(12, 8, 64), want, rtol=1e-6,
                               atol=1e-6)


def test_sp_ep_dp_matches_jax():
    """The JAX package's driver-artifact model (dense ring over ici, the MoE
    over ici, RoPE, a window of 4, 2 x 2 grid: batch over dcn, sequence
    over ici) rank-major against JAX's shard_map apply: logits, aux losses,
    and the gradients of its loss."""
    n_dcn, n_ici, t_local = 2, 2, 8
    B, Tt = 2 * n_dcn, t_local * n_ici
    tokens = np.random.RandomState(0).randint(0, 64, size=(B, Tt)).astype(
        np.int32)
    cfg = dict(vocab=64, embed=32, depth=1, num_heads=4, head_dim=8,
               max_len=Tt, attn_impl="ring", pos_emb="rope",
               window=max(4, t_local // 2))
    mesh, spec = _mesh(n_dcn, n_ici), P("dcn", "ici")
    jlm = JaxLM(**cfg, seq_axis="ici", moe_axis="ici",
                moe_experts_per_device=1)
    variables = _jax_moe_variables(jlm, tokens, mesh, spec)
    offset = lambda tok: lax.axis_index("ici") * t_local  # noqa: E731
    logits_j, aux_j = _jax_apply(jlm, variables, tokens, mesh, spec,
                                 pos_offset=offset)

    def step(vs, tok):
        def loss_fn(v):
            logits = jlm.apply(v, tok, pos_offset=offset(tok))
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], tok[:, 1:])
            return lax.pmean(losses.mean(), ("dcn", "ici"))

        # Each rank's loss takes cotangent 1 (psum transposes to psum), so
        # the sum of the ranks' gradients is that of the sum of the losses.
        return lax.psum(jax.grad(loss_fn)(vs), ("dcn", "ici"))

    grads_j = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), spec),
                                out_specs=P(), check_vma=False))(
        variables, tokens)

    model = TransformerLM(**cfg, seq_axis="ici", moe_axis="ici",
                          moe_axis_size=n_ici, device="cpu")
    model.load_state_dict(tweights.from_flax_params(variables, model))
    stack = torch.from_numpy(np.ascontiguousarray(
        tokens.reshape(n_dcn, 2, n_ici, t_local).transpose(0, 2, 1, 3)))
    logits = model.forward_rank_major(stack.long())
    got = logits.detach().numpy().transpose(0, 2, 1, 3, 4).reshape(
        B, Tt, 64)
    np.testing.assert_allclose(got, logits_j, rtol=3e-4, atol=3e-4)
    (aux,) = model.moe_aux_losses()
    np.testing.assert_allclose(aux.detach().numpy(), aux_j[:, 0], rtol=1e-5)

    V = logits.shape[-1]
    ce = torch.nn.functional.cross_entropy(
        logits[..., :-1, :].reshape(-1, V), stack[..., 1:].reshape(-1).long(),
        reduction="none").view(n_dcn, n_ici, -1).mean(-1)
    grads = torch.autograd.grad(ce.sum(), list(model.parameters()))
    want = tweights.from_flax_params(jax.tree.map(np.asarray, grads_j), model)
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-7, (name, err)


# ---------------------------------------------------------------------------
# The example's step
# ---------------------------------------------------------------------------

ML_DCN, ML_ICI, ML_T, ML_B, ML_VOCAB, ML_LR = 2, 4, 16, 8, 64, 3e-3


def _jax_moe_lm_step(model, tx, mesh):
    """examples/moe_lm.py's ``step`` (:82-100), returning the loss and the
    synced gradients too."""
    axes = mesh.axis_names

    def step(vs, opt_state, tok):
        def loss_fn(v):
            logits, sown = model.apply(v, tok, mutable=["losses"])
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], tok[:, 1:])
            aux = sum(jax.tree.leaves(sown["losses"]))
            return lax.pmean(losses.mean() + 1e-2 * aux, axes)

        loss, grads = jax.value_and_grad(loss_fn)(vs)
        grads = jmpi.nn.synchronize_gradients(grads, axes, op="sum")
        updates, opt_state = tx.update(grads, opt_state, vs)
        return optax.apply_updates(vs, updates), loss, grads

    return jax.jit(shard_map(step, mesh=mesh,
                             in_specs=(P(), P(), P("dcn")),
                             out_specs=(P(), P(), P()), check_vma=False))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_step_matches_jax(top_k):
    """One step of the example rank-major on dcn 2 x ici 4 against the JAX
    example's step on the 2 x 4 mesh, the same weights and batch: the loss
    within 1e-5, the synced gradients (the world size times the mean
    loss's gradient on both sides) within 1e-4 of each leaf's largest, and
    the parameters after Adam's step."""
    mesh = _mesh(ML_DCN, ML_ICI)
    args = tmoe.common.parse_args("", ["--top-k", str(top_k)],
                                  vocab=dict(type=int, default=ML_VOCAB),
                                  top_k=dict(type=int, default=1))
    jlm = JaxLM(vocab=ML_VOCAB, embed=64, depth=2, num_heads=4, head_dim=16,
                max_len=ML_T, moe_axis="ici", moe_experts_per_device=1,
                moe_k=top_k)
    rng = np.random.RandomState(0)
    tok0 = tmoe.make_batch(rng, ML_B, ML_T, ML_VOCAB)
    variables = _jax_moe_variables(jlm, tok0, mesh, P("dcn"))
    tok = tmoe.make_batch(rng, ML_B, ML_T, ML_VOCAB)
    tx = optax.adam(ML_LR)
    new_vars, loss_j, grads_j = _jax_moe_lm_step(jlm, tx, mesh)(
        variables, tx.init(variables), tok)

    model = tmoe.make_model(args, torch.device("cpu"), ML_T, ML_ICI)
    model.load_state_dict(tweights.from_flax_params(variables, model))
    ttx = toptim.adam(ML_LR)
    step = tmoe.make_train_step(model, ttx, rank_major=True,
                                grid_size=ML_DCN * ML_ICI)
    _, loss, grads = step([ttx.init(p.detach()) for p in model.parameters()],
                          tmoe.shard_batch(tok, ML_DCN, ML_ICI,
                                           torch.device("cpu"),
                                           rank_major=True))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want_g = tweights.from_flax_params(jax.tree.map(np.asarray, grads_j),
                                       model)
    for (name, prm), g in zip(model.named_parameters(), grads):
        w = want_g[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (name, err)
    # Adam's first step moves an entry by about lr * sign(g): where g is
    # rounding noise (the k third of each qkv bias; ROADMAP queue C note
    # 20) the frameworks' noise moves it anywhere within lr, and those
    # entries are held to that bound; every other entry within 1e-5.
    want_p = tweights.from_flax_params(jax.tree.map(np.asarray, new_vars),
                                       model)
    old = tweights.from_flax_params(variables, model)
    for (name, prm), g_port in zip(model.named_parameters(), grads):
        got, want = prm.detach().numpy(), want_p[name].numpy()
        g = np.maximum(np.abs(want_g[name].numpy()), np.abs(g_port.numpy()))
        quiet = g < 1e-6 * g.max()
        np.testing.assert_allclose(got[~quiet], want[~quiet], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        for side in (got, want):
            moved = np.abs(side - old[name].numpy())[quiet]
            assert (moved <= ML_LR * (1 + 1e-5)).all(), name
