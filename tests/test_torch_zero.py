"""The port's ZeRO-1 / ZeRO-3 (torchmpi_tpu_torch/parallel/zero.py) against the
JAX package's ``parallel/zero.py`` on the CPU.

- Rank-major ZeRO-1 and ZeRO-3 with backend "pallas" (the port's plain
  ring) against JAX ``zero.update`` / ``update3`` / ``gather_params`` with
  backend "pallas" (its ring kernels in interpret mode) on a 4-device
  sub-mesh, on the same seeded gradients: the reduce-scattered gradient
  shards and the gathered parameters bitwise, parameters and optimizer
  state after the update within 2e-6 (sgd with momentum and adam; the
  optimizers follow optax's operation order).  The JAX side is given lists
  of arrays in the port's order and layout, so both lay the shards out
  alike.
- ``compress="bf16"`` within the JAX package's own tolerance for it
  against the float32 oracle (``test_zero_bf16_compress_close_to_oracle``).
- 2 gloo processes' ZeRO-1 / ZeRO-3 equal the single-rank Adam step.
- ``weights.from_optax_zero_state``: one JAX ZeRO step on a flax
  TransformerLM, the shards and Adam state converted, then one more step
  on each side agrees.
- The slice as a whole: a 2-layer narrow LM loaded with
  ``from_flax_params``, 2 rank-major ZeRO-1 Adam steps of 4 ranks against
  the JAX model plus JAX ZeRO on 4 devices, at
  tests/test_torch_transformer.py's float32 tolerance (rtol 1e-4).
"""

import os
import socket
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu.ops import ring as jring
from torchmpi_tpu.parallel import zero as jzero
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import selector as tsel
from torchmpi_tpu_torch import fusion as tfusion
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import TransformerLM
from torchmpi_tpu_torch.parallel import zero as tzero

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
AXES = ("dp",)
# 8,761 float32 elements, not a multiple of 4: the group pads to 8,764, a
# ring chunk of 2,191.  chunk_bytes 4096 plans C = 3 (rows 9 and 10),
# 4 MiB the resident rows 13 and 14.
SHAPES = [(96, 80), (80,), (1001,)]
CHUNKS = {"chunked": 4096, "resident": 4 << 20}


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """One JAX runtime (flat 1 x 8 mesh) and one port runtime (CPU, gloo,
    world of one) for the module, whatever an earlier file in the worker
    left running; the JAX ring in interpret mode."""
    if not hasattr(pltpu, "InterpretParams"):
        pytest.skip("pallas TPU interpreter unavailable on this jax")
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    tmpi.init(device="cpu")
    jring.set_interpret(pltpu.InterpretParams())
    yield
    jring.set_interpret(None)
    tmpi.stop()
    jmpi.stop()


def configure(**kw):
    jmpi.set_config(**kw)
    tmpi.set_config(**kw)


def mesh4():
    return Mesh(np.array(jax.devices()[:N]), AXES)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _grads(seed):
    """Distinct per-rank gradients, [N, *shape] each."""
    rng = np.random.RandomState(seed)
    return [rng.randn(N, *s).astype(np.float32) for s in SHAPES]


def _txs(name):
    if name == "sgd_momentum":
        return optax.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    return optax.adam(1e-2), toptim.adam(1e-2)


def _state_leaves(state):
    """The port state's shard tensors ([N, shard] each)."""
    return [s for s in state if isinstance(s, torch.Tensor)]


def _jax_state_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)
            if np.ndim(x) >= 1]


def _put(arrs, mesh):
    return [jax.device_put(a, NamedSharding(mesh, P(AXES))) for a in arrs]


def _no_coarsening():
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.simplefilter("error", jring.RingInterpretCoarseningWarning)
    return ctx


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("tx_name", ["sgd_momentum", "adam"])
def test_zero1_rank_major_matches_jax(tx_name, chunks):
    configure(chunk_bytes=CHUNKS[chunks])
    jtx, ttx = _txs(tx_name)
    mesh = mesh4()
    params = _params()
    spec = tzero.flat_spec([torch.from_numpy(p) for p in params],
                           n_shards=N)
    assert spec.padded == 8764 and spec.shard == 2191

    def body(p, s, g):
        g_shard, _, _ = jzero._reduce_scatter_grads(
            g, AXES, spec=None, params=p, op="mean", backend="pallas",
            compress=None)
        new_p, new_s = jzero.update(p, g, s, jtx, AXES, backend="pallas")
        return g_shard, new_p, new_s

    j_state = jzero.init(params, jtx, AXES, mesh=mesh)
    sspecs = jzero.specs_like(j_state, AXES)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), sspecs, P(AXES)),
                           out_specs=(P(AXES), P(), sspecs),
                           check_vma=False))
    t_params = [torch.from_numpy(p.copy()) for p in params]
    t_state = tzero.init_rank_major(t_params, ttx, N)
    for step, seed in enumerate((1, 7)):
        grads = _grads(seed)
        ctx = _no_coarsening()
        try:
            j_shard, j_new, j_state = fn(params, j_state, _put(grads, mesh))
        finally:
            ctx.__exit__(None, None, None)
        flats = tfusion.group_flats([torch.from_numpy(g) for g in grads],
                                    spec)
        t_shard = tzero._rank_major_shard_grads(flats, spec, "mean", None,
                                                "pallas")
        np.testing.assert_array_equal(
            t_shard.numpy(), np.asarray(j_shard).reshape(N, -1),
            err_msg=f"gradient shards, step {step}")
        t_params, t_state = tzero.update_rank_major(
            t_params, flats, t_state, ttx, backend="pallas")
        params = [np.asarray(p) for p in j_new]
        for got, want in zip(t_params, params):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                                       atol=2e-6)
        for got, want in zip(_state_leaves(t_state),
                             _jax_state_leaves(j_state)):
            np.testing.assert_allclose(got.numpy(), want.reshape(N, -1),
                                       rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("tx_name", ["sgd_momentum", "adam"])
def test_zero3_rank_major_matches_jax(tx_name, chunks):
    configure(chunk_bytes=CHUNKS[chunks])
    jtx, ttx = _txs(tx_name)
    mesh = mesh4()
    params = _params(3)
    j_spec = jzero.flat_spec(params, AXES, mesh=mesh)
    j_shard = jzero.shard_params(params, AXES, mesh=mesh)
    j_state = jzero.init(params, jtx, AXES, mesh=mesh)

    def body(ps, s, g):
        full = jzero.gather_params(ps, j_spec, AXES, backend="pallas")
        new_ps, new_s = jzero.update3(ps, g, s, jtx, AXES, spec=j_spec,
                                      backend="pallas")
        return full, new_ps, new_s

    sspecs = jzero.specs_like(j_state, AXES)
    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P(AXES), sspecs, P(AXES)),
                           out_specs=(P(), P(AXES), sspecs),
                           check_vma=False))
    t_params = [torch.from_numpy(p) for p in params]
    spec = tzero.flat_spec(t_params, n_shards=N)
    t_shards = tzero.shard_params_rank_major(t_params, N)
    np.testing.assert_array_equal(t_shards.numpy(),
                                  np.asarray(j_shard).reshape(N, -1))
    t_state = tzero.init_rank_major(t_params, ttx, N)
    for step, seed in enumerate((2, 9)):
        grads = _grads(seed)
        ctx = _no_coarsening()
        try:
            j_full, j_shard, j_state = fn(j_shard, j_state,
                                          _put(grads, mesh))
        finally:
            ctx.__exit__(None, None, None)
        full = tzero.gather_params_rank_major(t_shards, spec,
                                              backend="pallas")
        # The first gather is of the same shards (bitwise); the second of
        # shards each side's optimizer updated (within 2e-6).
        for got, want in zip(full, j_full):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-6 if step else 0,
                                       atol=2e-6 if step else 0,
                                       err_msg=f"gathered, step {step}")
        flats = tfusion.group_flats([torch.from_numpy(g) for g in grads],
                                    spec)
        # ZeRO-1 from the same parameters, state and gradients: the same
        # shards, bitwise.
        z1_params, z1_state = tzero.update_rank_major(
            full, flats, t_state, ttx, backend="pallas")
        t_shards, t_state = tzero.update3_rank_major(
            t_shards, flats, t_state, ttx, spec=spec, backend="pallas")
        assert torch.equal(tfusion.local_shards(z1_params, spec), t_shards)
        for a, b in zip(_state_leaves(z1_state), _state_leaves(t_state)):
            assert torch.equal(a, b)
        np.testing.assert_allclose(t_shards.numpy(),
                                   np.asarray(j_shard).reshape(N, -1),
                                   rtol=2e-6, atol=2e-6)
        for got, want in zip(_state_leaves(t_state),
                             _jax_state_leaves(j_state)):
            np.testing.assert_allclose(got.numpy(), want.reshape(N, -1),
                                       rtol=2e-6, atol=2e-6)
    for got, want in zip(tzero.unshard_params_rank_major(t_shards, t_params),
                         jzero.unshard_params(j_shard, params, AXES,
                                              mesh=mesh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=2e-6)


def test_bf16_compress_close_to_oracle():
    """compress="bf16" narrows the gradient reduce-scatter; the result
    tracks the float32 single-device oracle within the JAX package's
    tolerance for it (rtol 2e-2, atol 2e-3), and the port's reduce-scatter
    leg is the JAX one bitwise."""
    configure(chunk_bytes=4 << 20)
    params = [torch.from_numpy(p) for p in _params()]
    grads = _grads(1)
    spec = tzero.flat_spec(params, n_shards=N)
    flats = tfusion.group_flats([torch.from_numpy(g) for g in grads], spec)
    tx = toptim.sgd(0.1)
    new, _ = tzero.update_rank_major(params, flats,
                                     tzero.init_rank_major(params, tx, N),
                                     tx, backend="pallas", compress="bf16")
    oracle = optax.sgd(0.1)
    g_mean = [g.mean(0) for g in grads]
    o_upd, _ = oracle.update(g_mean, oracle.init(_params()), _params())
    for got, want in zip(new, optax.apply_updates(_params(), o_upd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                   atol=2e-3)

    mesh = mesh4()

    def body(p, g):
        return jzero._reduce_scatter_grads(
            g, AXES, spec=None, params=p, op="mean", backend="pallas",
            compress="bf16")[0]

    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(AXES)),
                             out_specs=P(AXES), check_vma=False))(
        _params(), _put(grads, mesh))
    got = tzero._rank_major_shard_grads(flats, spec, "mean", "bf16",
                                        "pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(N,
                                                                        -1))
    with pytest.raises(ValueError, match="compression"):
        tzero.update_rank_major(params, flats,
                                tzero.init_rank_major(params, tx, N), tx,
                                compress="int8")
    with pytest.raises(ValueError, match="mean|sum"):
        tzero.update_rank_major(params, flats,
                                tzero.init_rank_major(params, tx, N), tx,
                                op="max")


# One rank of the 2-process ZeRO run: rank r's gradients are seeded by r.
WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.parallel import zero

    rank, port, out, shapes = {args}
    mpi.init(device="cpu", init_method=f"tcp://localhost:{{port}}",
             rank=rank, world_size=2)
    rng = np.random.RandomState(0)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in shapes]
    grads = [torch.from_numpy(np.random.RandomState(10 + rank).randn(*s)
                              .astype(np.float32)) for s in shapes]
    tx = optim.adam(1e-2)
    new1, state1 = zero.update(params, grads, zero.init(params, tx), tx)
    spec = zero.flat_spec(params)
    shard3, state3 = zero.update3(zero.shard_params(params), grads,
                                  zero.init(params, tx), tx, spec=spec)
    new3 = zero.unshard_params(shard3, params)
    same = all(torch.equal(a, b) for a, b in zip(new1, new3))
    same = same and torch.equal(state1.mu, state3.mu)
    rs = mpi.reduce_scatter(torch.arange(4.0) + rank).tolist()
    ag = mpi.allgather(torch.tensor([rank, 10.0 * rank])).tolist()
    try:
        mpi.reduce_scatter(torch.ones(4), backend="pallas")
        raised = "NO RAISE"
    except NotImplementedError as e:
        raised = "queue B" in str(e)
    if rank == 0:
        np.savez(out, same=same, rs=rs, ag=ag, raised=raised,
                 **{{f"p{{i}}": p.numpy() for i, p in enumerate(new1)}})
    mpi.barrier()
    mpi.stop()
""")


def test_two_gloo_processes_zero_equals_single_rank_adam(tmp_path):
    out = str(tmp_path / "rank0.npz")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(
            repo=REPO, args=(r, port, out, SHAPES))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = np.load(out)
    assert bool(got["same"])  # ZeRO-3 == ZeRO-1, bitwise
    assert got["rs"].tolist() == [1.0, 3.0]  # tile 0 of (0..3) + (1..4)
    assert got["ag"].tolist() == [[0.0, 0.0], [1.0, 10.0]]
    assert bool(got["raised"])
    # The single-rank Adam step on the mean of both ranks' gradients.
    tx = toptim.adam(1e-2)
    flat = torch.cat([torch.from_numpy(p).reshape(-1) for p in _params()])
    g = torch.cat([torch.from_numpy(
        (np.random.RandomState(10).randn(*s).astype(np.float32)
         + np.random.RandomState(11).randn(*s).astype(np.float32)) / 2)
        .reshape(-1) for s in SHAPES])
    upd, _ = tx.update(g, tx.init(flat))
    want = toptim.apply_updates(flat, upd)
    off = 0
    for i, s in enumerate(SHAPES):
        size = int(np.prod(s))
        np.testing.assert_allclose(got[f"p{i}"],
                                   want[off:off + size].reshape(s).numpy(),
                                   rtol=1e-6, atol=1e-7)
        off += size


LM_CFG = dict(vocab=64, embed=32, depth=2, num_heads=4, head_dim=8,
              num_kv_heads=2, max_len=16, window=8, pos_emb="rope")
LM_LR = 1e-3


def _jax_lm_step(jlm, tx, mesh, backend):
    """One JAX ZeRO-1 step of the LM, each device its own sequence."""

    def body(p, s, tok):
        def loss_fn(p):
            logits = jlm.apply({"params": p}, tok).astype(jnp.float32)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], tok[:, 1:]).mean()

        loss, g = jax.value_and_grad(loss_fn)(p)
        new_p, new_s = jzero.update(p, g, s, tx, AXES, backend=backend)
        return new_p, new_s, loss[None], g

    return body


def _port_rank_grads(model, tok, views):
    """Each rank's loss and gradients (rank r takes sequence r), written
    into its row of the rank-major gradient views."""
    losses = []
    for r in range(N):
        model.zero_grad(set_to_none=True)
        logits = model(tok[r:r + 1])
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, LM_CFG["vocab"]),
            tok[r:r + 1, 1:].reshape(-1))
        loss.backward()
        losses.append(float(loss.detach()))
        for v, p in zip(views, model.parameters()):
            v[r].copy_(p.grad)
    return losses


def test_zero_state_converter_continues_the_jax_run():
    """One JAX ZeRO-1 Adam step on a flax LM, its shards and state turned
    into the port's by weights.from_flax_zero_shards /
    from_optax_zero_state, then one more step on each side from the same
    per-rank gradients: the parameters agree."""
    configure(chunk_bytes=4 << 20)
    mesh = mesh4()
    tok = np.random.RandomState(4).randint(
        0, LM_CFG["vocab"], size=(N, 16)).astype(np.int32)
    jlm = JaxLM(**LM_CFG, attn_impl="local")
    params = jax.jit(jlm.init)(jax.random.PRNGKey(1),
                               jnp.asarray(tok[:1]))["params"]
    jtx, ttx = optax.adam(LM_LR), toptim.adam(LM_LR)
    state = jzero.init(params, jtx, AXES, mesh=mesh)
    sspecs = jzero.specs_like(state, AXES)
    step = jax.jit(shard_map(_jax_lm_step(jlm, jtx, mesh, "xla"), mesh=mesh,
                             in_specs=(P(), sspecs, P(AXES)),
                             out_specs=(P(), sspecs, P(AXES), P(AXES)),
                             check_vma=False))
    tok_j = jax.device_put(jnp.asarray(tok), NamedSharding(mesh, P(AXES)))
    params, state, _, _ = step(params, state, tok_j)

    model = TransformerLM(**LM_CFG, attn_impl="flash", device="cpu")
    host = jax.tree.map(np.asarray, params)
    model.load_state_dict(tweights.from_flax_params(host, model))
    t_params = [p.detach().clone() for p in model.parameters()]
    spec = tzero.flat_spec(t_params, n_shards=N)
    t_state = tweights.from_optax_zero_state(
        jax.tree.map(np.asarray, state), host, model, N)
    assert t_state.count == 1
    # The shard converter on the parameters themselves: the port's own
    # shards of the loaded model.
    j_shards = jzero.shard_params(params, AXES, mesh=mesh)
    assert torch.equal(
        tweights.from_flax_zero_shards(np.asarray(j_shards), host, model, N),
        tfusion.local_shards(t_params, spec))

    flats, views = tfusion.rank_major_buffers(spec, N, device="cpu")
    _port_rank_grads(model, torch.from_numpy(tok).long(), views)
    t_new, _ = tzero.update_rank_major(t_params, flats, t_state, ttx,
                                       backend="xla")
    j_new, _, _, _ = step(params, state, tok_j)
    want = tweights.from_flax_params(jax.tree.map(np.asarray, j_new), model)
    for (name, _), got in zip(model.named_parameters(), t_new):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_small_lm_zero1_slice_matches_jax():
    """The slice end to end: the port's LM loaded from the JAX init, 2
    rank-major ZeRO-1 Adam steps of 4 ranks (backend "pallas", one
    sequence a rank) against the JAX LM under JAX ZeRO-1 (backend "pallas")
    on 4 devices: losses and final parameters at float32 rtol 1e-4."""
    configure(chunk_bytes=4 << 20)
    mesh = mesh4()
    tok = np.random.RandomState(6).randint(
        0, LM_CFG["vocab"], size=(N, 16)).astype(np.int32)
    jlm = JaxLM(**LM_CFG, attn_impl="local")
    params = jax.jit(jlm.init)(jax.random.PRNGKey(2),
                               jnp.asarray(tok[:1]))["params"]
    jtx, ttx = optax.adam(LM_LR), toptim.adam(LM_LR)

    model = TransformerLM(**LM_CFG, attn_impl="flash", device="cpu")
    model.load_state_dict(tweights.from_flax_params(
        jax.tree.map(np.asarray, params), model))
    t_params = [p.detach() for p in model.parameters()]
    spec = tzero.flat_spec(t_params, n_shards=N)
    t_state = tzero.init_rank_major(t_params, ttx, N)
    flats, views = tfusion.rank_major_buffers(spec, N, device="cpu")

    state = jzero.init(params, jtx, AXES, mesh=mesh)
    sspecs = jzero.specs_like(state, AXES)
    step = jax.jit(shard_map(_jax_lm_step(jlm, jtx, mesh, "pallas"),
                             mesh=mesh, in_specs=(P(), sspecs, P(AXES)),
                             out_specs=(P(), sspecs, P(AXES), P(AXES)),
                             check_vma=False))
    tok_j = jax.device_put(jnp.asarray(tok), NamedSharding(mesh, P(AXES)))
    tok_t = torch.from_numpy(tok).long()
    for _ in range(2):
        ctx = _no_coarsening()
        try:
            params, state, j_loss, _ = step(params, state, tok_j)
        finally:
            ctx.__exit__(None, None, None)
        t_loss = _port_rank_grads(model, tok_t, views)
        np.testing.assert_allclose(t_loss, np.asarray(j_loss), rtol=1e-4)
        new, t_state = tzero.update_rank_major(t_params, flats, t_state, ttx,
                                               backend="pallas")
        with torch.no_grad():
            for p, v in zip(t_params, new):
                p.copy_(v)
    want = tweights.from_flax_params(jax.tree.map(np.asarray, params), model)
    for name, val in model.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_presynced_update_slices_the_synced_gradients():
    """``presynced=True`` (the overlap schedule's form) on gradients that
    are already the mean over ranks equals the reduce-scatter update on
    the raw ones, bitwise (the stock route's rank-axis fold either way),
    for ZeRO-1 and ZeRO-3; the process world of one likewise (the module's
    runtime)."""
    params = [torch.from_numpy(p) for p in _params()]
    tx = toptim.adam(1e-3)
    n = 2
    spec = tzero.flat_spec(params, n_shards=n)
    rng = np.random.RandomState(5)
    raw = [torch.from_numpy(rng.randn(n, *p.shape).astype(np.float32))
           for p in params]
    synced = [((r[0] + r[1]) / n).expand_as(r).contiguous() for r in raw]
    flats = tfusion.group_flats(raw, spec)
    flats_synced = tfusion.group_flats(synced, spec)
    state = tzero.init_rank_major(params, tx, n)
    p_a, s_a = tzero.update_rank_major(params, flats, state, tx)
    p_b, s_b = tzero.update_rank_major(params, flats_synced, state, tx,
                                       presynced=True)
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
    assert torch.equal(s_a.mu, s_b.mu) and torch.equal(s_a.nu, s_b.nu)
    shards = tzero.shard_params_rank_major(params, n)
    q_a, _ = tzero.update3_rank_major(shards, flats, state, tx, spec=spec)
    q_b, _ = tzero.update3_rank_major(shards, flats_synced, state, tx,
                                      spec=spec, presynced=True)
    assert torch.equal(q_a, q_b)
    one = [s[0] for s in synced]
    state1 = tzero.init(params, tx)
    p_c, _ = tzero.update(params, one, state1, tx)
    p_d, _ = tzero.update(params, one, state1, tx, presynced=True)
    assert all(torch.equal(a, b) for a, b in zip(p_c, p_d))
    spec1 = tzero.flat_spec(params)
    shard1 = tzero.shard_params(params)
    r_c, _ = tzero.update3(shard1, one, state1, tx, spec=spec1)
    r_d, _ = tzero.update3(shard1, one, state1, tx, spec=spec1,
                           presynced=True)
    assert torch.equal(r_c, r_d)


def test_unported_options_are_refused():
    """The options once refused run now: ``dcn_residuals`` in this world of
    one process (a flat grid) is the plain leg, warned once, the residuals
    handed back; ``flat_spec`` over one axis shards over that axis (one
    rank here).  A name that is no axis of the world raises ValueError
    naming its axes, and residuals without a codec by the JAX message."""
    params = [torch.from_numpy(p) for p in _params()]
    tx = toptim.sgd(0.1)
    spec = tzero.flat_spec(params)
    shard = tzero.shard_params(params)
    res = tzero.init_dcn_residuals(params)
    tsel._warned_fallbacks.clear()
    with pytest.warns(RuntimeWarning, match="flat world"):
        got = tzero.update3(shard, params, tx.init(shard), tx, spec=spec,
                            dcn_residuals=res, dcn_compress="int8")
    plain = tzero.update3(shard, params, tx.init(shard), tx, spec=spec)
    assert len(got) == 3 and got[2] is res
    assert torch.equal(got[0], plain[0])
    with pytest.raises(ValueError, match="no DCN codec active"):
        tzero.update3(shard, params, None, tx, spec=spec, dcn_residuals=res)
    assert tzero.flat_spec(params, "ici").n_shards == 1
    assert torch.equal(tzero.shard_params(params, "dcn"), shard)
    with pytest.raises(ValueError, match="unknown axis 'tp'"):
        tzero.flat_spec(params, "tp")


def test_flat_spec_over_a_mesh_shape_axis():
    """ZeRO over "tp" of ``mesh_shape={"tp": 1}``: one shard, the plain
    layout, in this world of one process."""
    params = [torch.from_numpy(p) for p in _params()]
    tmpi.stop()
    tmpi.init(tmpi.Config(mesh_shape={"tp": 1}), device="cpu")
    try:
        assert tzero.flat_spec(params, "tp").n_shards == 1
        assert torch.equal(tzero.shard_params(params, "tp"),
                           tzero.shard_params(params))
    finally:
        tmpi.stop()
        tmpi.init(device="cpu")


def test_rank_major_buffers_default_to_the_card():
    """The gradient stack lands on the card unless the caller asks for the
    CPU: without a card the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default succeeds")
    spec = tzero.flat_spec([torch.from_numpy(p) for p in _params()],
                           n_shards=N)
    with pytest.raises((RuntimeError, AssertionError)):
        tfusion.rank_major_buffers(spec, N)
    flats, views = tfusion.rank_major_buffers(spec, N, device="cpu")
    assert [f.shape for f in flats] == [(N, spec.padded)]
    assert [v.shape for v in views] == [(N, *s) for s in SHAPES]
