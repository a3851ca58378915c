"""The port's data-parallel layer (fusion, gradsync, nn) on the CPU.

- One ``data_parallel_step`` of a small TransformerLM equals the JAX
  package's step on its 8-device CPU mesh (same flax init, same batch, SGD):
  loss and updated parameters, float32, rtol 1e-4.
- The fused bucket layout equals the JAX package's ``FusedSpec`` and
  round-trips.
- A DP step on 2 gloo ranks (spawned processes) equals the single-rank
  step on the full batch.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import fusion as jfusion
from torchmpi_tpu.models import TransformerLM as JaxLM
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import fusion as tfusion
from torchmpi_tpu_torch.models import TransformerLM

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=64, embed=32, depth=1, num_heads=4, head_dim=8,
           num_kv_heads=2, max_len=16, window=8, pos_emb="rope")
LR = 0.1


def _lm_loss(model, tok):
    logits = model(tok)
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tok[:, 1:].reshape(-1))


@pytest.fixture
def port_runtime():
    tmpi.stop()
    tmpi.init(device="cpu")
    yield
    tmpi.stop()


def test_data_parallel_step_matches_jax(flat_runtime, port_runtime):
    mesh = flat_runtime
    n = mesh.devices.size
    tok = np.random.RandomState(8).randint(
        0, CFG["vocab"], size=(n, 16)).astype(np.int32)
    jlm = JaxLM(**CFG, attn_impl="local")
    params = jax.jit(jlm.init)(jax.random.PRNGKey(2),
                               jnp.asarray(tok[:1]))["params"]
    host_params = jax.tree.map(np.array, params)
    tx = optax.sgd(LR)

    def step(p, o, tok):
        def loss_fn(p):
            logits = jlm.apply({"params": p}, tok).astype(jnp.float32)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], tok[:, 1:]).mean()

        loss, g = jax.value_and_grad(loss_fn)(p)
        g = jmpi.nn.synchronize_gradients(g, mesh.axis_names)
        loss = jmpi.collectives.allreduce_in_axis(loss, mesh.axis_names,
                                                  op="mean")
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    jstep = jmpi.nn.data_parallel_step(step, mesh=mesh, batch_argnums=(2,))
    p = jmpi.nn.synchronize_parameters(params, mesh=mesh)
    o = jmpi.nn.synchronize_parameters(tx.init(params), mesh=mesh)
    new_p, _, loss_j = jstep(p, o, jnp.asarray(tok))

    model = TransformerLM(**CFG, attn_impl="flash", device="cpu")
    model.load_state_dict(tmpi.weights.from_flax_params(host_params, model))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    tstep = tmpi.nn.data_parallel_step(model, opt, _lm_loss)
    loss_t = tstep(torch.from_numpy(tok).long())

    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    want = tmpi.weights.from_flax_params(jax.tree.map(np.array, new_p),
                                         model)
    for name, val in model.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _mixed_tensors():
    rng = np.random.RandomState(4)
    shapes = [(3, 5), (7,), (2, 2, 2), (11,), (1,), (4, 3)]
    dtypes = [np.float32, np.float32, np.float16, np.float32, np.int32,
              np.float16]
    return [(rng.randn(*s) * 10).astype(d) for s, d in zip(shapes, dtypes)]


@pytest.mark.parametrize("max_bytes", [0, 16, 40, 10_000])
def test_fused_layout_matches_jax_and_round_trips(max_bytes):
    arrays = _mixed_tensors()
    spec_j = jfusion.FusedSpec([jnp.asarray(a) for a in arrays],
                               max_bytes=max_bytes)
    tensors = [torch.from_numpy(a) for a in arrays]
    spec_t = tfusion.FusedSpec(tensors, max_bytes=max_bytes)
    assert spec_t.n_launches == spec_j.n_launches
    for gt, gj in zip(spec_t.groups, spec_j.groups, strict=True):
        assert str(gt.dtype).split(".")[-1] == np.dtype(gj.dtype).name
        assert gt.indices == gj.indices and gt.total == gj.total
        assert gt.bounds == gj.bounds
        assert gt.nbytes == gj.nbytes
    # Gather every bucket, scatter it into zeroed tensors: the original.
    out = [torch.zeros_like(t) for t in tensors]
    for g in spec_t.groups:
        for lo, hi in g.bounds:
            buf = tfusion.gather_bucket(tensors, g, lo, hi)
            assert buf.numel() == hi - lo and buf.dtype == g.dtype
            tfusion.scatter_bucket(buf, out, g, lo)
    for a, b in zip(out, tensors):
        assert torch.equal(a, b)


def test_fused_collectives_on_one_rank(port_runtime):
    tensors = [torch.from_numpy(a.copy()) for a in _mixed_tensors()
               if a.dtype != np.int32]
    before = [t.clone() for t in tensors]
    spec = tfusion.FusedSpec(tensors, max_bytes=24)
    assert tfusion.fused_("allreduce", tensors, spec=spec,
                          op="mean") == spec.n_launches > len(spec.groups)
    tfusion.fused_("broadcast", tensors, root=0)
    for a, b in zip(tensors, before):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tfusion.fused_("allreduce", [torch.zeros(4, 4).t()], op="sum")


# One rank of the 2-process DP run.  Rank 1 starts from other weights, so
# the run also shows that data_parallel_step broadcasts rank 0's first.
WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.models import TransformerLM

    rank, world, port, out, cfg, lr, steps = {args}
    mpi.init(device="cpu", init_method=f"tcp://localhost:{{port}}",
             rank=rank, world_size=world)
    tok = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg["vocab"], size=(4, 16))).long()
    shard = tok.shape[0] // world
    gen = torch.Generator().manual_seed(3 + rank)
    model = TransformerLM(**cfg, attn_impl="flash", device="cpu",
                          generator=gen)
    opt = torch.optim.SGD(model.parameters(), lr=lr)

    def loss_fn(m, t):
        logits = m(t)
        return torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            t[:, 1:].reshape(-1))

    step = mpi.nn.data_parallel_step(model, opt, loss_fn)
    losses = [float(step(tok[rank * shard:(rank + 1) * shard]))
              for _ in range(steps)]
    summed = mpi.allreduce(torch.tensor([float(rank + 1)]))
    bcast = mpi.broadcast(torch.tensor([float(rank + 5)]), root=1)
    if rank == 0:
        np.savez(out, losses=np.array(losses), summed=summed.numpy(),
                 bcast=bcast.numpy(),
                 **{{k: v.numpy() for k, v in model.state_dict().items()}})
    mpi.barrier()
    mpi.stop()
""")


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp2") / "rank0.npz")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(
            repo=REPO, args=(r, 2, port, out, CFG, LR, 2))],
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
    return dict(np.load(out))


def test_two_gloo_ranks_equal_one_rank_on_the_full_batch(two_rank_run,
                                                         port_runtime):
    tok = torch.from_numpy(np.random.RandomState(8).randint(
        0, CFG["vocab"], size=(4, 16))).long()
    model = TransformerLM(**CFG, attn_impl="flash", device="cpu",
                          generator=torch.Generator().manual_seed(3))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    step = tmpi.nn.data_parallel_step(model, opt, _lm_loss)
    losses = [float(step(tok)) for _ in range(2)]
    np.testing.assert_allclose(two_rank_run["losses"], losses, rtol=1e-5)
    for name, val in model.state_dict().items():
        np.testing.assert_allclose(two_rank_run[name], val.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert two_rank_run["summed"].tolist() == [3.0]
    assert two_rank_run["bcast"].tolist() == [6.0]
