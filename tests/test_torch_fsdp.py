"""The port's FSDP recipe (torchmpi_tpu_torch/recipes.py ``fsdp_specs``,
``make_fsdp_train_step``, ``make_fsdp_train_step_rank_major``) against the
JAX package's ``recipes.fsdp_specs`` / ``make_fsdp_train_step`` on the CPU.

- ``fsdp_specs`` on the JAX test's own shape dict
  (``tests/test_zero.py:391``) at n = 8 and n = 4, equal to JAX's specs
  read as dims (the rule is shape-only).
- LeNet rank-major, 4 ranks, backend "pallas" (the plain ring on CPU
  tensors), SGD momentum 0.9, 2 steps: against JAX's FSDP step on a
  4-device sub-mesh and against the full-batch single-device oracle, the
  loss within rtol 1e-5 and the gathered parameters within 3e-5
  (``test_fsdp_recipe_matches_single_device_oracle``'s tolerances); the
  parameters and the momentum sharded at init and after the steps.
  Torch's layout is not flax's (a Dense weight is [out, in]), so the
  shards differ and the full parameters are compared.
- The narrow TransformerLM of ``test_fsdp_lm_custom_loss_matches_oracle``
  with a next-token ``loss_fn``, loaded with ``weights.from_flax_params``,
  2 steps against JAX's FSDP step: the loss within rtol 1e-5, the
  parameters at tests/test_torch_transformer.py's float32 tolerance (rtol
  1e-4).
- ``donate`` True and False give the same result; True updates the shard
  tensors in place.
- 2 gloo processes (``make_fsdp_train_step``) against the rank-major step
  of 2 ranks, within 1e-6.
- The memory ladder at n = 8 with Adam (``tests/test_bench_contract.py``
  :75): FSDP's persistent bytes a rank are 1/8 of replicated within 0.03.
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu import recipes as jrecipes
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.models import TransformerLM as JaxLM
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import recipes
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import LeNet, TransformerLM
from torchmpi_tpu_torch.utils import data as tdata

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
AXES = ("dp",)
LR, MOMENTUM = 0.1, 0.9


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """One JAX runtime (flat 1 x 8 mesh) and one port runtime (CPU, gloo,
    world of one) for the module."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    tmpi.init(device="cpu")
    yield
    tmpi.stop()
    jmpi.stop()


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), AXES)


def _jax_dims(specs):
    """JAX PartitionSpecs read as the sharded dim (None: replicated)."""
    def dim(spec):
        hit = [i for i, e in enumerate(spec) if e is not None]
        return hit[0] if hit else None
    return jax.tree.map(dim, specs, is_leaf=lambda s: isinstance(s, P))


@pytest.mark.parametrize("n", [8, 4])
def test_fsdp_specs_match_jax(n):
    shapes = {"kernel": (48, 16), "bias": (10,), "deep": (4, 4, 64),
              "tie": (8, 8)}
    jparams = {k: jnp.zeros(s) for k, s in shapes.items()}
    tparams = {k: torch.zeros(s) for k, s in shapes.items()}
    want = _jax_dims(jrecipes.fsdp_specs(jparams, mesh=_mesh(n)))
    got = recipes.fsdp_specs(tparams, n)
    assert got == want
    assert got == {"kernel": 0, "bias": None, "deep": 2, "tie": 0}


def _lenet_pair():
    jm = JLeNet(num_classes=10)
    jparams = jm.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 28, 28, 1)))["params"]
    model = LeNet(device="cpu")
    model.load_state_dict(tweights.from_flax_cnn(
        {"params": jax.tree.map(np.asarray, jparams)}, model))
    return jm, jparams, model


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _assert_params(model, got, want_tree, convert, rtol, atol):
    want = convert(jax.tree.map(np.asarray, want_tree), model)
    for (name, _), g in zip(model.named_parameters(), got, strict=True):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def _sharded(leaves, dims, n):
    """How many tensors of ``leaves`` hold a rank-major stack of shards."""
    return sum(1 for t, d in zip(leaves, dims) if d is not None
               and t.shape[0] == n)


def test_lenet_rank_major_matches_jax_and_the_oracle():
    jm, jparams, model = _lenet_pair()
    X, Y = tdata.synthetic_mnist(32, seed=0)
    xb, yb = X[:16], Y[:16]
    jtx = optax.sgd(LR, momentum=MOMENTUM)
    mesh = _mesh(N)
    jstep, jp, jo = jrecipes.make_fsdp_train_step(jm, jtx, jparams,
                                                  mesh=mesh, donate=False)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(AXES)))  # noqa
    jlosses = []
    for _ in range(2):
        jp, jo, jl = jstep(jp, jo, put(xb), put(yb))
        jlosses.append(float(jl))

    ttx = toptim.sgd(LR, momentum=MOMENTUM)
    full = [p.detach().clone() for p in model.parameters()]
    step, params, opt = recipes.make_fsdp_train_step_rank_major(
        model, ttx, full, N, backend="pallas")
    dims = step.dims
    assert _sharded(params, dims, N) == 7 and dims[-1] is None
    assert _sharded([s.trace for s in opt], dims, N) == 7
    x, y = _nchw(xb), torch.from_numpy(yb).long()
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
    assert _sharded(params, dims, N) == 7
    assert _sharded([s.trace for s in opt], dims, N) == 7
    got = recipes.fsdp_unshard_rank_major(params, dims)

    # The full-batch single-device oracle, on the port's own model.
    names = [nm for nm, _ in model.named_parameters()]
    ps, st = full, [ttx.init(p) for p in full]
    olosses = []
    for _ in range(2):
        leaves = [p.detach().requires_grad_() for p in ps]
        logits = torch.func.functional_call(model, dict(zip(names, leaves)),
                                            (x,))
        ol = torch.nn.functional.cross_entropy(logits, y)
        out = [ttx.update(g, s, p) for g, s, p in
               zip(torch.autograd.grad(ol, leaves), st, ps)]
        ps = [toptim.apply_updates(p, u) for p, (u, _) in zip(ps, out)]
        st = [s for _, s in out]
        olosses.append(float(ol.detach()))
    np.testing.assert_allclose(losses, olosses, rtol=1e-5, atol=1e-5)
    for nm, g, o in zip(names, got, ps):
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=3e-5,
                                   atol=3e-5, err_msg=nm)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    _assert_params(model, got, {"params": jp},
                   lambda t, m: tweights.from_flax_cnn(t, m), 3e-5, 3e-5)


LM_CFG = dict(vocab=64, embed=32, depth=2, num_heads=4, head_dim=8,
              max_len=32)


def _lm_loss_jax(apply_fn, p, xb, yb):
    logits = apply_fn({"params": p}, xb)
    return optax.softmax_cross_entropy_with_integer_labels(logits, yb).mean()


def _lm_loss(apply_fn, params, xb, yb):
    logits = apply_fn(params, xb)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), yb.reshape(-1))


def test_narrow_lm_custom_loss_matches_jax():
    tok = np.random.RandomState(0).randint(0, 64, (8, 16)).astype(np.int32)
    jlm = JaxLM(**LM_CFG)
    jparams = jax.jit(jlm.init)(jax.random.PRNGKey(0),
                                jnp.asarray(tok))["params"]
    jtx = optax.sgd(LR, momentum=MOMENTUM)
    mesh = _mesh(N)
    jstep, jp, jo = jrecipes.make_fsdp_train_step(
        jlm, jtx, jparams, mesh=mesh, donate=False, loss_fn=_lm_loss_jax)
    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   NamedSharding(mesh, P(AXES)))
    model = TransformerLM(**LM_CFG, device="cpu")
    model.load_state_dict(tweights.from_flax_params(
        jax.tree.map(np.asarray, jparams), model))
    step, params, opt = recipes.make_fsdp_train_step_rank_major(
        model, toptim.sgd(LR, momentum=MOMENTUM),
        [p.detach() for p in model.parameters()], N, backend="pallas",
        loss_fn=_lm_loss)
    x = torch.from_numpy(tok[:, :-1]).long()
    y = torch.from_numpy(tok[:, 1:]).long()
    for _ in range(2):
        jp, jo, jl = jstep(jp, jo, put(tok[:, :-1]), put(tok[:, 1:]))
        params, opt, loss = step(params, opt, x, y)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5,
                                   atol=1e-5)
    _assert_params(model, recipes.fsdp_unshard_rank_major(params, step.dims),
                   jp, tweights.from_flax_params, 1e-4, 1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_donate_and_remat_keep_the_result(remat):
    """``donate=False`` returns new tensors, ``donate=True`` (the default)
    writes the same values into the input shards and state; ``remat``
    recomputes the forward and changes nothing."""
    _, _, model = _lenet_pair()
    full = [p.detach().clone() for p in model.parameters()]
    X, Y = tdata.synthetic_mnist(16, seed=2)
    x, y = _nchw(X), torch.from_numpy(Y).long()
    tx = toptim.adam(1e-3)
    step0, p0, s0 = recipes.make_fsdp_train_step_rank_major(
        model, tx, full, N, donate=False)
    p1, s1, l1 = step0(p0, s0, x, y)
    assert all(a is not b for a, b in zip(p0, p1))
    step1, q0, r0 = recipes.make_fsdp_train_step_rank_major(
        model, tx, full, N, remat=remat)
    q1, r1, m1 = step1(q0, r0, x, y)
    assert all(a is b for a, b in zip(q0, q1))
    assert all(a.mu is b.mu for a, b in zip(r0, r1))
    assert torch.equal(l1, m1)
    for a, b in zip(p1, q1):
        assert torch.equal(a, b)
    for a, b in zip(s1, r1):
        assert a.count == b.count == 1
        assert torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)


def test_world_of_one_equals_rank_major_of_one():
    """The process-world step in this process's world of one (gloo) equals
    the rank-major step of one rank, and neither writes into the full
    parameters it was built from."""
    _, _, model = _lenet_pair()
    full = [p.detach() for p in model.parameters()]
    before = [p.clone() for p in full]
    X, Y = tdata.synthetic_mnist(8, seed=5)
    x, y = _nchw(X), torch.from_numpy(Y).long()
    tx = toptim.adam(1e-3)
    wstep, wp, ws = recipes.make_fsdp_train_step(model, tx, full)
    rstep, rp, rs = recipes.make_fsdp_train_step_rank_major(model, tx, full,
                                                            1)
    for _ in range(2):
        wp, ws, wl = wstep(wp, ws, x, y)
        rp, rs, rl = rstep(rp, rs, x, y)
        assert torch.equal(wl, rl)
    for a, b in zip(recipes.fsdp_unshard(wp, wstep.dims),
                    recipes.fsdp_unshard_rank_major(rp, rstep.dims)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(full, before))


def test_indivisible_batch_and_unported_config_are_refused():
    _, _, model = _lenet_pair()
    full = [p.detach() for p in model.parameters()]
    step, p, s = recipes.make_fsdp_train_step_rank_major(
        model, toptim.sgd(0.1), full, N)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        step(p, s, torch.zeros(6, 1, 28, 28), torch.zeros(6).long())
    tmpi.set_config(obs="metrics")
    try:
        with pytest.raises(NotImplementedError, match="queue A, item 10"):
            recipes.make_fsdp_train_step(model, toptim.sgd(0.1), full)
    finally:
        tmpi.set_config(obs="off")


def test_memory_ladder_at_8_ranks_with_adam():
    """Persistent bytes a rank (parameters and Adam's two moments): FSDP
    against replicated 1/8 within 0.03 (the ladder's FSDP rung)."""
    _, _, model = _lenet_pair()
    full = [p.detach() for p in model.parameters()]
    n = 8
    step, params, opt = recipes.make_fsdp_train_step_rank_major(
        model, toptim.adam(1e-3), full, n)

    def rank_bytes(t, d):
        return t.numel() * t.element_size() // (n if d is not None else 1)

    fsdp = sum(rank_bytes(t, d) for d, p, s in zip(step.dims, params, opt)
               for t in (p, s.mu, s.nu))
    replicated = 3 * sum(p.numel() * p.element_size() for p in full)
    assert abs(fsdp / replicated - 1 / 8) < 0.03
    assert sum(d is None for d in step.dims) == 1  # the last bias, 10


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(script, n, timeout=120):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script.format(repo=REPO, rank=r, port=port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def _world_case():
    """LeNet from a seed and a global batch of 16, as the workers make
    them.  SGD, not Adam: the processes' convolutions run on another
    thread count, and Adam's first step divides a gradient near 0 by its
    own size."""
    model = LeNet(device="cpu", generator=torch.Generator().manual_seed(3))
    X, Y = tdata.synthetic_mnist(16, seed=4)
    return model, _nchw(X), torch.from_numpy(Y).long()


FSDP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import optim, recipes
    from torchmpi_tpu_torch.models import LeNet
    from torchmpi_tpu_torch.utils import data

    rank = {rank}
    mpi.init(device="cpu", init_method="tcp://localhost:{port}", rank=rank,
             world_size=2)
    # _world_case's model and batch.
    model = LeNet(device="cpu", generator=torch.Generator().manual_seed(3))
    X, Y = data.synthetic_mnist(16, seed=4)
    x = torch.from_numpy(X).permute(0, 3, 1, 2)
    y = torch.from_numpy(Y).long()
    step, p, s = recipes.make_fsdp_train_step(
        model, optim.sgd(0.1, momentum=0.9),
        [t.detach() for t in model.parameters()], backend="xla")
    losses = []
    for _ in range(2):
        p, s, loss = step(p, s, x[8 * rank:8 * rank + 8],
                          y[8 * rank:8 * rank + 8])
        losses.append(float(loss))
    full = recipes.fsdp_unshard(p, step.dims)
    if rank == 0:
        np.savez("{out}", losses=np.array(losses),
                 **{{f"p{{i}}": t.numpy() for i, t in enumerate(full)}})
    mpi.barrier()
    mpi.stop()
""")


def test_two_gloo_processes_equal_rank_major(tmp_path):
    out = str(tmp_path / "rank0.npz")
    _run_workers(FSDP_WORKER.replace("{out}", out), 2)
    got = np.load(out)
    model, x, y = _world_case()
    step, p, s = recipes.make_fsdp_train_step_rank_major(
        model, toptim.sgd(0.1, momentum=0.9),
        [t.detach() for t in model.parameters()], 2, backend="xla")
    losses = []
    for _ in range(2):
        p, s, loss = step(p, s, x, y)
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    for i, t in enumerate(recipes.fsdp_unshard_rank_major(p, step.dims)):
        np.testing.assert_allclose(got[f"p{i}"], t.numpy(), rtol=1e-6,
                                   atol=1e-6)
