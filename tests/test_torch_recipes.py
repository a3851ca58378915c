"""The port's BatchNorm data-parallel recipe (torchmpi_tpu_torch/recipes.py)
against the JAX package's ``recipes.make_bn_dp_train_step`` on the CPU.

- ``make_bn_dp_train_step_rank_major`` with n = 4 against JAX's recipe on a
  4-device sub-mesh, ResNet-20 at a global batch of 16 (4 images a rank),
  SGD with momentum, 2 steps, ``zero=0/1/3``, backend "xla", plus ``zero=0``
  with backend "pallas" (the port's plain ring on CPU tensors, JAX's ring
  in interpret mode): the losses, parameters, optimizer state and
  ``batch_stats``, at float32 tolerances (rtol 1e-4; the two sides sum
  convolutions in other orders).  BatchNorm makes every rank's statistics
  its own, so the equality is with JAX on the same number of devices, not
  with one rank on the whole batch.
- 2 gloo processes running the process-world recipe (``zero=0/1/3``)
  against the rank-major n = 2 run in this process.
- LeNet (no BatchNorm) through ``nn.data_parallel_step`` on 2 gloo ranks
  against 1 rank on the full batch.
- ``remat=True`` equal to ``remat=False``, with the running statistics
  updated once.
- ``overlap="auto"`` (ZeRO 0/1/3, both backends) and ``n_buckets=4``
  against JAX's recipe with the same options, and on the 2 gloo
  processes.
- Options that are not ported raise naming their ROADMAP item.
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
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

import torchmpi_tpu as jmpi
from torchmpi_tpu import recipes as jrecipes
from torchmpi_tpu.models import ResNet20 as JResNet20
from torchmpi_tpu.ops import ring as jring
from torchmpi_tpu.parallel import zero as jzero
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import recipes
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import LeNet, ResNet20, layers
from torchmpi_tpu_torch.parallel import zero as tzero

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
AXES = ("dp",)
LR, MOMENTUM = 0.1, 0.9


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """One JAX runtime (flat 1 x 8 mesh) and one port runtime (CPU, gloo,
    world of one) for the module; the JAX ring in interpret mode."""
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


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=n).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _by_name(model, params_tree, stats_tree):
    """A flax (params, batch_stats) pair as the port's state dict."""
    return tweights.from_flax_cnn(
        {"params": jax.tree.map(np.asarray, params_tree),
         "batch_stats": jax.tree.map(np.asarray, stats_tree)}, model)


def _assert_close(got, want, what, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("zero,backend,overlap,n_buckets", [
    (0, "xla", "off", None), (1, "xla", "off", None),
    (3, "xla", "off", None), (0, "pallas", "off", None),
    (0, "xla", "auto", None), (1, "xla", "auto", None),
    (3, "xla", "auto", None), (0, "pallas", "auto", None),
    (0, "xla", "off", 4)])
def test_rank_major_recipe_matches_jax(zero, backend, overlap, n_buckets):
    mesh = Mesh(np.array(jax.devices()[:N]), AXES)
    jm = JResNet20()
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    j_params, j_stats = v["params"], v["batch_stats"]
    jtx = optax.sgd(LR, momentum=MOMENTUM)
    j_step = jrecipes.make_bn_dp_train_step(
        jm, jtx, mesh=mesh, backend=backend, donate=False, zero=zero,
        params_template=j_params if zero == 3 else None, overlap=overlap,
        n_buckets=n_buckets)
    if zero == 0:
        jp, jo, js = jrecipes.replicate_bn_state(
            j_params, jtx.init(j_params), j_stats, mesh=mesh)
    else:
        jo = jzero.init(j_params, jtx, mesh=mesh)
        jp = (jzero.shard_params(j_params, mesh=mesh) if zero == 3
              else j_params)
        js = j_stats

    model = ResNet20(device="cpu")
    model.load_state_dict(tweights.from_flax_cnn(
        jax.tree.map(np.asarray, dict(v)), model))
    ttx = toptim.sgd(LR, momentum=MOMENTUM)
    params, stats = recipes.bn_state(model)
    template = [p.clone() for p in params]
    t_step = recipes.make_bn_dp_train_step_rank_major(
        model, ttx, N, backend=backend, zero=zero,
        params_template=template if zero == 3 else None, overlap=overlap,
        n_buckets=n_buckets)
    if zero == 0:
        opt = [ttx.init(p) for p in params]
    else:
        opt = tzero.init_rank_major(params, ttx, N)
        if zero == 3:
            params = tzero.shard_params_rank_major(params, N)

    for i in range(2):
        x, y = _batch(4 * N, seed=i)
        jp, jo, js, jl = j_step(jp, jo, js, x, y)
        params, opt, stats, tl = t_step(params, opt, stats, _nchw(x),
                                        torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f"loss, step {i}")

    if zero == 3:
        jp = jzero.unshard_params(jp, j_params, mesh=mesh)
        params = tzero.unshard_params_rank_major(params, template)
    want = _by_name(model, jp, js)
    names = [n for n, _ in model.named_parameters()]
    for name, got in zip(names, params):
        _assert_close(got, want[name], name)
    for name, got in zip(layers.batch_stats_names(model), stats):
        _assert_close(got, want[name], name)
    # The momentum trace, per parameter.
    if zero == 0:
        j_trace = jo[0].trace
        traces = [s.trace for s in opt]
    else:
        flat = [np.asarray(a) for a in jax.tree.leaves(jo) if np.ndim(a)]
        j_trace = tweights._unflatten_flax(flat[0], j_params, N)
        traces = tzero.unshard_params_rank_major(opt.trace, template)
    want = _by_name(model, j_trace, js)
    for name, got in zip(names, traces):
        _assert_close(got, want[name], f"trace {name}")


def test_remat_equals_no_remat_and_updates_stats_once():
    """``remat=True`` (the forward recomputed in the backward) gives the
    same step as ``remat=False``, bitwise: parameters, state and the new
    running statistics, which a recomputed forward does not update twice;
    the model's own buffers stay untouched."""
    model = ResNet20(device="cpu")
    tx = toptim.sgd(LR, momentum=MOMENTUM)
    x, y = _batch(8, seed=4)
    outs = []
    for remat in (False, True):
        params, stats = recipes.bn_state(model)
        step = recipes.make_bn_dp_train_step_rank_major(
            model, tx, 2, backend="xla", remat=remat)
        outs.append(step(params, [tx.init(p) for p in params], stats,
                         _nchw(x), torch.from_numpy(y)))
    (p0, o0, s0, l0), (p1, o1, s1, l1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a.trace, b.trace) for a, b in zip(o0, o1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    # Once: the mean of the two ranks' 0.9 * start + 0.1 * batch.
    ones = layers.batch_stats(model)[1]
    assert torch.equal(ones, torch.ones_like(ones))
    h = model.conv_init(_nchw(x))
    var = [(h[r * 4:(r + 1) * 4].float() ** 2).mean((0, 2, 3))
           - h[r * 4:(r + 1) * 4].float().mean((0, 2, 3)) ** 2
           for r in range(2)]
    want = sum(0.9 + 0.1 * v for v in var) / 2
    np.testing.assert_allclose(s1[1].numpy(), want.detach().numpy(),
                               rtol=1e-5)


def test_unported_options_are_refused():
    """The ported analysis checks the built step (its first call of a
    signature lints clean) and telemetry counts its build; the
    ported overlap and bucket options build (their numbers are held to
    JAX above), and ``Config.gradsync_overlap="auto"`` turns the overlap
    on: the same step as ``overlap="auto"``, bitwise."""
    model = ResNet20(device="cpu")
    tx = toptim.sgd(LR)
    build = recipes.make_bn_dp_train_step_rank_major
    build(model, tx, 2, n_buckets=1, overlap="off")
    build(model, tx, 2, n_buckets=4)
    recipes.make_bn_dp_train_step(model, tx, overlap="auto")
    with pytest.raises(ValueError, match="overlap"):
        build(model, tx, 2, overlap="sometimes")
    with pytest.raises(ValueError, match="params_template"):
        build(model, tx, 2, zero=3)
    with pytest.raises(ValueError, match="zero must be"):
        build(model, tx, 2, zero=2)
    # The analysis is ported: under Config.analysis the builder's step is
    # checked on its first call of a batch signature, and the rank-major
    # BN step lints clean.
    tmpi.set_config(analysis="warn")
    try:
        from torchmpi_tpu_torch import analysis

        analysis.reset_captured()
        step = build(model, tx, 2, backend="xla")
        assert step.__wrapped_step__ is not None
        params, stats = recipes.bn_state(model)
        x, y = _batch(4, seed=6)
        step(params, [tx.init(p) for p in params], stats, _nchw(x),
             torch.from_numpy(y))
        found = analysis.captured_findings()
        assert not analysis.has_errors(found), found
        assert {f.rule for f in found} <= {"P2"}
    finally:
        tmpi.set_config(analysis="off")
        analysis.reset_captured()
    # The telemetry layer is ported: the builder runs with obs on and
    # counts one step build under the JAX recipe's label.
    tmpi.set_config(obs="metrics")
    try:
        from torchmpi_tpu_torch import obs

        obs.reset()
        build(model, tx, 2)
        assert obs.registry().counter(
            "tm_step_builds_total", label="bn_dp_train_step(zero=0)") == 1
    finally:
        tmpi.set_config(obs="off")
        obs.reset()
    x, y = _batch(8, seed=7)
    outs = []
    for overlap, cfg in (("auto", "off"), (None, "auto")):
        tmpi.set_config(gradsync_overlap=cfg)
        try:
            params, stats = recipes.bn_state(model)
            step = build(model, tx, 2, overlap=overlap)
        finally:
            tmpi.set_config(gradsync_overlap="off")
        outs.append(step(params, [tx.init(p) for p in params], stats,
                         _nchw(x), torch.from_numpy(y)))
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    step = build(model, tx, 3)
    params, stats = recipes.bn_state(model)
    x, y = _batch(4)
    with pytest.raises(ValueError, match="does not split"):
        step(params, [tx.init(p) for p in params], stats, _nchw(x),
             torch.from_numpy(y))


def test_new_config_fields_match_jax(monkeypatch):
    for f in ("gradsync_overlap", "analysis", "obs"):
        assert getattr(tmpi.Config(), f) == getattr(jmpi.Config(), f), f
    monkeypatch.setenv("TORCHMPI_TPU_GRADSYNC_OVERLAP", "auto")
    monkeypatch.setenv("TORCHMPI_TPU_ANALYSIS", "warn")
    monkeypatch.setenv("TORCHMPI_TPU_OBS", "metrics")
    got, want = tmpi.Config.from_env(), jmpi.Config.from_env()
    for f in ("gradsync_overlap", "analysis", "obs"):
        assert getattr(got, f) == getattr(want, f), f


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


# One rank of the 2-process recipe run: ResNet-20 from the seed-0 init,
# rank r taking the r-th half of each global batch of 8, 2 steps a level.
RECIPE_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import optim, recipes
    from torchmpi_tpu_torch.models import ResNet20
    from torchmpi_tpu_torch.parallel import zero as pzero

    rank, out = {rank}, {out!r}
    CASES = {cases!r}
    mpi.init(device="cpu", init_method="tcp://localhost:{port}", rank=rank,
             world_size=2)
    res = {{}}
    for level, overlap, n_buckets in CASES:
        model = ResNet20(device="cpu")
        tx = optim.sgd(0.1, momentum=0.9)
        params, stats = recipes.bn_state(model)
        template = [p.clone() for p in params]
        step = recipes.make_bn_dp_train_step(
            model, tx, zero=level,
            params_template=template if level == 3 else None,
            overlap=overlap, n_buckets=n_buckets)
        if level == 0:
            params, opt, stats = recipes.replicate_bn_state(
                params, [tx.init(p) for p in params], stats)
        else:
            opt = pzero.init(params, tx)
            if level == 3:
                params = pzero.shard_params(params)
        for i in range(2):
            rng = np.random.RandomState(i)
            x = rng.rand(8, 32, 32, 3).astype(np.float32)
            y = rng.randint(0, 10, size=8).astype(np.int32)
            lo = 4 * rank
            x = torch.from_numpy(x[lo:lo + 4]).permute(0, 3, 1, 2)
            params, opt, stats, loss = step(
                params, opt, stats, x, torch.from_numpy(y[lo:lo + 4]))
        if level == 3:
            params = pzero.unshard_params(params, template)
        key = f"z{{level}}_{{overlap}}_{{n_buckets}}"
        for j, t in enumerate(list(params) + list(stats)):
            res[f"{{key}}_{{j}}"] = t.numpy()
        res[f"{{key}}_loss"] = loss.numpy()
    if rank == 0:
        np.savez(out, **res)
    mpi.barrier()
    mpi.stop()
""")


# (zero, overlap, n_buckets) of the process-world recipe runs.
RECIPE_CASES = [(0, "off", None), (1, "off", None), (3, "off", None),
                (0, "auto", None), (1, "auto", None), (3, "auto", None),
                (0, "off", 4)]


def test_two_gloo_processes_match_rank_major(tmp_path):
    """The process-world recipe on 2 gloo ranks, ZeRO 0/1/3, with and
    without the overlapped sync and with 4 buckets, against the
    rank-major run of the same cases (held to JAX above)."""
    out = str(tmp_path / "rank0.npz")
    _run_workers(RECIPE_WORKER.replace("{out!r}", repr(out)).replace(
        "{cases!r}", repr(RECIPE_CASES)), 2)
    got = np.load(out)
    for level, overlap, n_buckets in RECIPE_CASES:
        key = f"z{level}_{overlap}_{n_buckets}"
        model = ResNet20(device="cpu")
        tx = toptim.sgd(0.1, momentum=0.9)
        params, stats = recipes.bn_state(model)
        template = [p.clone() for p in params]
        step = recipes.make_bn_dp_train_step_rank_major(
            model, tx, 2, zero=level,
            params_template=template if level == 3 else None,
            overlap=overlap, n_buckets=n_buckets)
        if level == 0:
            opt = [tx.init(p) for p in params]
        else:
            opt = tzero.init_rank_major(params, tx, 2)
            if level == 3:
                params = tzero.shard_params_rank_major(params, 2)
        for i in range(2):
            x, y = _batch(8, seed=i)
            params, opt, stats, loss = step(params, opt, stats, _nchw(x),
                                            torch.from_numpy(y))
        if level == 3:
            params = tzero.unshard_params_rank_major(params, template)
        np.testing.assert_allclose(got[f"{key}_loss"], loss.numpy(),
                                   rtol=1e-6)
        for j, t in enumerate(list(params) + list(stats)):
            np.testing.assert_allclose(got[f"{key}_{j}"], t.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} tensor {j}")


# One rank of the 2-process LeNet run: nn.data_parallel_step with SGD,
# rank r taking the r-th half of each batch of 8.
LENET_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.models import LeNet
    from torchmpi_tpu_torch.utils import data

    rank, out = {rank}, {out!r}
    mpi.init(device="cpu", init_method="tcp://localhost:{port}", rank=rank,
             world_size=2)
    model = LeNet(device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    step = mpi.nn.data_parallel_step(
        model, opt, lambda m, x, y: torch.nn.functional.cross_entropy(
            m(x), y.long()))
    X, Y = data.synthetic_mnist(64, seed=0)
    for xb, yb in data.batches(X, Y, 8, steps=3, seed=0):
        xb = torch.from_numpy(xb[4 * rank:4 * rank + 4]).permute(0, 3, 1, 2)
        step(xb, torch.from_numpy(yb[4 * rank:4 * rank + 4]))
    if rank == 0:
        np.savez(out, *[p.detach().numpy() for p in model.parameters()])
    mpi.barrier()
    mpi.stop()
""")


def test_lenet_two_gloo_ranks_equal_one_rank_full_batch(tmp_path):
    from torchmpi_tpu_torch.utils import data

    out = str(tmp_path / "rank0.npz")
    _run_workers(LENET_WORKER.replace("{out!r}", repr(out)), 2)
    got = np.load(out)
    model = LeNet(device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    X, Y = data.synthetic_mnist(64, seed=0)
    for xb, yb in data.batches(X, Y, 8, steps=3, seed=0):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(
            model(_nchw(xb)), torch.from_numpy(yb).long()).backward()
        opt.step()
    for i, p in enumerate(model.parameters()):
        np.testing.assert_allclose(got[f"arr_{i}"], p.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_lenet_rank_major_step_equals_one_rank_full_batch():
    """``nn.data_parallel_step_rank_major`` with n = 2 (the ranks' mean
    gradient) against plain SGD on the whole batch of 8: LeNet has no
    BatchNorm, so the DP equality holds."""
    from torchmpi_tpu_torch.utils import data

    a, b = LeNet(device="cpu"), LeNet(device="cpu")
    opt_a = torch.optim.SGD(a.parameters(), lr=0.05, momentum=0.9)
    opt_b = torch.optim.SGD(b.parameters(), lr=0.05, momentum=0.9)

    def loss_fn(m, x, y):
        return torch.nn.functional.cross_entropy(m(x), y.long())

    step = tmpi.nn.data_parallel_step_rank_major(a, opt_a, loss_fn, 2,
                                                 backend="pallas")
    X, Y = data.synthetic_mnist(64, seed=0)
    for xb, yb in data.batches(X, Y, 8, steps=3, seed=0):
        x, y = _nchw(xb), torch.from_numpy(yb)
        step(x, y)
        opt_b.zero_grad()
        loss_fn(b, x, y).backward()
        opt_b.step()
    for p, q in zip(a.parameters(), b.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
