"""The port's bucketed and overlapped gradient sync
(torchmpi_tpu_torch/parallel/gradsync.py, fusion.py, zero.py presynced)
against the JAX package on the CPU.

- ``assign_overlap_buckets``, ``FusedSpec(n_buckets=)`` and the default
  ``overlap_bucket_bytes`` equal JAX's on the same shapes; the new Config
  fields and their environment variables equal JAX's.
- The bucketed sync (``n_buckets`` 1, 3, 4 and more than the elements)
  against JAX's ``synchronize_gradients`` on its 8-device mesh, float32
  within rtol 1e-6 (``tests/test_gradsync.py`` :81-157); ``barrier`` gives
  the same bits.
- The overlapped gradients (``make_overlapped_grad_fn_rank_major``)
  bitwise equal to ``synchronize_gradients_rank_major`` on the mixed
  fp32/bf16 tree at ``max_bytes=1024``, one collective per bucket
  (:330-365); the overlapped LeNet DP step bitwise equal to the plain one
  and within rtol 1e-5 of JAX's (:368-398); ZeRO-1 ``presynced`` within
  rtol 1e-6 of the reduce-scatter path (:401-443); under ``"pallas"`` (the
  plain ring on CPU tensors) bitwise equal to the plain ring on the
  overlap buckets; a leaf without a gradient syncs as zeros.
- 2 gloo processes: the process-world ``make_overlapped_grad_fn`` bitwise
  equal to ``synchronize_gradient_tensors`` and to the rank-major run.
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
import torch.nn.functional as F
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu import fusion as jfusion
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.parallel import gradsync as jgs
from torchmpi_tpu.utils import data as jdata
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import fusion as tfusion
from torchmpi_tpu_torch import optim as toptim
from torchmpi_tpu_torch import selector as tsel
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import LeNet
from torchmpi_tpu_torch.ops import ring as tring
from torchmpi_tpu_torch.parallel import gradsync as tgs
from torchmpi_tpu_torch.parallel import zero as tzero

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    tmpi.init(device="cpu")
    yield
    tmpi.stop()
    jmpi.stop()


# Mixed fp32 / bf16 leaves (shape, dtype), in JAX's leaf order of the
# mixed MLP of tests/test_gradsync.py :287 (l1.b, l1.w, l2.w, l3.w).
MIXED = [((32,), "float32"), ((8, 32), "float32"), ((32, 32), "bfloat16"),
         ((32, 4), "float32")]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pairs(shapes, seed=0):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*s).astype(np.float32) for s, _ in shapes]
    return ([jnp.asarray(a, dtype=d) for a, (_, d) in zip(arrs, shapes)],
            [torch.from_numpy(a).to(TDT[d]) for a, (_, d) in
             zip(arrs, shapes)])


def test_new_config_fields_match_jax(monkeypatch):
    fields = ("staged", "gradsync_buckets", "gradsync_barrier",
              "gradsync_overlap", "gradsync_overlap_bytes")
    for f in fields:
        assert getattr(tmpi.Config(), f) == getattr(jmpi.Config(), f), f
    for k, v in (("STAGED", "1"), ("GRADSYNC_BUCKETS", "5"),
                 ("GRADSYNC_BARRIER", "true"), ("GRADSYNC_OVERLAP", "auto"),
                 ("GRADSYNC_OVERLAP_BYTES", "4096")):
        monkeypatch.setenv(f"TORCHMPI_TPU_{k}", v)
    got, want = tmpi.Config.from_env(), jmpi.Config.from_env()
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("max_bytes", [1, 256, 1024, 4096, 1 << 20])
def test_assign_overlap_buckets_matches_jax(max_bytes):
    shapes = MIXED + [((100,), "float32"), ((10,), "float32"),
                      ((50,), "bfloat16"), ((5,), "float32")]
    j, t = _pairs(shapes)
    assert tgs.assign_overlap_buckets(t, max_bytes) == \
        jgs.assign_overlap_buckets(j, max_bytes)


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 7, 64])
def test_fused_spec_n_buckets_matches_jax(n_buckets):
    shapes = [((1000,), "float32"), ((37, 3), "bfloat16"), ((5,), "float32"),
              ((2, 250), "bfloat16"), ((4096,), "float32")]
    j, t = _pairs(shapes)
    js = jfusion.FusedSpec(j, n_buckets=n_buckets)
    ts = tfusion.FusedSpec(t, n_buckets=n_buckets)
    assert [g.bounds for g in ts.groups] == [g.bounds for g in js.groups]
    assert [g.indices for g in ts.groups] == [g.indices for g in js.groups]


@pytest.mark.parametrize("fuse,overlap_bytes", [
    (32 << 20, 0), (3_000_000, 0), (1000, 0), (0, 0), (32 << 20, 12345)])
def test_overlap_bucket_bytes_matches_jax(fuse, overlap_bytes):
    tmpi.set_config(fuse_max_bytes=fuse,
                    gradsync_overlap_bytes=overlap_bytes)
    jmpi.set_config(fuse_max_bytes=fuse,
                    gradsync_overlap_bytes=overlap_bytes)
    try:
        assert tgs.overlap_bucket_bytes() == jgs.overlap_bucket_bytes()
    finally:
        tmpi.set_config(fuse_max_bytes=32 << 20, gradsync_overlap_bytes=0)
        jmpi.set_config(fuse_max_bytes=32 << 20, gradsync_overlap_bytes=0)


def _jax_sync(tree, **kw):
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    fn = jax.jit(shard_map(
        lambda g: jgs.synchronize_gradients(g, ("dp",), **kw), mesh=mesh,
        in_specs=P("dp"), out_specs=P("dp"), check_vma=False))
    return [np.asarray(a) for a in fn(tree)]


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("n_buckets", [1, 3, 4, 64])
def test_bucketed_sync_matches_jax(n_buckets, op):
    rng = np.random.RandomState(n_buckets)
    grads = [rng.randn(N, 4096).astype(np.float32),
             rng.randn(N, 513).astype(np.float32),
             rng.randn(N, 7, 3).astype(np.float32)]
    want = _jax_sync(grads, op=op, n_buckets=n_buckets)
    stacks = [torch.from_numpy(g.copy()) for g in grads]
    tgs.synchronize_gradients_rank_major(stacks, op=op, n_buckets=n_buckets)
    for got, w in zip(stacks, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)
    # barrier: the same bits (each bucket is its own launch either way);
    # the Config's gradsync_buckets is the default.
    again = [torch.from_numpy(g.copy()) for g in grads]
    tmpi.set_config(gradsync_buckets=n_buckets)
    try:
        tgs.synchronize_gradients_rank_major(again, op=op, barrier=True)
    finally:
        tmpi.set_config(gradsync_buckets=1)
    assert all(torch.equal(a, b) for a, b in zip(again, stacks))


def test_bucket_count_exceeding_elements():
    x = torch.arange(8.0).reshape(8, 1)
    tgs.synchronize_gradients_rank_major([x], op="sum", n_buckets=64)
    assert torch.equal(x, torch.full((8, 1), 28.0))


def test_ef_options_raise_by_name():
    for kw in ({"residuals": [torch.zeros(1)]}, {"dcn_compress": "int8"}):
        with pytest.raises(NotImplementedError, match="queue A, item 4"):
            tgs.synchronize_gradients_rank_major([torch.ones(2, 3)], **kw)
    with pytest.raises(NotImplementedError, match="queue A, item 4"):
        tgs.make_overlapped_grad_fn(lambda p: p[0].sum(), [torch.ones(2)],
                                    residuals=True)


def _mixed_loss(leaves, x, y):
    b1, w1, w2, w3 = leaves
    h = torch.tanh(x @ w1 + b1)
    h = torch.tanh(h.to(torch.bfloat16) @ w2)
    out = h.to(torch.float32) @ w3
    return ((out - y) ** 2).mean()


def _mixed_data(n=N):
    x = torch.from_numpy(np.random.RandomState(0).rand(n * 8, 8)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).rand(n * 8, 4)
                         .astype(np.float32))
    return x, y


def _rank_grads(loss_fn, params, n, *batch):
    stacks = [p.new_zeros((n, *p.shape)) for p in params]
    parts = [b.reshape(n, -1, *b.shape[1:]) for b in batch]
    for r in range(n):
        leaves = [p.detach().requires_grad_() for p in params]
        grads = torch.autograd.grad(loss_fn(leaves, *(b[r] for b in parts)),
                                    leaves, allow_unused=True)
        for st, g in zip(stacks, grads):
            if g is not None:
                st[r].copy_(g)
    return stacks


class _Counter:
    """Counts the calls of the selector's rank-major allreduce routes."""

    def __init__(self, op="allreduce_rank_major"):
        self.op, self.calls = op, []
        self.saved = dict(tsel.available(op))

    def __enter__(self):
        for name, fn in self.saved.items():
            def counted(xs, _fn=fn, _name=name, **kw):
                self.calls.append((_name, tuple(xs.shape)))
                return _fn(xs, **kw)
            tsel.register(self.op, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            tsel.register(self.op, name, fn)


@pytest.mark.parametrize("op", ["mean", "sum"])
def test_overlap_matches_sync_bitwise_mixed_dtypes(op):
    _, params = _pairs(MIXED)
    x, y = _mixed_data()
    firing = tgs.assign_overlap_buckets(params, 1024)
    assert len(firing) == 4  # l3.w | l2.w (bf16) | l1.w | l1.b
    vag = tgs.make_overlapped_grad_fn_rank_major(_mixed_loss, params, N,
                                                 op=op, max_bytes=1024)
    with _Counter() as c:
        losses, stacks = vag(params, x, y)
    # One collective per bucket, in firing order.
    assert [shape for _, shape in c.calls] == [
        (N, sum(params[i].numel() for i in b)) for b in firing]
    ref = _rank_grads(_mixed_loss, params, N, x, y)
    tgs.synchronize_gradients_rank_major(ref, op=op)
    for a, b in zip(stacks, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(losses) == N


def test_overlap_grads_match_jax_mixed_tree():
    """The overlapped gradients against JAX's overlapped schedule on the
    same tree and batch (bf16 products: within bf16's rounding)."""
    jp, params = _pairs(MIXED)
    x, y = _mixed_data()
    jtree = {"l1": {"b": jp[0], "w": jp[1]}, "l2": {"w": jp[2]},
             "l3": {"w": jp[3]}}

    def jloss(p, xb, yb):
        h = jnp.tanh(xb @ p["l1"]["w"] + p["l1"]["b"])
        h = jnp.tanh(h.astype(jnp.bfloat16) @ p["l2"]["w"])
        out = h.astype(jnp.float32) @ p["l3"]["w"]
        return jnp.mean((out - yb) ** 2)

    mesh = Mesh(np.array(jax.devices()), ("dp",))
    fn = jax.jit(shard_map(
        lambda p, xb, yb: jgs.make_overlapped_grad_fn(
            jloss, p, ("dp",), max_bytes=1024)(p, xb, yb), mesh=mesh,
        in_specs=(P(), P("dp"), P("dp")), out_specs=(P(), P()),
        check_vma=False))
    jl, jg = fn(jtree, x.numpy(), y.numpy())
    want = [jg["l1"]["b"], jg["l1"]["w"], jg["l2"]["w"], jg["l3"]["w"]]
    losses, stacks = tgs.make_overlapped_grad_fn_rank_major(
        _mixed_loss, params, N, max_bytes=1024)(params, x, y)
    # JAX returns device 0's local loss.
    np.testing.assert_allclose(float(losses[0]), float(jl), rtol=1e-2)
    for st, w in zip(stacks, want):
        for r in range(N):
            assert torch.equal(st[r], st[0])
        np.testing.assert_allclose(st[0].float().numpy(),
                                   np.asarray(w, np.float32), rtol=2e-2,
                                   atol=2e-2)


def test_overlap_pallas_equals_plain_ring_on_overlap_layout():
    """Under "pallas" the ring folds an element in the order of its ring
    chunk, so the overlapped sync equals the plain ring run on the
    overlap layout's buckets, bitwise (the CPU runs the ring's plain
    version)."""
    _, params = _pairs(MIXED)
    params = [p.float() for p in params]
    x, y = _mixed_data(4)

    def loss(leaves, xb, yb):
        return _mixed_loss([leaves[0], leaves[1], leaves[2].bfloat16(),
                            leaves[3]], xb, yb)

    firing = tgs.assign_overlap_buckets(params, 1024)
    _, stacks = tgs.make_overlapped_grad_fn_rank_major(
        loss, params, 4, max_bytes=1024, backend="pallas")(params, x, y)
    ref = _rank_grads(loss, params, 4, x, y)
    for b in firing:
        g = tfusion.bucket_group(params, b)
        buf = tfusion.gather_bucket(ref, g, 0, g.total, rank_major=True)
        tfusion.scatter_bucket(tring.ring_allreduce_plain(buf, op="mean"),
                               ref, g, 0, rank_major=True)
    assert all(torch.equal(a, b) for a, b in zip(stacks, ref))


def test_leaf_without_gradient_and_firing_order():
    """A leaf the loss never reaches syncs as zeros (its bucket fires
    after the backward), and buckets fire in firing order whatever order
    their gradients complete in."""
    params = [torch.randn(5), torch.randn(3, 4), torch.randn(4)]
    x = torch.randn(N * 2, 3)
    unused = tgs.make_overlapped_grad_fn_rank_major(
        lambda p, xb: (xb @ p[1] + p[2]).sum(), params, N, max_bytes=16)
    _, stacks = unused(params, x)
    assert torch.equal(stacks[0], torch.zeros(N, 5))
    ref = _rank_grads(lambda p, xb: (xb @ p[1] + p[2]).sum(), params, N, x)
    tgs.synchronize_gradients_rank_major(ref)
    assert all(torch.equal(a, b) for a, b in zip(stacks, ref))
    fired = []
    sched = tgs._Schedule([[2], [1, 0], [3]], fired.append)
    for i in (3, 0, 2, 1):
        sched.arrived(i)
    assert fired == [0, 1, 2]


def test_failure_inside_a_hook_raises_out_of_vag():
    """A collective that fails inside a backward hook (a ring kernel that
    does not build or launch, here a stand-in that raises) raises out of
    ``vag``; nothing swaps in another route."""
    _, params = _pairs(MIXED)
    x, y = _mixed_data(4)
    route = tsel.available("allreduce_rank_major")["pallas"]

    def broken(xs, **kw):
        raise RuntimeError("ring kernel did not launch")

    tsel.register("allreduce_rank_major", "pallas", broken)
    try:
        vag = tgs.make_overlapped_grad_fn_rank_major(
            _mixed_loss, params, 4, max_bytes=1024, backend="pallas")
        with pytest.raises(RuntimeError, match="did not launch"):
            vag(params, x, y)
    finally:
        tsel.register("allreduce_rank_major", "pallas", route)


def _lenet_tools():
    jm = JLeNet()
    jparams = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    model = LeNet(device="cpu")
    model.load_state_dict(tweights.from_flax_cnn(
        jax.tree.map(np.asarray, dict(jparams)), model))
    names = [k for k, _ in model.named_parameters()]

    def loss_fn(leaves, x, y):
        logits = torch.func.functional_call(model, dict(zip(names, leaves)),
                                            (x,))
        return F.cross_entropy(logits, y.long())

    return jm, jparams, model, names, loss_fn


def test_overlap_dp_step_matches_plain_and_jax():
    """One LeNet SGD step of 8 ranks: the overlapped gradients give the
    plain step's parameters bitwise, and JAX's overlapped step's within
    rtol 1e-5."""
    jm, jparams, model, names, loss_fn = _lenet_tools()
    X, Y = jdata.synthetic_mnist(64, seed=3)
    x, y = torch.from_numpy(X).permute(0, 3, 1, 2), torch.from_numpy(Y)
    params = [p.detach().clone() for p in model.parameters()]
    tx = toptim.sgd(0.01, momentum=0.9)

    def apply(grads):
        out = [tx.update(g, tx.init(p), p) for g, p in zip(grads, params)]
        return [toptim.apply_updates(p, u) for p, (u, _) in
                zip(params, out)]

    _, stacks = tgs.make_overlapped_grad_fn_rank_major(
        loss_fn, params, N)(params, x, y)
    ref = _rank_grads(loss_fn, params, N, x, y)
    tgs.synchronize_gradients_rank_major(ref)
    p_over, p_plain = apply([s[0] for s in stacks]), apply([s[0] for s in
                                                            ref])
    assert all(torch.equal(a, b) for a, b in zip(p_over, p_plain))

    jtx = optax.sgd(0.01, momentum=0.9)

    def local_loss(p, xb, yb):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, xb), yb).mean()

    def dp_over(p, o, xb, yb):
        loss, grads = jgs.make_overlapped_grad_fn(
            local_loss, p, ("dcn", "ici"))(p, xb, yb)
        u, o = jtx.update(grads, o, p)
        return optax.apply_updates(p, u), o, loss

    dp = jgs.data_parallel_step(dp_over, batch_argnums=(2, 3),
                                donate_argnums=())
    jp, _, _ = dp(jgs.synchronize_parameters(jparams),
                  jgs.synchronize_parameters(jtx.init(jparams)), X, Y)
    want = tweights.from_flax_cnn(jax.tree.map(np.asarray, dict(jp)), model)
    for name, got in zip(names, p_over):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_overlap_zero1_presynced_matches():
    """ZeRO-1 with the overlapped sync: the synced stacks reach the
    optimizer through a local shard slice (``presynced=True``), within
    rtol 1e-6 of the reduce-scatter path on the raw gradients."""
    _, _, model, _, loss_fn = _lenet_tools()
    X, Y = jdata.synthetic_mnist(64, seed=4)
    x, y = torch.from_numpy(X).permute(0, 3, 1, 2), torch.from_numpy(Y)
    params = [p.detach().clone() for p in model.parameters()]
    tx = toptim.adam(1e-3)
    spec = tzero.flat_spec(params, n_shards=N)
    state = tzero.init_rank_major(params, tx, N)
    flats, views = tfusion.rank_major_buffers(spec, N, device="cpu")
    tgs.make_overlapped_grad_fn_rank_major(loss_fn, params, N)(
        params, x, y, stacks=views)
    p_over, _ = tzero.update_rank_major(params, flats, state, tx,
                                        presynced=True)
    raw = tfusion.group_flats(_rank_grads(loss_fn, params, N, x, y), spec)
    p_ref, _ = tzero.update_rank_major(params, raw, state, tx)
    for a, b in zip(p_over, p_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# One rank of the 2-process run: the mixed MLP's overlapped gradients and
# its synchronize_gradient_tensors gradients on rank r's half of the batch,
# with the process-world allreduce calls counted.
OVERLAP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import selector
    from torchmpi_tpu_torch.parallel import gradsync
    from test_torch_overlap import MIXED, _mixed_data, _mixed_loss, _pairs

    rank = {rank}
    mpi.init(device="cpu", init_method="tcp://localhost:{port}", rank=rank,
             world_size=2)
    _, params = _pairs(MIXED)
    x, y = _mixed_data(2)
    x, y = x[rank * 8:(rank + 1) * 8], y[rank * 8:(rank + 1) * 8]
    calls = []
    stock = selector.available("allreduce")["xla"]

    def counted(buf, **kw):
        calls.append(buf.numel())
        return stock(buf, **kw)

    selector.register("allreduce", "xla", counted)
    vag = gradsync.make_overlapped_grad_fn(_mixed_loss, params,
                                           max_bytes=1024)
    loss, grads = vag(params, x, y)
    n_over = len(calls)
    leaves = [p.detach().requires_grad_() for p in params]
    ref = [g.contiguous() for g in torch.autograd.grad(
        _mixed_loss(leaves, x, y), leaves)]
    gradsync.synchronize_gradient_tensors(ref)
    res = {{f"over_{{i}}": g.float().numpy() for i, g in enumerate(grads)}}
    res.update({{f"sync_{{i}}": g.float().numpy()
                 for i, g in enumerate(ref)}})
    res["dtypes"] = np.array([str(g.dtype) for g in grads])
    res["n_over"] = np.array(n_over)
    np.savez(f"{outdir}/rank{{rank}}.npz", **res)
    mpi.barrier()
    mpi.stop()
""")


def test_two_gloo_processes_overlap_matches_sync(tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    script = OVERLAP_WORKER.replace("{outdir}", str(tmp_path))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script.format(
            repo=REPO, tests=os.path.join(REPO, "tests"), rank=r,
            port=port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
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
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    _, params = _pairs(MIXED)
    x, y = _mixed_data(2)
    _, stacks = tgs.make_overlapped_grad_fn_rank_major(
        _mixed_loss, params, 2, max_bytes=1024)(params, x, y)
    for r in range(2):
        assert int(got[r]["n_over"]) == len(
            tgs.assign_overlap_buckets(params, 1024))
        assert list(got[r]["dtypes"]) == [str(p.dtype) for p in params]
        for i, st in enumerate(stacks):
            np.testing.assert_array_equal(got[r][f"over_{i}"],
                                          got[r][f"sync_{i}"])
            np.testing.assert_array_equal(got[r][f"over_{i}"],
                                          st[r].float().numpy())
