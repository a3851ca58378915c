"""The port's nine collective verbs (torchmpi_tpu_torch/collectives.py)
against the JAX package on the CPU.

- The rank-major verbs against JAX's eager verbs on its 8-device mesh, the
  cases of ``tests/test_collectives.py`` :87-232 (roots, src / dst pairs,
  sizes straddling a tile), each rank's tensor f(rank) from a seed:
  bitwise for int32, float32 within rtol 1e-6 (the port sums over ranks as
  a left fold, XLA in an order of its own).  ``alltoall`` over other axes
  against JAX's host closed form (``_host_staged``).
- Staged (``staged=True``, ``backend="host"``, ``Config.staged``) equal to
  direct for every verb and dtype, bitwise, dtype included.
- The process-world verbs (and their ``async_in_axis`` forms) on 2 gloo
  processes against the closed forms of the two ranks' tensors.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import collectives as jcoll
import torchmpi_tpu_torch as tmpi

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


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


def rank_data(size, dtype, n=N, seed=0):
    """Rank r's tensor: distinct per rank, a seeded base plus r."""
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        base = rng.randint(-50, 50, size=size)
    else:
        base = rng.randn(size)
    return np.stack([(base + r).astype(dtype) for r in range(n)])


# (verb, params) as tests/test_collectives.py sweeps them.
CASES = [
    ("allreduce", {"op": "sum"}), ("allreduce", {"op": "mean"}),
    ("broadcast", {"root": 0}), ("broadcast", {"root": 3}),
    ("broadcast", {"root": 7}),
    ("reduce", {"root": 0}), ("reduce", {"root": 5}),
    ("reduce", {"root": 5, "op": "mean"}),
    ("allgather", {}), ("reduce_scatter", {}),
    ("gather", {"root": 0}), ("gather", {"root": 4}),
    ("scatter", {"root": 0}), ("scatter", {"root": 6}),
    ("sendreceive", {"src": 0, "dst": 1}),
    ("sendreceive", {"src": 2, "dst": 7}),
    ("sendreceive", {"src": 6, "dst": 3}),
    ("alltoall", {}),
]
# Verbs that tile the leading dim over the ranks take sizes divisible by 8.
TILED = ("reduce_scatter", "scatter", "alltoall")


def _ids(case):
    verb, params = case
    return "-".join([verb] + [f"{k}{v}" for k, v in params.items()])


@pytest.mark.parametrize("small", [True, False], ids=["small", "large"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["f32", "i32"])
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_rank_major_verb_matches_jax(case, dtype, small):
    verb, params = case
    size = (8 if small else 8000) if verb in TILED else (7 if small
                                                          else 1000)
    x = rank_data(size, dtype, seed=size)
    jparams = {k: v for k, v in params.items()}
    want = np.asarray(getattr(jmpi, verb)(x, **jparams))
    got = getattr(tmpi, f"{verb}_rank_major")(torch.from_numpy(x), **params)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("split_axis,concat_axis", [(0, 1), (1, 0), (1, 1)])
def test_alltoall_axes_match_jax_closed_form(split_axis, concat_axis):
    shape = (8, 6) if split_axis == 0 else (6, 8)
    x = rank_data(48, np.int32, seed=3).reshape(N, *shape)
    want = jcoll._host_staged("alltoall", x, N, split_axis=split_axis,
                              concat_axis=concat_axis)
    got = tmpi.alltoall_rank_major(torch.from_numpy(x),
                                   split_axis=split_axis,
                                   concat_axis=concat_axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_indivisible_raises():
    with pytest.raises(ValueError, match="divisible"):
        tmpi.scatter_rank_major(torch.ones(N, 7))
    with pytest.raises(ValueError, match="divisible"):
        tmpi.alltoall_rank_major(torch.ones(N, 7))
    with pytest.raises(ValueError, match="leading"):
        tmpi.reduce_rank_major(torch.ones(()))


VERB_PARAMS = {"allreduce": {"op": "mean"}, "broadcast": {"root": 2},
               "reduce": {"root": 1, "op": "mean"}, "allgather": {},
               "reduce_scatter": {}, "gather": {"root": 3},
               "scatter": {"root": 1}, "sendreceive": {"src": 3, "dst": 0},
               "alltoall": {}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("verb", list(VERB_PARAMS))
def test_staged_equals_direct(verb, dtype):
    """Op for op, dtype included (an integer mean is float32 both ways),
    through every way of asking for the staged path."""
    xs = torch.from_numpy(rank_data(4 * 300, np.float32, n=4, seed=7)
                          ).to(dtype)
    fn = getattr(tmpi, f"{verb}_rank_major")
    params = VERB_PARAMS[verb]
    direct = fn(xs, **params)
    for kw in ({"staged": True}, {"backend": "host"}):
        staged = fn(xs, **kw, **params)
        assert staged.dtype == direct.dtype and torch.equal(staged, direct)
    tmpi.set_config(staged=True)
    try:
        assert torch.equal(fn(xs, **params), direct)
        # An explicit backend forces the direct path.
        assert torch.equal(fn(xs, backend="xla", **params), direct)
    finally:
        tmpi.set_config(staged=False)
    if verb == "allreduce" and dtype == torch.int32:
        assert direct.dtype == torch.float32


def test_world_of_one_verbs_over_a_mesh_shape_axis():
    """Every in-axis verb over "tp" of ``mesh_shape={"tp": 1}`` in this
    world of one process: the closed forms with n = 1."""
    tmpi.stop()
    tmpi.init(tmpi.Config(mesh_shape={"tp": 1}), device="cpu")
    try:
        x = torch.arange(12.0).reshape(4, 3)
        for verb in tmpi.collectives.VERBS:
            kw = {"src": 0, "dst": 0} if verb == "sendreceive" else {}
            got = getattr(tmpi, f"{verb}_in_axis")(x, "tp", **kw)
            want = tmpi.collectives.CLOSED_FORMS[verb](x[None], **kw)[0]
            assert torch.equal(got, want), verb
    finally:
        tmpi.stop()
        tmpi.init(device="cpu")


def test_world_of_one_verbs():
    """The process-world verbs and their in-axis forms in this process's
    world of one: the closed forms with n = 1."""
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(tmpi.reduce(x, op="mean"), x)
    assert torch.equal(tmpi.gather(x), x[None])
    assert torch.equal(tmpi.scatter(x), x)
    assert torch.equal(tmpi.sendreceive(x, src=0, dst=0), x)
    assert torch.equal(tmpi.alltoall(x, split_axis=1, concat_axis=0), x)
    assert torch.equal(tmpi.broadcast_in_axis(x, ("dcn", "ici")), x)
    assert torch.equal(tmpi.gather_in_axis(x, ("ici", "dcn")), x[None])
    # One axis of the (1, 1) grid: that axis's group of one.
    assert torch.equal(tmpi.reduce_in_axis(x, "ici"), x)
    assert torch.equal(tmpi.allgather_in_axis(x, "dcn"), x[None])
    with pytest.raises(ValueError, match="unknown axis 'tp'"):
        tmpi.reduce_in_axis(x, "tp")
    i = torch.arange(6, dtype=torch.int32)
    assert tmpi.reduce(i, op="mean").dtype == torch.float32
    assert tmpi.allreduce(i, op="mean").dtype == torch.float32


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


# One rank of the 2-process run: every verb, sync and through
# async_in_axis, on rank r's tensor; the results saved per rank.
WORLD_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi

    rank = {rank}
    out = f"{outdir}/rank{{rank}}.npz"
    mpi.init(device="cpu", init_method="tcp://localhost:{port}", rank=rank,
             world_size=2)
    xs = np.load(f"{outdir}/data.npz")
    res = {{}}
    for name, verb, params in {cases!r}:
        for dt in ("f32", "i32"):
            x = torch.from_numpy(xs[dt][rank])
            res[f"{{name}}_{{dt}}"] = getattr(mpi, verb)(x, **params).numpy()
            h = getattr(mpi.async_in_axis, verb)(x, **params)
            res[f"{{name}}_{{dt}}_async"] = h.wait().numpy()
            assert h.done and h.error is None
    h = mpi.async_in_axis.scatter(torch.ones(3))
    assert h.done and isinstance(h.error, ValueError)
    np.savez(out, **res)
    mpi.barrier()
    mpi.stop()
""")

WORLD_CASES = [
    ("allreduce_sum", "allreduce", {}),
    ("allreduce_mean", "allreduce", {"op": "mean"}),
    ("broadcast1", "broadcast", {"root": 1}),
    ("reduce0", "reduce", {"root": 0}),
    ("reduce1_mean", "reduce", {"root": 1, "op": "mean"}),
    ("allgather", "allgather", {}),
    ("reduce_scatter", "reduce_scatter", {}),
    ("gather1", "gather", {"root": 1}),
    ("scatter0", "scatter", {"root": 0}),
    ("scatter1", "scatter", {"root": 1}),
    ("sendreceive01", "sendreceive", {"src": 0, "dst": 1}),
    ("sendreceive10", "sendreceive", {"src": 1, "dst": 0}),
    ("alltoall", "alltoall", {}),
    ("alltoall_10", "alltoall", {"split_axis": 1, "concat_axis": 0}),
]


def test_two_gloo_processes_match_closed_forms(tmp_path):
    """Each rank's result of the process-world verbs (and their async
    forms) is its slice of the rank-major closed form of the two ranks'
    tensors, bitwise (two-rank sums do not depend on the order)."""
    xs = {"f32": rank_data(24, np.float32, n=2, seed=11).reshape(2, 4, 6),
          "i32": rank_data(24, np.int32, n=2, seed=12).reshape(2, 4, 6)}
    np.savez(tmp_path / "data.npz", **xs)
    _run_workers(WORLD_WORKER.replace("{outdir}", str(tmp_path)).replace(
        "{cases!r}", repr(WORLD_CASES).replace("{", "{{").replace(
            "}", "}}")), 2)
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    got = [np.load(o) for o in outs]
    for name, verb, params in WORLD_CASES:
        for dt in ("f32", "i32"):
            want = getattr(tmpi, f"{verb}_rank_major")(
                torch.from_numpy(xs[dt]), **params).numpy()
            for r in range(2):
                for suffix in ("", "_async"):
                    np.testing.assert_array_equal(
                        got[r][f"{name}_{dt}{suffix}"], want[r],
                        err_msg=f"{name} {dt}{suffix} rank {r}")
