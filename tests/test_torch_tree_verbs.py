"""The port's in-axis verbs over trees (torchmpi_tpu_torch/collectives.py
``_in_axis``, torchmpi_tpu_torch/fusion.py) against the JAX package on the
CPU.

- ``_tree`` flattens dict keys in sorted order, as ``jax.tree`` does, and
  round-trips dicts, lists, tuples and NamedTuples.
- The launch drop of ``tests/test_fusion.py`` :60 counted on the port's
  launches: a 32-leaf float32 / bfloat16 tree takes ``spec.n_launches`` =
  2 launches (allreduce, reduce, broadcast; the reduce-scatter its 2
  whole-tensor buckets), 32 under ``fuse_max_bytes=0``.
- Each condition under which the JAX package goes per leaf
  (``fusion.py`` :317, :341) sends the port per leaf, with the same
  results.
- 2 gloo processes: tree ``allreduce`` / ``reduce`` / ``broadcast`` /
  ``reduce_scatter`` / ``allgather`` ``_in_axis`` fused bitwise equal to
  per leaf, and allreduce and reduce-scatter against JAX's on 2 devices
  (``shard_map``, backend "xla").
- The rank-major fused reduce-scatter (the FSDP gradient reduce-scatter)
  of 4 ranks on the plain ring and on the stock route, bitwise equal to
  per leaf, and against JAX's ``reduce_scatter_in_axis`` on a tree on 4
  devices; the rank-major fused allreduce against JAX's
  ``allreduce_in_axis``.  Against JAX: bitwise for int32, float32 within
  rtol 1e-6 (the port's sums over ranks are a left fold, XLA's an order
  of its own).
"""

import os
import socket
import subprocess
import sys
import textwrap
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu import collectives as jcoll
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import _tree, fusion, selector

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("dp",)
N_LEAVES = 32


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


@pytest.fixture(autouse=True)
def default_fusion():
    yield
    tmpi.set_config(fuse_max_bytes=32 << 20)


def mixed_tree(n_leaves=N_LEAVES, seed=0):
    """tests/test_fusion.py's tree: leaves alternating float32 / bfloat16,
    [8 (1 + i % 3), 4] each (a leading dim 8 divides)."""
    rng = np.random.RandomState(seed)
    return {f"p{i:02d}": torch.from_numpy(
        rng.randn(8 * (1 + i % 3), 4).astype(np.float32)).to(
            torch.float32 if i % 2 == 0 else torch.bfloat16)
        for i in range(n_leaves)}


class Pair(NamedTuple):
    a: object
    b: object


def test_tree_round_trip_sorts_dict_keys():
    t = torch.arange(3)
    tree = {"z": [t, (1.5, t + 1)], "a": Pair(t + 2, {"y": t + 3, "b": 7}),
            "m": t + 4}
    leaves, td = _tree.flatten(tree)
    assert [type(x).__name__ for x in leaves] == [
        "Tensor", "int", "Tensor", "Tensor", "Tensor", "float", "Tensor"]
    assert [int(x[0]) if torch.is_tensor(x) else x for x in leaves] == [
        2, 7, 3, 4, 0, 1.5, 1]
    back = _tree.unflatten(td, leaves)
    assert list(back) == ["a", "m", "z"] and isinstance(back["a"], Pair)
    assert isinstance(back["z"][1], tuple) and back["a"].b["b"] == 7
    assert _tree.leaves(_tree.map(lambda x: x, tree))[0] is leaves[0]
    # jax.tree's leaf order on the same keys.
    jt = {"z": 0, "a": 1, "m": 2}
    assert _tree.leaves(jt) == jax.tree.leaves(jt)


def _count_launches(verb):
    """Wrap the selector's "xla" implementation of ``verb``: returns the
    list its calls append to and the function that restores it."""
    calls = []
    impl = selector.available(verb)["xla"]

    def counted(*a, **k):
        calls.append(a[0].numel())
        return impl(*a, **k)

    selector.register(verb, "xla", counted)
    return calls, lambda: selector.register(verb, "xla", impl)


VERB_PARAMS = {"allreduce": {"op": "sum"}, "reduce": {"root": 0},
               "broadcast": {"root": 0}, "reduce_scatter": {}}


@pytest.mark.parametrize("verb", list(VERB_PARAMS))
def test_32_leaves_take_2_launches(verb):
    tree = mixed_tree()
    spec = fusion.FusedSpec(list(_tree.leaves(tree)))
    assert len(spec.groups) == 2
    want = (spec.n_reduce_scatter_launches if verb == "reduce_scatter"
            else spec.n_launches)
    assert want == 2
    fn = getattr(tmpi, f"{verb}_in_axis")
    calls, restore = _count_launches(verb)
    try:
        fused = fn(tree, **VERB_PARAMS[verb])
        assert len(calls) == 2
        tmpi.set_config(fuse_max_bytes=0)
        per_leaf = fn(tree, **VERB_PARAMS[verb])
        assert len(calls) == 2 + N_LEAVES
    finally:
        restore()
    for k in tree:
        assert fused[k].dtype == tree[k].dtype
        assert torch.equal(fused[k], per_leaf[k]), k


def _leaves_of(case):
    rng = np.random.RandomState(1)
    f = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))
         for _ in range(3)]
    return {"fusion_off": f, "one_leaf": f[:1], "not_a_tensor": f + [2.5],
            "no_fewer_launches": f, "indivisible": [f[0][:3], f[1]]}[case]


@pytest.mark.parametrize("case", ["fusion_off", "one_leaf", "not_a_tensor",
                                  "no_fewer_launches", "indivisible"])
def test_each_condition_goes_per_leaf(case):
    """JAX's reasons to go per leaf (fusion.py :317, :341), each on its
    own: fusion off, one leaf, a leaf that is not an array, buckets that
    would not cut the launches (a 16-byte bound gives every tensor its own
    buckets), and, for the reduce-scatter, a leading dim the ranks do not
    divide."""
    leaves = _leaves_of(case)
    if case == "fusion_off":
        tmpi.set_config(fuse_max_bytes=0)
    if case == "no_fewer_launches":
        tmpi.set_config(fuse_max_bytes=16)
    n = 2 if case == "indivisible" else 1
    if case != "indivisible":
        assert fusion.elementwise_spec("allreduce", leaves) is None
    assert fusion.reduce_scatter_spec(leaves, n) is None
    if case != "indivisible":
        # The verbs then go per leaf: a Python number becomes a 0-d tensor.
        got = tmpi.allreduce_in_axis(leaves)
        assert len(got) == len(leaves)
        for g, x in zip(got, leaves):
            assert torch.equal(g, torch.as_tensor(x))
    # With no reason left, the same leaves fuse.
    tmpi.set_config(fuse_max_bytes=32 << 20)
    fusable = [x for x in leaves if torch.is_tensor(x)]
    fusable = fusable + [fusable[0] * 2] if len(fusable) < 2 else fusable
    if case == "indivisible":
        fusable = [x[:2] for x in fusable]
    assert fusion.elementwise_spec("allreduce", fusable) is not None
    assert fusion.reduce_scatter_spec(fusable, n) is not None


def test_non_elementwise_verbs_go_per_leaf():
    tree = {"a": torch.ones(2, 3), "b": torch.zeros(4)}
    calls, restore = _count_launches("allgather")
    try:
        out = tmpi.allgather_in_axis(tree)
    finally:
        restore()
    assert len(calls) == 2
    assert out["a"].shape == (1, 2, 3) and out["b"].shape == (1, 4)


def _jax_tree(verb, tree, n, **params):
    """JAX's ``<verb>_in_axis`` of a tree under ``shard_map`` on ``n``
    devices, backend "xla": ``tree``'s leaves are [n, ...] stacks, rank r
    taking slice r; returns the stacks of the ranks' results."""
    mesh = Mesh(np.array(jax.devices()[:n]), AXES)
    fn = getattr(jcoll, f"{verb}_in_axis")

    def body(t):
        t = jax.tree.map(lambda x: x[0], t)
        out = fn(t, AXES, backend="xla", **params)
        return jax.tree.map(lambda x: x[None], out)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P(AXES),
                          out_specs=P(AXES), check_vma=False))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, tree)))


def _rank_tree(n, seed):
    """A dict tree of [n, ...] stacks: float32 and int32 leaves (leading
    dims divisible by 4), shapes and key order mixed."""
    rng = np.random.RandomState(seed)
    shapes = {"w1": (8, 3), "b1": (4,), "w0": (12, 5), "i1": (4, 6),
              "i0": (8,), "c": (4, 2, 3)}
    return {k: (rng.randint(-50, 50, (n, *s)).astype(np.int32)
                if k.startswith("i") else
                rng.randn(n, *s).astype(np.float32))
            for k, s in shapes.items()}


def _assert_matches_jax(got, want, what):
    for k in want:
        if want[k].dtype == np.int32:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rank_major_fused_reduce_scatter(backend):
    """4 ranks: the fused tile-interleaved reduce-scatter of rank-major
    stacks (one launch per whole-tensor bucket; "pallas" is the plain ring
    on CPU tensors) bitwise equal to per leaf, and against JAX's tree
    reduce-scatter on 4 devices."""
    n = 4
    tree = _rank_tree(n, seed=3)
    keys = sorted(tree)
    stacks = [torch.from_numpy(tree[k]) for k in keys]
    calls = []
    impl = selector.available("reduce_scatter_rank_major")[backend]

    def counted(xs, **k):
        calls.append(xs.shape)
        return impl(xs, **k)

    selector.register("reduce_scatter_rank_major", backend, counted)
    try:
        fused = fusion.fused_reduce_scatter_rank_major(stacks,
                                                       backend=backend)
        assert len(calls) == 2  # the float32 and the int32 group
        tmpi.set_config(fuse_max_bytes=0)
        per_leaf = fusion.fused_reduce_scatter_rank_major(stacks,
                                                          backend=backend)
        assert len(calls) == 2 + len(stacks)
    finally:
        selector.register("reduce_scatter_rank_major", backend, impl)
    for k, a, b in zip(keys, fused, per_leaf):
        assert a.shape == (n, tree[k].shape[1] // n, *tree[k].shape[2:])
        assert torch.equal(a, b), k
    want = _jax_tree("reduce_scatter", tree, n)
    _assert_matches_jax({k: t.numpy() for k, t in zip(keys, fused)}, want,
                        "reduce_scatter")


def test_rank_major_fused_allreduce_matches_jax():
    n = 4
    tree = {k: v for k, v in _rank_tree(n, seed=5).items()
            if not k.startswith("i")}
    keys = sorted(tree)
    stacks = [torch.from_numpy(tree[k].copy()) for k in keys]
    fusion.fused_allreduce_rank_major_(stacks, backend="xla", op="mean")
    want = _jax_tree("allreduce", tree, n, op="mean")
    _assert_matches_jax({k: t.numpy() for k, t in zip(keys, stacks)}, want,
                        "allreduce")


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


# One rank of the 2-process run: each tree verb fused (the default) and
# per leaf (fuse_max_bytes 0) on rank r's slice of the tree.
TREE_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi

    rank = {rank}
    mpi.init(device="cpu", init_method="tcp://localhost:{port}", rank=rank,
             world_size=2)
    data = np.load("{outdir}/data.npz")
    tree = {{k: torch.from_numpy(data[k][rank]) for k in data.files}}
    res = {{}}
    for name, verb, params in {cases!r}:
        for mode, max_bytes in (("fused", 32 << 20), ("leaf", 0)):
            mpi.set_config(fuse_max_bytes=max_bytes)
            out = getattr(mpi, verb + "_in_axis")(tree, **params)
            assert sorted(out) == sorted(tree)
            for k, v in out.items():
                res[f"{{name}}.{{mode}}.{{k}}"] = v.numpy()
    np.savez(f"{outdir}/rank{{rank}}.npz", **res)
    mpi.barrier()
    mpi.stop()
""")

TREE_CASES = [
    ("allreduce_sum", "allreduce", {}),
    ("allreduce_mean", "allreduce", {"op": "mean"}),
    ("reduce1", "reduce", {"root": 1}),
    ("broadcast1", "broadcast", {"root": 1}),
    ("reduce_scatter", "reduce_scatter", {}),
    ("allgather", "allgather", {}),
]


def test_two_gloo_processes_tree_verbs(tmp_path):
    """Every tree verb fused bitwise equal to per leaf on 2 gloo ranks; the
    allreduces and the reduce-scatter against JAX's on 2 devices."""
    tree = _rank_tree(2, seed=7)
    np.savez(tmp_path / "data.npz", **tree)
    _run_workers(TREE_WORKER.replace("{outdir}", str(tmp_path)).replace(
        "{cases!r}", repr(TREE_CASES).replace("{", "{{").replace(
            "}", "}}")), 2)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for name, verb, params in TREE_CASES:
        for r in range(2):
            for k in tree:
                np.testing.assert_array_equal(
                    got[r][f"{name}.fused.{k}"], got[r][f"{name}.leaf.{k}"],
                    err_msg=f"{name} {k} rank {r}")
        if verb in ("allreduce", "reduce_scatter"):
            want = _jax_tree(verb, tree, 2, **params)
            _assert_matches_jax(
                {k: np.stack([got[r][f"{name}.fused.{k}"] for r in range(2)])
                 for k in tree}, want, name)
