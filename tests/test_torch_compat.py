"""The port's TorchMPI-naming surface (torchmpi_tpu_torch/compat.py) against
the JAX package's (torchmpi_tpu/compat.py) on the same numpy stacks.

The 8 cases of ``tests/test_compat.py``, each run through both compat
modules: the sync ``*Tensor`` names alias the rank-major verbs (the JAX
package's eager verbs), so the same stack gives the same result: float32
within rtol 1e-6 (the port sums over ranks as a left fold, XLA in an order
of its own), exact otherwise, dtype included; staged equal to direct
bitwise on the port.  Plus ``collectiveSelector("pallas")`` routing
``allreduceTensor`` through the ring and ``collectiveSelector("auto")``
through a measured plan.  Both runtimes run on the CPU, the port's in a
world of one gloo process.
"""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torchmpi_tpu
import torchmpi_tpu.compat as jc
import torchmpi_tpu_torch
import torchmpi_tpu_torch.compat as tc
from torchmpi_tpu_torch import planner, tuning

from _torch_world import module_group

torch.set_num_threads(2)

VERBS = ("allreduce", "broadcast", "reduce", "allgather", "gather",
         "scatter", "sendreceive", "reduce_scatter", "alltoall")
KNOBS = ("set_flat_collectives", "set_hierarchical_collectives",
         "set_staged_collectives", "set_direct_collectives",
         "set_chunk_size", "set_min_bytes_for_custom")


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture()
def started():
    torchmpi_tpu.stop()
    torchmpi_tpu_torch.stop()
    jc.start(dcn_size=2)
    tc.start(False, dcn_size=2)
    yield
    tc.stop()
    jc.stop()


def _close(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    assert tuple(got.shape) == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def test_start_rank_size(started):
    assert (tc.rank(), tc.size(), tc.localRank()) == \
        (jc.rank(), jc.size(), jc.localRank()) == (0, 1, 0)
    tc.barrier()
    assert torchmpi_tpu_torch.runtime.device().type == "cpu"


def test_tensor_verbs(started):
    x = np.stack([np.full(6, float(r), np.float32) for r in range(8)])
    t = torch.from_numpy(x)
    _close(tc.allreduceTensor(t), jc.allreduceTensor(x))
    assert torch.equal(tc.allreduceTensor(t)[0], torch.from_numpy(
        x.sum(axis=0)))
    _close(tc.broadcastTensor(t, root=2), jc.broadcastTensor(x, root=2))
    h = tc.async_.allreduceTensor(t)
    _close(tc.syncHandle(h), jc.syncHandle(jc.async_.allreduceTensor(x)))


def test_knob_setters(started):
    for mod, cfg in ((tc, torchmpi_tpu_torch.config),
                     (jc, torchmpi_tpu.config)):
        mod.collectiveSelector("pallas")
        mod.set_hierarchical_collectives()
        assert cfg().hierarchical and cfg().backend == "hierarchical"
        mod.set_flat_collectives()
        assert not cfg().hierarchical and cfg().backend == "pallas"
        mod.set_flat_collectives()  # an empty stack restores "xla"
        assert cfg().backend == "xla"
        mod.set_chunk_size(1234)
        assert cfg().chunk_bytes == 1234
        mod.set_min_bytes_for_custom(0)
        assert cfg().custom_min_bytes == 0
        mod.collectiveSelector("auto")
        assert cfg().backend == "auto"
        assert "pallas" in mod.collectiveAvailability()["allreduce"]


def test_compat_surface_is_complete(started):
    for verb in VERBS:
        assert callable(getattr(tc, verb + "Tensor")), verb
        assert callable(getattr(tc.async_, verb + "Tensor")), verb
    for knob in KNOBS:
        assert callable(getattr(tc, knob)), knob
    public = {n for n in dir(jc) if not n.startswith("_")
              and n not in ("annotations", "SimpleNamespace")}
    assert public <= set(dir(tc))
    assert set(vars(jc.async_)) == set(vars(tc.async_))
    assert set(vars(jc.nn)) == set(vars(tc.nn))
    assert tc.parameterserver() is torchmpi_tpu_torch.parameterserver


STAGED_CASES = [
    ("allreduceTensor", {}),
    ("allreduceTensor", {"op": "mean"}),
    ("broadcastTensor", {"root": 3}),
    ("reduceTensor", {"root": 2, "op": "max"}),
    ("allgatherTensor", {}),
    ("gatherTensor", {"root": 1}),
    ("scatterTensor", {"root": 5}),
    ("sendreceiveTensor", {"src": 2, "dst": 6}),
    ("reduce_scatterTensor", {}),
    ("alltoallTensor", {}),
]


def test_staged_collectives_match_direct(started):
    """Direct and staged on the port, each against the JAX compat's
    direct result; staged equal to direct bitwise, dtype included."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16, 4).astype(np.float32)
    t = torch.from_numpy(x)
    for name, kw in STAGED_CASES:
        want = getattr(jc, name)(x, **kw)
        fn = getattr(tc, name)
        direct = fn(t, **kw)
        tc.set_staged_collectives()
        try:
            assert torchmpi_tpu_torch.config().staged
            staged = fn(t, **kw)
        finally:
            tc.set_direct_collectives()
        _close(direct, want, f"{name} {kw}")
        assert staged.dtype == direct.dtype and torch.equal(staged, direct), \
            f"{name} {kw}"
    assert not torchmpi_tpu_torch.config().staged
    xi = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    want = jc.allreduceTensor(xi, op="mean")
    direct = tc.allreduceTensor(torch.from_numpy(xi), op="mean")
    tc.set_staged_collectives()
    try:
        staged = tc.allreduceTensor(torch.from_numpy(xi), op="mean")
    finally:
        tc.set_direct_collectives()
    assert direct.dtype == staged.dtype == torch.float32
    _close(direct, want)
    assert torch.equal(staged, direct)


def test_staged_async_roundtrip(started):
    x = np.stack([np.full(8, float(r), np.float32) for r in range(8)])
    t = torch.from_numpy(x)
    for mod in (tc, jc):
        mod.set_staged_collectives()
    try:
        out = tc.syncHandle(tc.async_.reduce_scatterTensor(t))
        _close(out, jc.syncHandle(jc.async_.reduce_scatterTensor(x)))
        assert torch.equal(out[3], torch.from_numpy(x.sum(axis=0)[3:4]))
        out2 = tc.syncHandle(tc.async_.alltoallTensor(t))
        _close(out2, jc.syncHandle(jc.async_.alltoallTensor(x)))
        assert torch.equal(out2[2], torch.arange(8.0))
    finally:
        for mod in (tc, jc):
            mod.set_direct_collectives()


def test_nn_namespace(started):
    w = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    rep = jc.nn.synchronizeParameters({"w": w})
    params = [torch.nn.Parameter(torch.from_numpy(w.copy()))]
    assert tc.nn.synchronizeParameters(params) is params
    _close(params[0].detach(), rep["w"])
    params[0].grad = torch.from_numpy(w * 2)
    jg = jax.jit(shard_map(
        lambda g: jc.nn.synchronizeGradients(g, ("dcn", "ici")),
        mesh=torchmpi_tpu.runtime.current_mesh(), in_specs=P(),
        out_specs=P(), check_vma=False))({"w": w * 2})
    tc.nn.synchronizeGradients(params)
    _close(params[0].grad, jg["w"])


def test_torch_tensor_inputs(started):
    """A migrating TorchMPI user's tensors are torch tensors: both compat
    modules take the same CPU torch stack."""
    t = torch.stack([torch.full((6,), float(r)) for r in range(8)])
    _close(tc.allreduceTensor(t), jc.allreduceTensor(t))
    _close(tc.broadcastTensor(t, root=3), jc.broadcastTensor(t, root=3))
    assert torch.equal(tc.broadcastTensor(t, root=3)[0], t[3])


def test_collective_selector_routes_the_tensor_verbs(started, tmp_path):
    """``collectiveSelector("pallas")`` sends ``allreduceTensor`` through
    the ring (its plain version on the CPU); ``"auto"`` through a plan
    measured on the first call, replayed after."""
    x = np.random.RandomState(2).randn(8, 4096).astype(np.float32)
    t = torch.from_numpy(x)
    want = jc.allreduceTensor(x)
    tc.set_min_bytes_for_custom(0)
    tc.collectiveSelector("pallas")
    _close(tc.allreduceTensor(t), want)
    assert planner.describe()[-1]["backend"] == "pallas"
    torchmpi_tpu_torch.set_config(tuning_plan_path=str(tmp_path / "p.json"))
    tc.collectiveSelector("auto")
    tuning.reset_measurement_count()
    _close(tc.allreduceTensor(t), want)
    _close(tc.allreduceTensor(t), want)
    assert tuning.measurement_count() == 1
    (e,) = tuning.plan().entries.values()
    assert planner.describe()[-1]["backend"] == e.backend
