"""The port's N-D world and communicator stack (torchmpi_tpu_torch/runtime.py:
``Config.mesh_shape``, ``push_communicator`` / ``pop_communicator`` /
``communicator``) in one process, rank-major, against the JAX package.

The cases of tests/test_runtime.py :29-124 (the first-class N-D init, the
wildcard and the errors with JAX's messages, the environment parse, the
stack, the cached re-push, the context manager with a shape, a collective
on a sub-communicator), the planner's pushed-communicator key
(tests/test_planner.py :256-270) and ``resynchronize_parameters_in_axis``,
each on the same inputs as JAX's.  In this world of one process a
communicator's sizes shape the rank-major stacks; its process-world view
is all ones.  The process world of several ranks is
tests/test_torch_nd_world_procs.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu import collectives as jcoll
from torchmpi_tpu import planner as jplanner
from torchmpi_tpu.parallel import gradsync as jgs
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import planner as tplanner
from torchmpi_tpu_torch import runtime as truntime
from torchmpi_tpu_torch.parallel import gradsync as tgs

torch.set_num_threads(2)

N = 8


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
    jmpi.stop()
    tmpi.stop()


@pytest.fixture
def both():
    """Both runtimes on their flat worlds (JAX 1 x 8; the port a world of
    one gloo process, rank-major stacks of any size)."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    tmpi.init(device="cpu")
    yield
    tmpi.stop()
    jmpi.stop()


def _jax_error(cfg):
    jmpi.stop()
    with pytest.raises(ValueError) as e:
        jmpi.init(jmpi.Config(**cfg))
    jmpi.stop()
    return str(e.value)


def test_mesh_shape_first_class_init():
    """``Config(mesh_shape=...)`` names the world's axes at init; the
    verbs ride them with no further setup."""
    tmpi.stop()
    jmpi.stop()
    mesh = jmpi.init(jmpi.Config(mesh_shape={"pp": 2, "tp": 2, "dp": 2}))
    tmpi.init(tmpi.Config(mesh_shape={"pp": 2, "tp": 2, "dp": 2}),
              device="cpu")
    try:
        world = truntime.world_communicator()
        assert world.axes == mesh.axis_names == ("pp", "tp", "dp")
        assert truntime.world_shape(N) == dict(mesh.shape)
        assert truntime.world_shape() == {"pp": 1, "tp": 1, "dp": 1}
        assert truntime.current_communicator() is world
        assert truntime.current_communicator_name() == "world"
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        want = np.asarray(jmpi.allreduce(x))
        got = tmpi.allreduce_rank_major(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
        # One axis and two: each group of the stack, as JAX's in-axis
        # verbs under shard_map.
        for axes in ("tp", ("pp", "dp")):
            def body(v, axes=axes):
                return jcoll.allreduce_in_axis(v, axes)

            jw = np.asarray(jax.jit(shard_map(
                body, mesh=mesh, in_specs=P(("pp", "tp", "dp")),
                out_specs=P(("pp", "tp", "dp")), check_vma=False))(
                jax.device_put(x, NamedSharding(mesh, P(("pp", "tp",
                                                         "dp"))))))
            tw = tmpi.allreduce_rank_major(torch.from_numpy(x),
                                           axis_names=axes)
            np.testing.assert_array_equal(tw.numpy(), jw)
        with pytest.raises(ValueError, match="leading .rank. axis must have "
                                             "length 8"):
            tmpi.allreduce_rank_major(torch.zeros(4, 1))
        with pytest.raises(ValueError, match="unknown axis 'ici'.*'pp', "
                                             "'tp', 'dp'"):
            tmpi.allreduce_rank_major(torch.zeros(8, 1), axis_names="ici")
        with pytest.raises(ValueError, match="fixed at init"):
            tmpi.set_config(mesh_shape={"a": 8})
        assert truntime.grid(N) == (1, N)
    finally:
        tmpi.stop()
        jmpi.stop()


def test_mesh_shape_wildcard_and_errors():
    """The wildcard, and the four errors with JAX's messages: two
    wildcards, sizes that do not cover the ranks, the two-level fields
    beside ``mesh_shape``, an empty dict."""
    tmpi.stop()
    tmpi.init(tmpi.Config(mesh_shape={"dp": -1, "tp": 4}), device="cpu")
    assert truntime.world_shape(N) == {"dp": 2, "tp": 4}
    assert truntime.world_shape(16) == {"dp": 4, "tp": 4}
    with pytest.raises(ValueError, match="cannot be inferred over 6"):
        truntime.world_shape(6)
    tmpi.stop()
    for cfg in ({"mesh_shape": {"a": -1, "b": -1}},
                {"mesh_shape": {"a": 8}, "ici_size": 8},
                {"mesh_shape": {}}):
        with pytest.raises(ValueError) as e:
            tmpi.init(tmpi.Config(**cfg), device="cpu")
        tmpi.stop()
        assert str(e.value) == _jax_error(cfg)
    # Coverage is a property of the stack in a world of one process.
    tmpi.init(tmpi.Config(mesh_shape={"a": 3, "b": 2}), device="cpu")
    with pytest.raises(ValueError) as e:
        truntime.world_shape(N)
    tmpi.stop()
    assert str(e.value) == _jax_error({"mesh_shape": {"a": 3, "b": 2}})


def test_mesh_shape_from_env(monkeypatch):
    monkeypatch.setenv("TORCHMPI_TPU_MESH_SHAPE", "pp=2,rest=-1")
    cfg = tmpi.Config.from_env()
    assert cfg.mesh_shape == jmpi.Config.from_env().mesh_shape == {
        "pp": 2, "rest": -1}
    tmpi.stop()
    tmpi.init(cfg, device="cpu")
    try:
        assert truntime.world_communicator().axes == ("pp", "rest")
        assert truntime.world_shape(N) == {"pp": 2, "rest": 4}
    finally:
        tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_MESH_SHAPE", "garbage")
    with pytest.raises(ValueError) as e:
        tmpi.Config.from_env()
    with pytest.raises(ValueError) as j:
        jmpi.Config.from_env()
    assert str(e.value) == str(j.value)


def test_communicator_stack(both):
    world = truntime.current_communicator()
    sub = tmpi.push_communicator("first_half", devices=[0, 1, 2, 3])
    assert truntime.current_communicator() is sub
    assert sub.size(4) == 4 and sub.axes == ("ici",)
    assert sub.fixed_size() == 4
    tmpi.pop_communicator()
    assert truntime.current_communicator() is world
    again = tmpi.push_communicator("first_half")
    assert again is sub
    tmpi.pop_communicator()
    with pytest.raises(RuntimeError, match="cannot pop the world"):
        tmpi.pop_communicator()
    with pytest.raises(KeyError):
        tmpi.push_communicator("never_made")
    with pytest.raises(ValueError, match="does not cover 4 devices"):
        tmpi.push_communicator("bad", devices=[0, 1, 2, 3],
                               shape={"a": 3})
    assert truntime.current_communicator() is world
    # The same on JAX's side, for the record of the semantics.
    jworld = jmpi.world_mesh()
    jsub = jmpi.push_communicator("first_half",
                                  devices=list(jworld.devices.flat)[:4])
    assert jsub.devices.size == sub.size(4)
    jmpi.pop_communicator()


def test_communicator_context_and_shape(both):
    with tmpi.communicator("grid", shape={"a": 2, "b": 4}) as c:
        assert c.axes == ("a", "b")
        assert c.shape(N) == {"a": 2, "b": 4}
        assert truntime.current_communicator_name() == "grid"
        with jmpi.communicator("grid", shape={"a": 2, "b": 4}) as m:
            assert c.axes == m.axis_names
            assert tuple(c.sizes(N)) == m.devices.shape
        assert truntime.grid(N) == (1, N)
    assert truntime.current_communicator() is truntime.world_communicator()
    # A pushed (dcn, ici) grid is two-level, as the world's.
    with tmpi.communicator("two", shape={"dcn": 2, "ici": 4}):
        assert truntime.grid(N) == (2, 4)


def test_collective_on_sub_communicator(both):
    devs = list(jmpi.world_mesh().devices.flat)
    x = np.arange(4, dtype=np.float32).reshape(4, 1)
    with jmpi.communicator("half", devices=devs[:4]):
        want = np.asarray(jmpi.allreduce(x))
    with tmpi.communicator("half", devices=[0, 1, 2, 3]):
        got = tmpi.allreduce_rank_major(torch.from_numpy(x))
        with pytest.raises(ValueError, match="length 4"):
            tmpi.allreduce_rank_major(torch.zeros(8, 1))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.full((4, 1), 6.0))


def test_pushed_communicator_is_its_own_key(both):
    """A pushed communicator is part of every plan key: the sub-stack's call
    plans once (one miss), and the world's plan hits again after the
    pop.  JAX's planner counts the same."""
    x = np.random.RandomState(0).randn(N, 64).astype(np.float32)
    t = torch.from_numpy(x)
    for mpi, planner, run, devs in (
            (jmpi, jplanner, lambda v: np.asarray(jmpi.allreduce(v)),
             list(jmpi.world_mesh().devices.flat)[:4]),
            (tmpi, tplanner, lambda v: tmpi.allreduce_rank_major(v).numpy(),
             [0, 1, 2, 3])):
        v = x if mpi is jmpi else t
        run(v)
        planner.reset_stats()
        with mpi.communicator("half", devices=devs, shape={"ici": 4}):
            out = run(v[:4])
        np.testing.assert_allclose(out[0], x[:4].sum(axis=0), rtol=1e-5)
        assert planner.stats()["misses"] == 1
        run(v)
        assert planner.stats()["hits"] >= 1


def test_identical_repush_hits_the_plans(both):
    """A second push of the same communicator under its key plans nothing
    anew (JAX's ``Mesh`` compares by value, the port's ``Communicator`` by
    ``ident``) and is the cached communicator; a changed push under the
    same key plans anew."""
    x = np.random.RandomState(1).randn(N, 64).astype(np.float32)
    t = torch.from_numpy(x)
    for mpi, planner, run, devs in (
            (jmpi, jplanner, lambda v: np.asarray(jmpi.allreduce(v)),
             list(jmpi.world_mesh().devices.flat)[:4]),
            (tmpi, tplanner, lambda v: tmpi.allreduce_rank_major(v).numpy(),
             [0, 1, 2, 3])):
        v = x if mpi is jmpi else t
        with mpi.communicator("half", devices=devs, shape={"ici": 4}) as a:
            run(v[:4])
        planner.reset_stats()
        with mpi.communicator("half", devices=devs, shape={"ici": 4}) as b:
            out = run(v[:4])
        np.testing.assert_allclose(out[0], x[:4].sum(axis=0), rtol=1e-5)
        assert planner.stats()["misses"] == 0
        assert planner.stats()["hits"] == 1
        with mpi.communicator("half", devices=devs, shape={"a": 2, "b": 2}):
            run(v[:4])
        assert planner.stats()["misses"] == 1
        if mpi is tmpi:
            assert b is a
            assert truntime.current_communicator() is \
                truntime.world_communicator()


def test_resynchronize_parameters_in_axis_matches_jax():
    """The in-axis broadcast of a tree from ``root`` of "ici" on the 2 x 4
    grid: the rank-major form against JAX's under ``shard_map``; the
    process-world form in this world of one is the tree itself."""
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=2))
    tmpi.init(tmpi.Config(dcn_size=2), device="cpu")
    try:
        rng = np.random.RandomState(1)
        tree = {"w": rng.randn(N, 3, 2).astype(np.float32),
                "b": [rng.randn(N, 5).astype(np.float32)]}
        mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 4), ("dcn", "ici"))
        spec = P(("dcn", "ici"))

        def body(t):
            return jgs.resynchronize_parameters_in_axis(t, "ici", root=2)

        want = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                                 out_specs=spec, check_vma=False))(
            jax.tree.map(lambda a: jax.device_put(
                a, NamedSharding(mesh, spec)), tree))
        got = tgs.resynchronize_parameters_in_axis_rank_major(
            {"w": torch.from_numpy(tree["w"]),
             "b": [torch.from_numpy(tree["b"][0])]}, "ici", root=2)
        np.testing.assert_array_equal(got["w"].numpy(),
                                      np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"][0].numpy(),
                                      np.asarray(want["b"][0]))
        one = {"w": torch.ones(3)}
        assert torch.equal(tgs.resynchronize_parameters_in_axis(
            one, "ici")["w"], one["w"])
    finally:
        tmpi.stop()
        jmpi.stop()
