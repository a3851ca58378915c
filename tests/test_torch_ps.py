"""The port's parameter server (torchmpi_tpu_torch/parallel/ps.py over its
own copy of the native transport) against the JAX package's on the CPU;
JAX's tests/test_parameterserver.py is the spec.

- ``flatten_f32`` of the same tree (float32, bfloat16, float16 leaves; as
  numpy arrays and as tensors) gives the JAX package's flat vector bit for
  bit, and lossy dtypes raise.
- A seeded sequence of ``copy`` / ``add`` / ``zero`` / ``axpy`` /
  ``elastic`` with several alphas through the JAX package's
  ``ParameterServer`` and the port's gives bitwise equal centers and
  elastic deltas, and both equal a numpy float32 fold of the same rules
  (the product and the sum rounded separately).
- Each behaviour of JAX's test file: rules, prefetch, concurrent clients
  with ``stats()``, same-client ordering, wrong size, shutdown, connect
  refused, partial shard failure, ping, the wedged server bounded by the
  timeout; and several threads sharing one client (the examples'
  pattern).

Every socket wait is bounded by a short ``ps_timeout_s`` (the module's
environment), and the tests that keep their servers alive share one.
"""

import os
import socket
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import parameterserver as jps
from torchmpi_tpu.utils import tree as jtree
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import parameterserver as tps
from torchmpi_tpu_torch.parallel import ps as tpsimpl
from torchmpi_tpu_torch.parallel.ps import PSClient, ShardedParameterServer
from torchmpi_tpu_torch.utils import tree as ttree

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """No runtime of either package, and a 5 s socket timeout."""
    jmpi.stop()
    tmpi.stop()
    old = os.environ.get("TORCHMPI_TPU_PS_TIMEOUT")
    os.environ["TORCHMPI_TPU_PS_TIMEOUT"] = "5"
    yield
    if old is None:
        os.environ.pop("TORCHMPI_TPU_PS_TIMEOUT", None)
    else:
        os.environ["TORCHMPI_TPU_PS_TIMEOUT"] = old
    tmpi.stop()
    jmpi.stop()


def tree_of(x, kind="torch"):
    t = {"w": np.full((4, 3), x, np.float32),
         "b": [np.full((5,), x * 2, np.float32)]}
    return to_kind(t, kind)


def to_kind(tree, kind):
    if kind == "numpy":
        return tree
    return {"w": torch.from_numpy(np.array(tree["w"])),
            "b": [torch.from_numpy(np.array(tree["b"][0]))]}


@pytest.fixture(scope="module")
def shared():
    """One port server (2 shards) of tree_of's shape, reset by each test
    with a copy."""
    ps = tps.init(tree_of(0.0), num_shards=2)
    yield ps
    ps.shutdown()


# --- the tree <-> flat vector ------------------------------------------------

def mixed_tree(seed=0):
    r = np.random.RandomState(seed)
    return {"z": r.randn(3, 4).astype(np.float32),
            "a": [r.randn(7).astype(ml_dtypes.bfloat16),
                  {"h": (r.randn(2, 5) * 1e3).astype(np.float16)}],
            "m": np.float32(r.randn())}


def torch_tree(t):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {"z": conv(t["z"]), "a": [conv(t["a"][0]), {"h": conv(
        t["a"][1]["h"])}], "m": conv(t["m"])}


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_flatten_matches_jax_bitwise(kind):
    t = mixed_tree()
    ref, _ = jtree.flatten_f32(t)
    flat, spec = ttree.flatten_f32(t if kind == "numpy" else torch_tree(t))
    flat = np.asarray(flat)
    assert flat.dtype == np.float32 and flat.shape == ref.shape
    np.testing.assert_array_equal(flat.view(np.uint32), ref.view(np.uint32))
    back = ttree.unflatten_f32(spec, ttree.flatten_f32(
        t if kind == "numpy" else torch_tree(t))[0])
    if kind == "numpy":
        assert back["a"][0].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(back["a"][0].view(np.uint16),
                                      t["a"][0].view(np.uint16))
        np.testing.assert_array_equal(back["a"][1]["h"], t["a"][1]["h"])
    else:
        assert back["a"][0].dtype == torch.bfloat16
        assert torch.equal(back["a"][0].view(torch.int16),
                           torch_tree(t)["a"][0].view(torch.int16))
        assert back["a"][1]["h"].dtype == torch.float16


def test_unflatten_rounds_bf16_as_jax():
    """A center that is not a bfloat16 value (after an ``add``) goes back to
    a numpy bfloat16 leaf rounded to nearest even, as JAX's cast does."""
    t = {"x": np.zeros(9, ml_dtypes.bfloat16)}
    flat = np.array([1.00390625, 1.01171875, -2.5e-3, 3e38, np.inf, -np.inf,
                     np.nan, 1.0 + 2 ** -9, 65504.7], np.float32)
    _, jspec = jtree.flatten_f32(t)
    _, tspec = ttree.flatten_f32(t)
    ref = jtree.unflatten_f32(jspec, flat)["x"]
    got = ttree.unflatten_f32(tspec, flat)["x"]
    np.testing.assert_array_equal(got.view(np.uint16)[:6],
                                  ref.view(np.uint16)[:6])
    assert np.isnan(got[6].astype(np.float32))
    np.testing.assert_array_equal(got.view(np.uint16)[7:],
                                  ref.view(np.uint16)[7:])


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.int64,
                                   torch.float64, torch.int32, torch.int64])
def test_flatten_lossy_dtype_raises(dtype):
    leaf = (np.ones((4,), dtype) if isinstance(dtype, type)
            else torch.ones(4, dtype=dtype))
    with pytest.raises(TypeError):
        ttree.flatten_f32({"x": leaf})


def test_flatten_mixed_leaves_raise():
    with pytest.raises(TypeError):
        ttree.flatten_f32({"a": torch.ones(2), "b": np.ones(2, np.float32)})


# --- the op sequence against the JAX package's server ---------------------

def _ops(seed):
    r = np.random.RandomState(seed)

    def vals(scale=1.0):
        return {"w": (r.randn(4, 3) * scale).astype(np.float32),
                "b": [(r.randn(5) * scale).astype(np.float32)]}

    return [("copy", 1.0, vals()), ("add", 1.0, vals(3.0)),
            ("axpy", 0.37, vals(0.1)), ("elastic", 0.25, vals()),
            ("axpy", -1.3, vals(7.0)), ("zero", 1.0, vals()),
            ("add", 1.0, vals(1e-3)), ("elastic", 0.9, vals(2.0)),
            ("axpy", 1 / 3, vals(1e4)), ("elastic", 0.1, vals(1e-2)),
            ("copy", 1.0, vals(5.0)), ("axpy", 1e-3, vals())]


def _fold(center, rule, alpha, p):
    """The server's rule in numpy float32 (two roundings, no FMA)."""
    a = np.float32(alpha)
    if rule == "copy":
        return p.copy(), None
    if rule == "add":
        return center + p, None
    if rule == "zero":
        return np.zeros_like(center), None
    if rule == "axpy":
        return center + a * p, None
    delta = a * (p - center)
    return center + delta, delta


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("shards", [1, 3])
def test_rule_sequence_bitwise_to_jax(kind, shards):
    ops = _ops(seed=shards)
    j = jps.init(ops[0][2], num_shards=shards)
    t = tps.init(to_kind(ops[0][2], kind), num_shards=shards)
    center = jtree.flatten_f32(ops[0][2])[0]
    try:
        for rule, alpha, vals in ops:
            p = jtree.flatten_f32(vals)[0]
            center, delta = _fold(center, rule, alpha, p)
            jd = j.send(vals, rule=rule, alpha=alpha).wait()
            td = t.send(to_kind(vals, kind), rule=rule, alpha=alpha).wait()
            jc = jtree.flatten_f32(j.receive().wait())[0]
            tc = np.asarray(ttree.flatten_f32(t.receive().wait())[0])
            np.testing.assert_array_equal(tc.view(np.uint32),
                                          jc.view(np.uint32), err_msg=rule)
            np.testing.assert_array_equal(tc.view(np.uint32),
                                          center.view(np.uint32),
                                          err_msg=rule)
            if rule == "elastic":
                jdf = jtree.flatten_f32(jd)[0]
                tdf = np.asarray(ttree.flatten_f32(td)[0])
                np.testing.assert_array_equal(tdf.view(np.uint32),
                                              jdf.view(np.uint32))
                np.testing.assert_array_equal(tdf.view(np.uint32),
                                              delta.view(np.uint32))
            else:
                assert td is None and jd is None
    finally:
        j.shutdown()
        t.shutdown()


# --- JAX's test_parameterserver.py behaviours ---------------------------------

def test_flatten_roundtrip():
    t = tree_of(1.5)
    flat, spec = ttree.flatten_f32(t)
    assert flat.shape == (17,)
    back = ttree.unflatten_f32(spec, flat)
    assert torch.equal(back["w"], t["w"]) and torch.equal(back["b"][0],
                                                          t["b"][0])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_bf16_tree_through_ps_bit_exact(kind):
    w = (np.arange(33, dtype=np.float32) / 3).astype(ml_dtypes.bfloat16)
    t = {"w": w} if kind == "numpy" else torch_tree(
        {"z": w, "a": [w, {"h": np.zeros(1, np.float16)}], "m": w})
    ps = tps.init(t, num_shards=2)
    try:
        got = ps.receive().wait()
        if kind == "numpy":
            assert got["w"].dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(got["w"].view(np.uint16),
                                          w.view(np.uint16))
        else:
            assert got["a"][0].dtype == torch.bfloat16
            assert torch.equal(got["a"][0].view(torch.int16),
                               t["a"][0].view(torch.int16))
    finally:
        ps.shutdown()


def test_wedged_server_bounded_failure(monkeypatch):
    """A server that accepts and reads but never responds surfaces as a
    failed op within the socket timeout, not a hang."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def black_hole():
        conn, _ = srv.accept()
        while not stop.is_set():
            if not conn.recv(4096):
                break
        conn.close()

    th = threading.Thread(target=black_hole, daemon=True)
    th.start()
    monkeypatch.setattr(tpsimpl, "_timeout_ms", lambda: 500)
    client = PSClient({"w": torch.zeros(8)}, [port], [(0, 8)])
    try:
        t0 = time.time()
        assert client.ping() == [False]
        assert time.time() - t0 < 10
    finally:
        stop.set()
        client.shutdown()
        srv.close()


def test_init_copy_and_receive():
    ps = tps.init(tree_of(3.0), num_shards=2)
    try:
        got = ps.receive().wait()
        assert torch.equal(got["w"], torch.full((4, 3), 3.0))
        assert torch.equal(got["b"][0], torch.full((5,), 6.0))
    finally:
        ps.shutdown()


def test_add_rule_accumulates(shared):
    shared.send(tree_of(0.0), rule="copy").wait()
    for _ in range(4):
        shared.send(tree_of(1.0), rule="add").wait()
    got = shared.receive().wait()
    assert torch.equal(got["w"], torch.full((4, 3), 4.0))
    assert torch.equal(got["b"][0], torch.full((5,), 8.0))


def test_zero_and_copy_rules(shared):
    shared.send(tree_of(5.0), rule="copy").wait()
    shared.send(tree_of(0.0), rule="zero").wait()
    assert torch.equal(shared.receive().wait()["w"], torch.zeros(4, 3))
    shared.send(tree_of(7.0), rule="copy").wait()
    assert torch.equal(shared.receive().wait()["b"][0], torch.full((5,),
                                                                   14.0))


def test_axpy_rule(shared):
    shared.send(tree_of(1.0), rule="copy").wait()
    shared.send(tree_of(2.0), rule="axpy", alpha=0.5).wait()
    assert torch.equal(shared.receive().wait()["w"], torch.full((4, 3), 2.0))


def test_elastic_rule_symmetric(shared):
    """EASGD: center c, client x; delta = a (x - c); c += delta; the client
    applies x -= delta, so both move toward each other equally."""
    shared.send(tree_of(0.0), rule="copy").wait()
    x = tree_of(1.0)
    delta = shared.send(x, rule="elastic", alpha=0.25).wait()
    assert torch.equal(delta["w"], torch.full((4, 3), 0.25))
    assert torch.equal(shared.receive().wait()["w"], torch.full((4, 3),
                                                                0.25))
    assert torch.equal(x["w"] - delta["w"], torch.full((4, 3), 0.75))


def test_async_prefetch_pattern(shared):
    """Start a receive (prefetch), compute, then sync."""
    shared.send(tree_of(2.0), rule="copy").wait()
    h = shared.receive()
    _ = torch.ones(64, 64) @ torch.ones(64, 64)  # "compute"
    got = h.wait()
    assert torch.equal(got["w"], torch.full((4, 3), 2.0))
    assert h.done
    assert tps.sync_handle(h) is got


def test_concurrent_clients_add_and_stats():
    """k clients send ``add`` concurrently: the shard holds the sum; the
    server's cycle-cost counters are exact at quiescence."""
    template = tree_of(0.0)
    _, spec = ttree.flatten_f32(template)
    servers = ShardedParameterServer(spec.total, num_shards=2)
    k, iters = 4, 8
    try:
        def worker():
            c = PSClient(template, servers.ports, servers.shard_bounds)
            for _ in range(iters):
                c.send(tree_of(1.0), rule="add").wait()
            c.shutdown()

        threads = [threading.Thread(target=worker) for _ in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        reader = PSClient(template, servers.ports, servers.shard_bounds)
        got = reader.receive().wait()
        assert torch.equal(got["w"], torch.full((4, 3), float(k * iters)))
        reader.shutdown()
        assert servers.ops_served() >= k * iters
        st = servers.stats()
        n_exchanges = k * iters + 1  # the sends and the reader's receive
        assert st["ops"] == n_exchanges * servers.num_shards
        assert st["bytes_in"] == k * iters * spec.total * 4
        assert st["elastic_bytes_out"] == 0
        assert st["bytes_out"] >= st["ops"] - (k + 1) * servers.num_shards
        for key in ("recv_s", "apply_s", "send_s"):
            assert st[key] > 0.0, st
        assert st["lock_wait_s"] >= 0.0
        assert st["recv_s"] + st["lock_wait_s"] + st["apply_s"] \
            + st["send_s"] < 60.0
    finally:
        servers.shutdown()


def test_threads_share_one_client(shared):
    """More worker threads than cores push through one client at once (the
    examples' pattern), with a short switch interval: the center is the
    exact sum (a lost or doubled push would break it), and every push and
    fetch resolves in bounded time."""
    shared.send(tree_of(0.0), rule="copy").wait()
    k, iters = (os.cpu_count() or 1) + 2, 6
    errors = []

    def worker(i):
        try:
            hs = [shared.send(tree_of(float(i + 1)), rule="add")
                  for _ in range(iters)]
            shared.receive().wait()
            for h in hs:
                h.wait()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    total = float(iters * sum(range(1, k + 1)))  # exact in float32
    assert torch.equal(shared.receive().wait()["w"], torch.full((4, 3),
                                                                total))


def test_send_ordering_same_client(shared):
    """Ops on one client connection run in submission order: copy(9) then
    add(1) gives 10, never 9."""
    h1 = shared.send(tree_of(9.0), rule="copy")
    h2 = shared.send(tree_of(1.0), rule="add")
    h1.wait()
    h2.wait()
    assert torch.equal(shared.receive().wait()["w"], torch.full((4, 3),
                                                                10.0))


def test_wrong_size_rejected(shared):
    with pytest.raises(ValueError):
        shared.send({"w": torch.zeros(2, 2)})


def test_stats_refuse_obs(shared):
    """``Config.obs`` other than "off" (refused before the telemetry layer
    was ported): ``stats()`` now feeds the registry, each snapshot's
    deltas against the previous one as monotone ``tm_ps_*_total``
    counters (JAX ``tests/test_obs.py::test_ps_stats_retry_and_registry``
    :433)."""
    tmpi.init(device="cpu", obs="metrics")
    try:
        from torchmpi_tpu_torch import obs

        obs.reset()
        shared.send(tree_of(0.0), rule="add").wait()
        s1 = shared.stats()
        assert s1["ops"] >= 1
        s2 = shared.stats()
        assert all(s2[k] >= s1[k] for k in s1)
        reg = obs.registry()
        assert reg.counter_total("tm_ps_ops_total") == s2["ops"]
        assert reg.counter_total("tm_ps_bytes_in_total") == s2["bytes_in"]
    finally:
        tmpi.stop()
        obs.deactivate()
        obs.reset()


def test_server_shutdown_fails_client_ops():
    ps = tps.init(tree_of(1.0), num_shards=2)
    try:
        ps.servers.shutdown()  # kill every shard server mid-run
        h = ps.send(tree_of(1.0), rule="add")
        with pytest.raises(RuntimeError):
            h.wait()
        assert h.done  # a failed handle stays failed, and done
        with pytest.raises(RuntimeError):
            h.wait()
    finally:
        ps.client.shutdown()


def test_connect_refused():
    with pytest.raises(RuntimeError):
        PSClient(tree_of(0.0), ports=[1], shard_bounds=[(0, 17)])


def test_partial_shard_failure():
    """One of two shard servers killed: ops touching it fail, the surviving
    shard's futures drain without deadlock."""
    template = tree_of(0.0)
    _, spec = ttree.flatten_f32(template)
    servers = ShardedParameterServer(spec.total, num_shards=2)
    client = PSClient(template, servers.ports, servers.shard_bounds)
    try:
        client.send(template, rule="copy").wait()  # healthy
        servers._lib.tm_ps_server_destroy(servers.server_ids[1])
        servers.server_ids = servers.server_ids[:1]
        h = client.send(tree_of(2.0), rule="copy")
        with pytest.raises(RuntimeError):
            h.wait()
        r = client.receive()
        with pytest.raises(RuntimeError):
            r.wait()
        assert r.failed_index is not None
    finally:
        client.shutdown()
        servers.shutdown()


def test_ping_health_check():
    ps = tps.init(tree_of(0.0), num_shards=3)
    try:
        assert ps.healthy()
        assert ps.client.ping() == [True, True, True]
        ps.servers._lib.tm_ps_server_destroy(ps.servers.server_ids[1])
        ps.servers.server_ids = (ps.servers.server_ids[:1]
                                 + ps.servers.server_ids[2:])
        alive = ps.client.ping()
        assert alive[1] is False and alive[0] and alive[2]
        assert not ps.healthy()
    finally:
        ps.shutdown()


def test_send_after_shutdown_raises():
    ps = tps.init(tree_of(0.0), num_shards=2)
    ps.shutdown()
    with pytest.raises(RuntimeError):
        ps.send(tree_of(1.0))
    with pytest.raises(RuntimeError):
        ps.receive()


# --- the timeout knob ---------------------------------------------------------

def test_timeout_from_config_and_environment(monkeypatch):
    """``_timeout_ms``: the environment without a runtime (the legacy
    millisecond spelling too), ``Config.ps_timeout_s`` with one, which
    ``init`` takes from the environment when the field is left at its
    default; negative raises, from a field or from the environment (one
    policy, ``config.ps_timeout_s``)."""
    monkeypatch.setenv("TORCHMPI_TPU_PS_TIMEOUT", "2.5")
    assert tpsimpl._timeout_ms() == 2500
    monkeypatch.delenv("TORCHMPI_TPU_PS_TIMEOUT")
    monkeypatch.setenv("TORCHMPI_TPU_PS_TIMEOUT_MS", "700")
    assert tpsimpl._timeout_ms() == 700
    tmpi.init(tmpi.Config(), device="cpu")
    try:
        assert tmpi.config().ps_timeout_s == 0.7
        assert tpsimpl._timeout_ms() == 700
        tmpi.set_config(ps_timeout_s=3.0)
        assert tpsimpl._timeout_ms() == 3000
        with pytest.raises(ValueError):
            tmpi.set_config(ps_timeout_s=-1.0)
    finally:
        tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_PS_TIMEOUT", "4")
    tmpi.init(tmpi.Config(ps_timeout_s=9.0), device="cpu")
    try:
        assert tmpi.config().ps_timeout_s == 9.0  # explicit wins
    finally:
        tmpi.stop()
    with pytest.raises(ValueError):
        tmpi.init(device="cpu", ps_timeout_s=-1.0)
    assert tmpi.Config.from_env().ps_timeout_s == 4.0
    monkeypatch.setenv("TORCHMPI_TPU_PS_TIMEOUT", "-2")
    with pytest.raises(ValueError):
        tpsimpl._timeout_ms()


def test_host_libraries_are_the_ports_own():
    """The port builds its own copies of the transport and the writer
    into build/torch_host/ (never the JAX package's build/libtorchmpi_*),
    each library named by a digest of its source, compiler and flags."""
    from torchmpi_tpu_torch.utils import native

    for name in native.LIBS:
        path = native.build(name)
        assert path.parent.name == "torch_host" and path.exists()
        assert path.name.startswith(f"lib{name}-")
        assert "libtorchmpi" not in path.name
        assert (native.CSRC / f"{name}.cpp").exists()
    assert "-march=native" not in native.CXX_FLAGS
    assert "-ffast-math" not in native.CXX_FLAGS
