"""The port's asynchronous collectives (torchmpi_tpu_torch/collectives.py:
``AsyncHandle``, ``sync_handle``, ``wait_all``, ``async_``,
``async_in_axis``) against the JAX package on the CPU: the async cases of
``tests/test_collectives.py`` :242-351.

Each rank's tensor f(rank) from a seed on the JAX package's 8-device mesh;
the port's handles over the same rank-major stack (direct: computed at
dispatch on CPU tensors; staged: on the one staged worker thread).
Results held to JAX's handles (float32 within rtol 1e-6, the sums'
association aside) and to the port's own synchronous verbs bitwise.
"""

import threading

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import collectives as tcoll

torch.set_num_threads(2)

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


def rank_data(size, dtype=np.float32, n=N, seed=0):
    base = np.random.RandomState(seed).randn(size)
    return np.stack([(base + r).astype(dtype) for r in range(n)])


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


VERBS = {"allreduce": {}, "broadcast": {"root": 3}, "reduce": {"root": 5},
         "allgather": {}, "reduce_scatter": {}, "gather": {"root": 4},
         "scatter": {"root": 6}, "sendreceive": {"src": 2, "dst": 7},
         "alltoall": {}}


@pytest.mark.parametrize("staged", [False, True], ids=["direct", "staged"])
@pytest.mark.parametrize("verb", list(VERBS))
def test_async_verb_matches_jax_and_sync(verb, staged):
    x = rank_data(64, seed=len(verb))
    params = VERBS[verb]
    h = getattr(tmpi.async_, verb)(t(x), staged=staged, **params)
    assert isinstance(h, tmpi.AsyncHandle) and h.op == verb
    got = tmpi.sync_handle(h)
    assert h.done and h.error is None
    jh = getattr(jmpi.async_, verb)(x, **params)
    np.testing.assert_allclose(got.numpy(), np.asarray(jh.wait()),
                               rtol=1e-6, atol=1e-6)
    sync = getattr(tmpi, f"{verb}_rank_major")(t(x), **params)
    assert torch.equal(got, sync)


def test_async_ordering_same_tensor():
    x = rank_data(64)
    h1 = tmpi.async_.allreduce(t(x))
    h2 = tmpi.async_.allreduce(h1.wait())
    want = np.asarray(jmpi.async_.allreduce(
        jmpi.async_.allreduce(x).wait()).wait())
    np.testing.assert_allclose(tmpi.sync_handle(h2).numpy(), want,
                               rtol=1e-6)


def test_async_many_inflight():
    xs = [rank_data(128) + i for i in range(6)]
    handles = [tmpi.async_.allreduce(t(x), staged=i % 2 == 1)
               for i, x in enumerate(xs)]
    for x, h in zip(xs, handles):
        np.testing.assert_allclose(h.wait()[0].numpy(), x.sum(0),
                                   rtol=1e-6, atol=1e-6)


def test_async_staged_and_direct_match_sync_bitwise():
    x = t(rank_data(1000))
    for verb in ("allreduce", "broadcast", "reduce_scatter"):
        sync = getattr(tmpi, f"{verb}_rank_major")(x)
        for kw in ({"backend": "host"}, {"staged": True}, {}):
            out = getattr(tmpi.async_, verb)(x, **kw).wait()
            assert torch.equal(out, sync), (verb, kw)
    # The ring ("pallas", its plain version on CPU tensors) likewise.
    assert torch.equal(tmpi.async_.allreduce(x, backend="pallas").wait(),
                       tmpi.allreduce_rank_major(x, backend="pallas"))


def test_wait_all_returns_input_order():
    xs = [rank_data(64) + i for i in range(5)]
    handles = [tmpi.async_.allreduce(t(x), backend="host" if i % 2
                                     else None)
               for i, x in enumerate(xs)]
    outs = tmpi.wait_all(handles)
    assert len(outs) == len(xs)
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(o[0].numpy(), x.sum(0), rtol=1e-6,
                                   atol=1e-6)
    assert all(h.done for h in handles)


def test_wait_all_surfaces_first_error():
    good = t(rank_data(64))
    bad = t(rank_data(3).reshape(N, 3))  # 3 % 8 != 0
    hs = [tmpi.async_.allreduce(good, backend="host"),
          tmpi.async_.scatter(bad, backend="host"),
          tmpi.async_.scatter(bad),
          tmpi.async_.allreduce(good, backend="host")]
    with pytest.raises(ValueError, match="divisible"):
        tmpi.wait_all(hs)
    assert all(h.done for h in hs)
    assert hs[1].error is not None and hs[2].error is not None
    assert torch.equal(hs[0].wait(), tmpi.allreduce_rank_major(good))
    assert torch.equal(hs[3].wait(), hs[0].wait())


@pytest.mark.parametrize("staged", [False, True], ids=["direct", "staged"])
def test_async_done_surfaces_error(staged):
    bad = t(rank_data(3).reshape(N, 3))
    h = tmpi.async_.scatter(bad, staged=staged)
    for _ in range(500):
        if h.done:
            break
        threading.Event().wait(0.01)
    assert h.done
    assert isinstance(h.error, ValueError)
    for _ in range(2):  # every wait re-raises
        with pytest.raises(ValueError, match="divisible"):
            h.wait()


def test_async_staged_donate_releases_input():
    x = t(rank_data(256)).clone()
    ref = tmpi.allreduce_rank_major(x, backend="host")
    h = tmpi.async_.allreduce(x, backend="host", donate=True)
    out = h.wait()
    assert torch.equal(out, ref)
    assert x.untyped_storage().size() == 0  # the worker released it
    with pytest.raises(ValueError, match="does not own"):
        tmpi.async_.allreduce(t(rank_data(4)), staged=True, donate=True)


def test_async_in_axis_deferred_wait():
    """The process-world handle is issued at the call and waited later,
    with other work in between (a world of one process here; two gloo
    ranks in test_torch_verbs.py)."""
    x = torch.arange(8.0)
    h = tmpi.async_in_axis.allreduce(x, ("dcn", "ici"), op="mean")
    y = (x * 2).sum()  # work between dispatch and wait
    assert torch.equal(h.wait(), tmpi.allreduce_in_axis(x, op="mean"))
    assert float(y) == 56.0
    hs = [getattr(tmpi.async_in_axis, v)(x, **({"src": 0, "dst": 0}
                                               if v == "sendreceive"
                                               else {}))
          for v in tcoll.VERBS]
    assert len(tmpi.wait_all(hs)) == len(tcoll.VERBS)
    with pytest.raises(NotImplementedError, match="queue A, item 1"):
        tmpi.async_in_axis.allreduce(x, "ici")


def test_timeout_raises_peer_timeout_error():
    """A staged handle queued behind a stalled worker: ``wait(timeout_s)``
    and ``wait_all(timeout_s)`` raise PeerTimeoutError instead of
    blocking; once the worker moves on, the same handle completes."""
    gate = threading.Event()
    stall = tcoll._staged_executor().submit(gate.wait, 30)
    try:
        h = tmpi.async_.allreduce(t(rank_data(16)), staged=True)
        assert not h.done
        with pytest.raises(tmpi.PeerTimeoutError, match="async.wait"):
            h.wait(timeout_s=0.05)
        with pytest.raises(tmpi.PeerTimeoutError) as e:
            tmpi.wait_all([tmpi.async_.broadcast(t(rank_data(4))), h],
                          timeout_s=0.05)
        assert 0 < e.value.deadline_s <= 0.05  # the budget left
    finally:
        gate.set()
    stall.result()
    assert torch.equal(h.wait(timeout_s=30),
                       tmpi.allreduce_rank_major(t(rank_data(16))))
