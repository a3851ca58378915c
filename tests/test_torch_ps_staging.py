"""The parameter server's card path (torchmpi_tpu_torch/parallel/ps.py):
trees of tensors on the card staged through pinned host memory.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_ps_staging.py -q

At a small size, the checks that chip_smoke.py's ``downpour_ps`` phase
makes at full width:

(a) one worker, three ``axpy`` pushes: the center equals a numpy float32
    fold of the pushed updates (``c += alpha * u``, two roundings), bitwise;
(b) ``receive()`` returns the center bitwise, carried back onto the card;
(c) two pushes sent back to back from one thread with different values
    give their bitwise sum: the thread's pinned buffer is not overwritten
    before the first push's payload was taken;
(d) two threads pushing concurrently through one client, each on its own
    stream, give the bitwise sum of both;
(e) one ``elastic`` exchange equals the server's formula in numpy
    (``delta = alpha * (p - c)``, ``c += delta``), on the center and on the
    returned delta, bitwise;

and a push costs exactly one host synchronization (the wait for its
device-to-host copy), a bfloat16 tree round-trips bit-exactly on the card,
and the fetch's pinned buffers come back to the pool.
"""

import threading

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch import parameterserver as tps
from torchmpi_tpu_torch.utils import tree as ttree

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the card path stages through pinned "
                    "host memory)")
    return torch.device("cuda")


def _tree(dev, seed, scale=1.0):
    g = torch.Generator(dev).manual_seed(seed)
    return {"a": torch.randn(300, 301, device=dev, generator=g) * scale,
            "b": [torch.randn(1000, device=dev, generator=g) * scale],
            "c": torch.randn(7, device=dev, generator=g) * scale}


def _zeros(dev):
    return {"a": torch.zeros(300, 301, device=dev),
            "b": [torch.zeros(1000, device=dev)],
            "c": torch.zeros(7, device=dev)}


def _host(tree) -> np.ndarray:
    """The flat float32 vector of a tree, on the host."""
    return ttree.flatten_f32(tree)[0].cpu().numpy()


def _center(ps):
    got = ps.receive().wait()
    assert got["a"].is_cuda
    return _host(got)


def _eq(a, b):
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _count_event_waits(monkeypatch) -> list:
    """From here on, one entry a ``torch.cuda.Event.synchronize`` call: the
    push's wait for its device-to-host copy, which the sync debug mode does
    not see."""
    calls = []
    event_sync = torch.cuda.Event.synchronize

    def counted(event):
        calls.append(1)
        return event_sync(event)

    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted)
    return calls


@pytest.mark.parametrize("shards", [1, 4])
def test_axpy_pushes_fold_bitwise(cuda, shards, monkeypatch):
    """(a) and (b), and one host sync a push: one event wait and nothing
    the sync debug mode sees."""
    c0 = _tree(cuda, 0)
    ps = tps.init(c0, num_shards=shards)
    try:
        center = _host(c0)
        ps.client.reset_staging()
        alpha = np.float32(0.37)
        us = [_tree(cuda, 10 + s, scale=1e-2) for s in range(3)]
        waits = _count_event_waits(monkeypatch)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for u in us:
                ps.send(u, rule="axpy", alpha=float(alpha))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert len(waits) == 3
        for u in us:
            center = center + alpha * _host(u)
        got = _center(ps)
        _eq(got, center)
        st = ps.client.staging()
        assert st["pushes"] == 3
        assert st["fetches"] == 1 and st["fetch_h2d_ms"] > 0.0
    finally:
        ps.shutdown()


def test_back_to_back_pushes_sum(cuda):
    """(c): the second push's copy into the thread's pinned buffer comes
    after the first push's payload was taken."""
    ps = tps.init(_zeros(cuda), num_shards=4)
    try:
        u1, u2 = _tree(cuda, 1), _tree(cuda, 2)
        h1 = ps.send(u1, rule="add")
        h2 = ps.send(u2, rule="add")
        h1.wait()
        h2.wait()
        _eq(_center(ps), _host(u1) + _host(u2))
    finally:
        ps.shutdown()


def _exact_tree(dev, seed):
    """Small integers times 1/4: every sum of a few is exact in float32, in
    any order."""
    g = torch.Generator(dev).manual_seed(seed)
    t = _zeros(dev)
    return {"a": torch.randint(-64, 64, t["a"].shape, device=dev,
                               generator=g) * 0.25,
            "b": [torch.randint(-64, 64, (1000,), device=dev,
                                generator=g) * 0.25],
            "c": torch.randint(-64, 64, (7,), device=dev,
                               generator=g) * 0.25}


def test_two_threads_share_one_client(cuda):
    """(d): each thread on its own stream with its own pinned buffer, three
    pushes each, interleaved in any order on the shards; the values' sums
    are exact in any order, so the center is their sum bit for bit."""
    ps = tps.init(_zeros(cuda), num_shards=4)
    us = [[_exact_tree(cuda, 10 * i + k) for k in range(3)] for i in range(2)]
    torch.cuda.synchronize()
    ps.client.reset_staging()  # init's copy of the template is a push
    errors = []

    def worker(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                hs = [ps.send(u, rule="add") for u in us[i]]
                for h in hs:
                    h.wait()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        want = sum(_host(u) for ui in us for u in ui)
        _eq(_center(ps), want.astype(np.float32))
        assert ps.client.staging()["pushes"] == 6
    finally:
        ps.shutdown()


def test_elastic_exchange_bitwise(cuda):
    """(e)"""
    c0 = _tree(cuda, 5)
    ps = tps.init(c0, num_shards=4)
    try:
        p = _tree(cuda, 6)
        alpha = np.float32(0.3)
        delta = ps.send(p, rule="elastic", alpha=float(alpha)).wait()
        assert delta["a"].is_cuda
        c, ph = _host(c0), _host(p)
        d = alpha * (ph - c)
        _eq(_host(delta), d)
        _eq(_center(ps), c + d)
    finally:
        ps.shutdown()


def test_bf16_tree_round_trips_on_the_card(cuda):
    t = {"w": (torch.arange(333, device=cuda, dtype=torch.float32) / 7).to(
        torch.bfloat16), "v": torch.randn(5, device=cuda).half()}
    ps = tps.init(t, num_shards=2)
    try:
        got = ps.receive().wait()
        assert got["w"].dtype == torch.bfloat16 and got["w"].is_cuda
        assert torch.equal(got["w"].view(torch.int16),
                           t["w"].view(torch.int16))
        assert torch.equal(got["v"], t["v"])
    finally:
        ps.shutdown()


def test_fetch_buffers_return_to_the_pool(cuda):
    """A fetch's pinned buffer is reused once its copy to the card has
    finished: many fetches in turn allocate one buffer."""
    ps = tps.init(_tree(cuda, 7), num_shards=2)
    try:
        for _ in range(5):
            ps.receive().wait()
            torch.cuda.synchronize()
        assert len(ps.client._pool._free) == 1
    finally:
        ps.shutdown()


def test_every_rule_and_verb_on_the_card(cuda):
    """copy, add, zero, axpy and elastic on trees on the card, each against
    the server's rule in numpy float32 bitwise; sync_handle, ping, healthy
    and stats()."""
    c0 = _tree(cuda, 8)
    ps = tps.init(c0, num_shards=3)
    try:
        center = _host(c0)
        for i, (rule, alpha) in enumerate((("add", 1.0), ("axpy", -0.7),
                                           ("elastic", 0.45), ("zero", 1.0),
                                           ("copy", 1.0), ("axpy", 3.0))):
            u = _tree(cuda, 20 + i, scale=0.1 * (i + 1))
            uh, a = _host(u), np.float32(alpha)
            got = tps.sync_handle(ps.send(u, rule=rule, alpha=alpha))
            if rule == "elastic":
                d = a * (uh - center)
                _eq(_host(got), d)
                center = center + d
            else:
                assert got is None
                center = {"add": lambda: center + uh,
                          "axpy": lambda: center + a * uh,
                          "zero": lambda: np.zeros_like(center),
                          "copy": lambda: uh.copy()}[rule]()
            _eq(_center(ps), center)
        assert ps.client.ping() == [True] * 3 and ps.healthy()
        st = ps.stats()
        assert st["ops"] >= 3 * 13 and st["elastic_bytes_out"] == 4 * (
            300 * 301 + 1000 + 7)
    finally:
        ps.shutdown()
