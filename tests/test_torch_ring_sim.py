"""The port's copy of the ring schedule simulator
(torchmpi_tpu_torch/ops/ring_sim.py) against the JAX package's
(torchmpi_tpu/ops/ring_sim.py), and the allreduce cases of
tests/test_ring_sim.py run on the copy.

Both simulators get the same numpy inputs, schedulers and seeds and must
return the same buffers bitwise, and raise the same HazardError /
DeadlockError on the same mutated programs.  The plans come from the port's
own ``_chunk_plan`` (held against the JAX one in tests/test_torch_ring.py).
"""

import numpy as np
import pytest
import torch

from torchmpi_tpu.ops import ring_sim as jsim
from torchmpi_tpu_torch.ops import ring as tring
from torchmpi_tpu_torch.ops import ring_sim as tsim

RESNET50_PARAMS = 25_557_032  # f32 gradient elements
FLAGSHIP_PARAMS = 486_731_776


def _x(n, C, sub, seed=0, dtype=np.int64):
    # Integer payloads make ring-order and numpy-order sums exactly equal.
    return np.random.RandomState(seed).randint(
        -1000, 1000, size=(n, n, C, sub)).astype(dtype)


def _both_allreduce(x, C, **kw):
    """The port's simulate_allreduce, checked bitwise against the JAX
    package's on the same inputs and scheduler seed."""
    seed = kw.pop("seed", None)
    rng = (lambda: np.random.RandomState(seed)) if seed is not None else (
        lambda: None)
    got = tsim.simulate_allreduce(x, C, rng=rng(), **kw)
    want = jsim.simulate_allreduce(x, C, rng=rng(), **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    return got


def test_step_indices_match_jax():
    for n in (2, 3, 4, 8):
        for s in range(2 * (n - 1)):
            for my in range(n):
                for sign in (1, -1):
                    assert tsim.step_indices_allreduce(my, n, s, sign) == \
                        jsim.step_indices_allreduce(my, n, s, sign)
                    assert tring._step_indices(my, n, s, sign) == \
                        jsim.step_indices_allreduce(my, n, s, sign)
            if s < n - 1:
                for my in range(n):
                    assert tsim.step_indices_rs(my, n, s) == \
                        jsim.step_indices_rs(my, n, s)


@pytest.mark.parametrize("params,n,chunk_bytes,sub", [
    (RESNET50_PARAMS, 8, 4 * 1024 * 1024, 16),   # the default plan
    (RESNET50_PARAMS, 8, 128 * 1024, 8),         # depth >= 50
    (RESNET50_PARAMS, 32, 256 * 1024, 4),
    (FLAGSHIP_PARAMS // 59, 4, 4 * 1024 * 1024, 8),  # one flagship bucket
], ids=["resnet50-default", "resnet50-depth50", "resnet50-32ranks",
        "flagship-bucket-4ranks"])
def test_allreduce_at_production_plans(params, n, chunk_bytes, sub):
    _, C = tring._chunk_plan(params, n, torch.float32, chunk_bytes)
    assert C > 1
    x = _x(n, C, sub, seed=C)
    out = _both_allreduce(x, C, seed=1)
    for w in out:
        np.testing.assert_array_equal(w, x.sum(axis=0))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("C", [2, 3, 7])
def test_allreduce_property_grid(n, C):
    for seed in range(3):
        x = _x(n, C, 4, seed=seed)
        for w in _both_allreduce(x, C, seed=100 + seed):
            np.testing.assert_array_equal(w, x.sum(axis=0))


def test_allreduce_ccw_direction():
    # The second half of the bidirectional kernels: sign -1.
    x = _x(8, 5, 4, seed=6)
    for w in _both_allreduce(x, 5, sign=-1, seed=7):
        np.testing.assert_array_equal(w, x.sum(axis=0))


def test_allreduce_float32_values():
    x = np.random.RandomState(8).randn(8, 8, 9, 4).astype(np.float32)
    out = _both_allreduce(x, 9, seed=9)
    for w in out:
        np.testing.assert_allclose(w, x.sum(axis=0), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n,C", [(4, 3), (8, 13)])
def test_reduce_scatter_and_all_gather_match_jax(n, C):
    x = _x(n, C, 4, seed=10 + n + C)
    got = tsim.simulate_reduce_scatter(x, C, rng=np.random.RandomState(11))
    want = jsim.simulate_reduce_scatter(x, C, rng=np.random.RandomState(11))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.sum(axis=0))
    chunks = x[0]
    for g, w in zip(tsim.simulate_all_gather(chunks, C,
                                             rng=np.random.RandomState(21)),
                    jsim.simulate_all_gather(chunks, C,
                                             rng=np.random.RandomState(21))):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, chunks)


def test_protocol_survives_adversarial_starvation():
    x = _x(8, 10, 4, seed=30)
    for w in _both_allreduce(x, 10, scheduler="greedy", starve=1):
        np.testing.assert_array_equal(w, x.sum(axis=0))


def test_missing_acks_trip_the_same_hazard():
    # The mutated protocol (no ack waits) under the same adversary: both
    # simulators raise the same slot-overwrite hazard.
    x = _x(8, 10, 4, seed=31)
    msgs = []
    for sim in (tsim, jsim):
        with pytest.raises(sim.HazardError, match="slot overwrite") as e:
            sim.simulate_allreduce(x, 10, scheduler="greedy", starve=1,
                                   use_acks=False)
        msgs.append(str(e.value).replace("device", "rank"))
    assert msgs[0] == msgs[1]


def test_missing_acks_random_schedules_trip_alike():
    x = _x(8, 20, 2, seed=32)
    outcomes = []
    for sim in (tsim, jsim):
        tripped = []
        for seed in range(5):
            try:
                sim.simulate_allreduce(x, 20,
                                       rng=np.random.RandomState(seed),
                                       use_acks=False)
                tripped.append(False)
            except sim.HazardError:
                tripped.append(True)
        outcomes.append(tripped)
    assert outcomes[0] == outcomes[1] and any(outcomes[0])


@pytest.mark.parametrize("sim", [tsim, jsim], ids=["port", "jax"])
def test_deadlock_detector_reports_state(sim, monkeypatch):
    # One rank emits its first event and falls silent: both simulators
    # raise DeadlockError instead of hanging.
    x = _x(4, 3, 2, seed=33)
    orig = sim._device_program
    made = []

    def broken(K, use_acks):
        gen = orig(K, use_acks)
        if made:
            return gen
        made.append(1)

        def one_event():
            yield next(gen)

        return one_event()

    monkeypatch.setattr(sim, "_device_program", broken)
    with pytest.raises(sim.DeadlockError, match="no runnable"):
        sim.simulate_allreduce(x, 3, scheduler="greedy")
