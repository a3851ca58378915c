"""The port's prefetching input pipeline
(torchmpi_tpu_torch/utils/input_pipeline.py ``prefetch_to_device``), held to
the cases of the JAX package's tests/test_input_pipeline.py that apply to a
process with one device: order, per-leaf structure, error propagation,
depth validation, and the producer's release on early close and when the
iterator is dropped before its first ``next``.  The side-stream copy to the
card is ``gpu``-marked and skips without one."""

import gc
import threading
import time

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.utils.input_pipeline import prefetch_to_device

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def no_runtime():
    """No runtime: the device is always given (or the default tested)."""
    tmpi.stop()
    yield
    tmpi.stop()


def _batches(n, size=64):
    for i in range(n):
        yield (np.full((size, 4), float(i), np.float32),
               np.full((size,), i, np.int32))


def _wait_for_threads(before):
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    return threading.active_count() <= before


def test_prefetch_orders_and_places():
    out = list(prefetch_to_device(_batches(5), depth=2, device="cpu"))
    assert len(out) == 5
    for i, (xb, yb) in enumerate(out):
        assert isinstance(xb, torch.Tensor) and xb.device.type == "cpu"
        assert xb.dtype == torch.float32 and yb.dtype == torch.int32
        assert torch.equal(yb, torch.full((64,), i, dtype=torch.int32))
        assert float(xb[0, 0]) == float(i)


def test_prefetch_keeps_per_leaf_structure():
    src = [{"x": np.ones((2, 3), np.float32),
            "meta": (np.arange(2), [np.zeros(1, np.int32)])}]
    out = next(iter(prefetch_to_device(iter(src), depth=1, device="cpu")))
    assert set(out) == {"x", "meta"} and isinstance(out["meta"], tuple)
    assert isinstance(out["meta"][1], list)
    assert torch.equal(out["meta"][0], torch.arange(2))
    assert out["x"].shape == (2, 3)


def test_prefetch_error_propagates():
    def bad():
        yield (np.zeros((8, 4), np.float32), np.zeros((8,), np.int32))
        raise ValueError("source broke")

    it = prefetch_to_device(bad(), depth=1, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="source broke"):
        next(it)


def test_prefetch_depth_validation():
    # Raises at the call site (a plain function), not at the first next().
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_device(_batches(1), depth=0, device="cpu")


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(_batches(1))


def test_prefetch_early_close_releases_producer():
    before = threading.active_count()
    it = prefetch_to_device(_batches(100), depth=1, device="cpu")
    next(it)
    it.close()  # abandon mid-stream
    assert _wait_for_threads(before), "producer thread leaked"


def test_prefetch_dropped_before_first_next_releases_producer():
    """A never-started generator skips its finally on GC; the attached
    finalizer must still stop the producer and drop staged batches."""
    before = threading.active_count()
    it = prefetch_to_device(_batches(100), depth=1, device="cpu")
    del it  # dropped without ever calling next()
    gc.collect()
    assert _wait_for_threads(before), "producer thread leaked"


@pytest.mark.gpu
def test_prefetch_to_the_card_on_a_side_stream():
    """On the card: batches arrive in order, pinned-copied on the side
    stream, ready on the consumer's stream with no host wait."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for xb, yb in prefetch_to_device(_batches(4, size=1 << 16), depth=2,
                                     device=dev):
        assert xb.device == dev and yb.device == dev
        out.append((float(xb.sum()), int(yb[0])))
    assert out == [(4.0 * (1 << 16) * i, i) for i in range(4)]
