"""The port's examples (torchmpi_tpu_torch/examples/) on the CPU: each
``main`` runs a few steps as a world of one (gloo), or rank-major with
``--devices 2`` (``mnist_fsdp`` with 4), and its loss falls; ``mnist_async_allreduce``'s
overlapped run equals its bucketed one, and ``--eager-loss`` reduces the
loss through the staged path; the flags whose machinery is not ported
raise naming their ROADMAP item.  The full-length runs to the JAX
examples' accuracy bars (MNIST > 0.9, CIFAR > 0.85) are ``slow`` here, as
JAX's ``test_resnet20_dp_convergence`` is, and run on the card in
chip_smoke.py's ``cnn_examples`` phase."""

import importlib

import pytest
import torch

import torchmpi_tpu_torch as tmpi

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def no_runtime():
    """Each example starts and stops its own runtime."""
    tmpi.stop()
    yield
    tmpi.stop()


def _main(name, argv):
    mod = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
    return mod.main(CPU + argv)


@pytest.mark.parametrize("name,argv", [
    ("mnist_sequential", ["--steps", "21", "--batch-size", "64"]),
    ("mnist_allreduce", ["--steps", "21", "--batch-size", "64"]),
    ("mnist_allreduce", ["--steps", "21", "--batch-size", "64",
                         "--devices", "2", "--backend", "pallas"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32", "--zero",
                        "3"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32", "--zero",
                        "1", "--devices", "2", "--backend", "pallas"]),
    ("imagenet_resnet50", ["--steps", "3", "--warmup", "0", "--batch-size",
                           "4", "--image-size", "32", "--num-classes", "10"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32", "--buckets",
                        "4", "--devices", "2"]),
    ("mnist_async_allreduce", ["--steps", "21", "--batch-size", "64"]),
    ("mnist_async_allreduce", ["--steps", "21", "--batch-size", "64",
                               "--devices", "2", "--backend", "pallas"]),
    ("mnist_fsdp", ["--steps", "10", "--devices", "4"]),
], ids=["sequential", "allreduce", "allreduce-rank-major", "cifar",
        "cifar-zero3", "cifar-zero1-rank-major", "resnet50",
        "cifar-buckets-rank-major", "async-buckets",
        "async-buckets-rank-major", "fsdp-rank-major"])
def test_example_runs_and_loss_falls(name, argv):
    out = _main(name, argv)
    losses = out["losses"]
    assert len(losses) >= 2 and all(map(lambda v: v == v, losses))
    assert losses[-1] < losses[0], losses
    assert not tmpi.is_initialized()


@pytest.mark.parametrize("devices", [[], ["--devices", "2"]])
def test_async_example_overlap_matches_buckets(monkeypatch, devices):
    """``mnist_async_allreduce`` under ``TORCHMPI_TPU_GRADSYNC_OVERLAP=auto``
    (the overlapped sync) gives the bucketed run's losses bitwise (the
    stock route's sum over ranks does not depend on the buckets)."""
    argv = ["--steps", "21", "--batch-size", "64"] + devices
    plain = _main("mnist_async_allreduce", argv)
    monkeypatch.setenv("TORCHMPI_TPU_GRADSYNC_OVERLAP", "auto")
    over = _main("mnist_async_allreduce", argv)
    assert over["overlap"] and not plain["overlap"]
    assert over["losses"] == plain["losses"]
    assert over["accuracy"] == plain["accuracy"]


def test_eager_loss_reduces_through_the_staged_path():
    """``mnist_allreduce --eager-loss``: the logging loss through the
    host-staged rank-major allreduce, the same losses as without it (the
    mean of n equal values) and a LOSS-DIGEST of them."""
    argv = ["--steps", "3", "--batch-size", "64", "--devices", "2"]
    plain = _main("mnist_allreduce", argv)
    eager = _main("mnist_allreduce", argv + ["--eager-loss"])
    assert len(eager["loss_digest"]) == 32
    assert eager["losses"] == pytest.approx(plain["losses"], rel=1e-6)


@pytest.mark.parametrize("name,argv,item", [
    ("mnist_allreduce", ["--dcn", "2"], "item 4"),
    ("mnist_allreduce", ["--backend", "hierarchical"], "item 4"),
    ("mnist_allreduce", ["--restart-loop"], "item 10"),
])
def test_unported_flags_raise_by_name(name, argv, item):
    with pytest.raises(NotImplementedError, match=f"queue A, {item}"):
        _main(name, argv)


@pytest.mark.slow
@pytest.mark.parametrize("name,argv", [
    ("mnist_sequential", []), ("mnist_allreduce", []),
    ("mnist_async_allreduce", []), ("mnist_fsdp", ["--devices", "4"]),
    ("cifar_resnet20", []), ("cifar_resnet20", ["--zero", "3"])])
def test_example_converges(name, argv):
    """The full-length default runs to their accuracy bars (each raises
    AssertionError below it)."""
    out = _main(name, argv)
    assert out["accuracy"] > (0.85 if name.startswith("cifar") else 0.9)
