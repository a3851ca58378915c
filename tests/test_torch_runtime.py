"""The port's config, runtime, selector and eager collectives on the CPU
(gloo, a world of one process), held against the JAX package's Config."""

import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import runtime, selector

torch.set_num_threads(2)

SHARED = ("backend", "flash_prescale", "fuse_max_bytes",
          "gradsync_average", "chunk_bytes", "custom_min_bytes",
          "pallas_bidirectional")


@pytest.fixture
def cpu_runtime():
    tmpi.stop()
    tmpi.init(device="cpu")
    yield
    tmpi.stop()


def test_config_defaults_and_env_match_jax(monkeypatch):
    for f in SHARED:
        assert getattr(tmpi.Config(), f) == getattr(jmpi.Config(), f), f
    monkeypatch.setenv("TORCHMPI_TPU_BACKEND", "pallas")
    monkeypatch.setenv("TORCHMPI_TPU_FLASH_PRESCALE", "1")
    monkeypatch.setenv("TORCHMPI_TPU_FUSE_MAX_BYTES", "4096")
    monkeypatch.setenv("TORCHMPI_TPU_GRADSYNC_AVERAGE", "0")
    monkeypatch.setenv("TORCHMPI_TPU_CHUNK_BYTES", "65536")
    monkeypatch.setenv("TORCHMPI_TPU_CUSTOM_MIN_BYTES", "0")
    got, want = tmpi.Config.from_env(), jmpi.Config.from_env()
    for f in SHARED:
        assert getattr(got, f) == getattr(want, f), f
    assert got.fuse_max_bytes == 4096 and got.backend == "pallas"
    assert (got.chunk_bytes, got.custom_min_bytes) == (65536, 0)
    with pytest.raises(ValueError):
        tmpi.Config.from_env(no_such_field=1)


def test_init_stop_rank_size_epoch():
    tmpi.stop()
    with pytest.raises(RuntimeError):
        tmpi.rank()
    assert tmpi.effective_config() == tmpi.Config()
    e0 = tmpi.config_epoch()
    dev = tmpi.init(device="cpu", fuse_max_bytes=1024)
    try:
        assert dev == torch.device("cpu")
        assert tmpi.init(device="cpu") == dev  # idempotent
        assert (tmpi.rank(), tmpi.size(), tmpi.local_rank()) == (0, 1, 0)
        assert runtime.backend_name() == "gloo"
        assert tmpi.effective_config().fuse_max_bytes == 1024
        tmpi.barrier()
        assert tmpi.config_epoch() == e0 + 1
    finally:
        tmpi.stop()
    assert tmpi.config_epoch() == e0 + 2
    with pytest.raises(ValueError):
        tmpi.init(device="cpu", no_such_field=1)


def test_cuda_init_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: init(device='cuda') would succeed")
    tmpi.stop()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpi.init()
    assert not tmpi.is_initialized()


def test_selector_routes_and_refuses(cpu_runtime):
    """"pallas" routes to the ring (a world of one process returns a copy,
    the ring of one member); an op without a ring falls back to "xla";
    unknown backends and ops raise."""
    impls = selector.available("allreduce")
    assert sorted(impls) == ["pallas", "xla"]
    assert selector.select("allreduce", "pallas") is impls["pallas"]
    assert selector.select("broadcast", "pallas") is \
        selector.available("broadcast")["xla"]
    with pytest.raises(ValueError):
        selector.select("allreduce", "hierarchical")
    with pytest.raises(ValueError):
        selector.select("fused_reduce_scatter", "xla")
    assert selector.select("alltoall", "pallas") is \
        selector.available("alltoall")["xla"]
    x = torch.arange(3.0)
    for op in ("sum", "mean"):
        y = tmpi.allreduce(x, op=op, backend="pallas")
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    tmpi.set_config(backend="pallas", custom_min_bytes=0)
    assert selector.select("allreduce", nbytes=4) is impls["pallas"]
    tmpi.set_config(custom_min_bytes=64 * 1024)
    assert selector.select("allreduce", nbytes=4) is impls["xla"]


def test_collectives_on_one_rank(cpu_runtime):
    x = torch.arange(6.0).reshape(2, 3)
    for op in ("sum", "mean"):
        y = tmpi.allreduce(x, op=op)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(tmpi.broadcast(x), x)
    assert torch.equal(tmpi.allreduce_in_axis(x, ("dcn", "ici"), op="mean"),
                       x)
    assert torch.equal(tmpi.allreduce_in_axis(x, None), x)
    with pytest.raises(NotImplementedError):
        tmpi.allreduce_in_axis(x, "ici")
    with pytest.raises(ValueError):
        tmpi.allreduce(x, op="max")
    with pytest.raises(TypeError):
        tmpi.allreduce(x.numpy())
