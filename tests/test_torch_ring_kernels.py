"""The port's CUDA ring-allreduce kernels against their plain versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_ring_kernels.py -q

n ranks' buffers sit on the one card, rank-major; one launch runs the whole
ring.  The kernels add in the schedule's order, as the plain versions do, so
every comparison is bitwise, for float32, bfloat16 and int32.  The CPU
parity of the plain versions with the JAX package is tests/test_torch_ring.py.
"""

import pytest
import torch

from torchmpi_tpu_torch.ops import ring

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.bfloat16, torch.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stack(dev, n, L, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2 ** 30, 2 ** 30, (n, L), generator=g,
                             device=dev, dtype=torch.int32)
    return torch.randn(n, L, generator=g, device=dev).to(dtype)


def _plan(name, x, chunk_bytes):
    """The plan the schedule gives row ``name`` on x; ``chunk_bytes`` is
    scaled by the element size so that every dtype gets the same plan."""
    n, L = x.shape
    picked, plan = ring.schedule(
        L, n, x.dtype, chunk_bytes=chunk_bytes * x.element_size() // 4,
        bidirectional="bidir" in name)
    assert picked == name, (picked, name, L, chunk_bytes)
    return plan


# (row, L, chunk_bytes): ragged L against every padding boundary; the
# chunked rows with C from 2 to 9 subchunks; odd L splits the halves
# unevenly.
CASES = [
    ("ring_allreduce", 1, 4 << 20),
    ("ring_allreduce", 3 * 1024 + 5, 4 << 20),
    ("ring_allreduce", 1 << 20, 16 << 20),
    ("ring_allreduce_bidir", 16 * 1024 + 77, 4 << 20),
    ("ring_allreduce_bidir", 1 << 20, 16 << 20),
    ("ring_allreduce_chunked", 40_000 - 3, 4096),
    ("ring_allreduce_chunked", 1_000_001, 64 << 10),
    ("ring_allreduce_bidir_chunked", 80_000 + 1, 4096),
    ("ring_allreduce_bidir_chunked", 2_000_003, 64 << 10),
]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name,L,chunk_bytes", CASES,
                         ids=lambda v: str(v))
def test_kernel_bitwise_equals_plain(cuda, name, L, chunk_bytes, n):
    if "bidir" in name and L < 2 * n * 1024:
        pytest.skip("below the bidirectional kernels' size")
    for i, dtype in enumerate(DTYPES):
        x = _stack(cuda, n, L, dtype, seed=n * 100 + i)
        x_before = x.clone()
        plan = _plan(name, x, chunk_bytes)
        before = ring.LAUNCHES[name]
        got = ring.WRAPPERS[name](x, *plan)
        again = ring.WRAPPERS[name](x, *plan)
        want = ring.PLAINS[name](x, *plan)
        torch.cuda.synchronize()
        assert ring.LAUNCHES[name] == before + 2
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(x, x_before)  # the input is not modified
        assert torch.equal(got, want), f"{name} n={n} {dtype}"
        assert torch.equal(got, again), f"{name} n={n} {dtype}: repeat"
        if dtype == torch.int32:
            assert torch.equal(got[0], x.sum(0, dtype=torch.int32))


def test_entry_point_schedules_every_row(cuda):
    """ring_allreduce picks each row from the config and matches the plain
    entry point bitwise, for sum and mean."""
    from torchmpi_tpu_torch import runtime

    x = _stack(cuda, 4, 300_001, torch.float32, seed=1)
    configs = {
        "ring_allreduce": dict(chunk_bytes=4 << 20),
        "ring_allreduce_bidir": dict(chunk_bytes=4 << 20,
                                     pallas_bidirectional=True),
        "ring_allreduce_chunked": dict(chunk_bytes=64 << 10),
        "ring_allreduce_bidir_chunked": dict(chunk_bytes=64 << 10,
                                             pallas_bidirectional=True),
    }
    runtime.stop()
    runtime.init(device="cuda")
    try:
        for name, cfg in configs.items():
            runtime.set_config(**{"pallas_bidirectional": False, **cfg})
            for op in ("sum", "mean"):
                before = ring.LAUNCHES[name]
                got = ring.ring_allreduce(x, op=op)
                assert ring.LAUNCHES[name] == before + 1, name
                assert torch.equal(got, ring.ring_allreduce_plain(x, op=op))
    finally:
        runtime.stop()


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        ring.allreduce_resident(torch.ones(4, 100, device=cuda,
                                           dtype=torch.float16))
    with pytest.raises(ValueError):
        ring.allreduce_resident(torch.ones(1, 100, device=cuda))
    with pytest.raises(ValueError):
        ring.allreduce_resident(torch.ones(400, device=cuda))
    # More ranks than the card can keep resident together (a block each):
    # refused, never shrunk or serialized.
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 4 * sms + 1
    with pytest.raises(RuntimeError, match="launch"):
        ring.allreduce_resident(torch.ones(n, 1, device=cuda))
