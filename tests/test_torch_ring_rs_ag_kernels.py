"""The port's CUDA ring reduce-scatter and all-gather kernels (rows 9, 10, 13
and 14 of the kernel table) against their plain versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_ring_rs_ag_kernels.py -q

n ranks' buffers sit on the one card, rank-major; one launch runs the whole
ring.  The reduce-scatter adds in the schedule's order, as the plain
version does, and the all-gather only copies, so every comparison is
bitwise, for float32, bfloat16 and int32.  The CPU parity of the plain
versions with the JAX package is tests/test_torch_ring_rs_ag.py.
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


def _stack(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2 ** 30, 2 ** 30, shape, generator=g,
                             device=dev, dtype=torch.int32)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _plan(name, n, per, dtype, chunk_bytes):
    """The plan the schedule gives row ``name`` for ring chunks of ``per``
    elements; ``chunk_bytes`` is scaled by the element size so that every
    dtype gets the same plan."""
    cb = chunk_bytes * dtype.itemsize // 4
    if name.startswith("ring_reduce_scatter"):
        picked, plan = ring.schedule_reduce_scatter(n * per, n, dtype,
                                                    chunk_bytes=cb)
    else:
        picked, plan = ring.schedule_all_gather(per, n, dtype,
                                                chunk_bytes=cb)
    assert picked == name, (picked, name, per, chunk_bytes)
    return plan


# (row, elements of one ring chunk, chunk_bytes): ragged chunks against
# every padding boundary (odd, so the chunks start unaligned), and chunked
# plans of C 3, 8 and 11.
CASES = [
    ("ring_reduce_scatter", 1, 4 << 20),
    ("ring_reduce_scatter", 3 * 1024 + 5, 4 << 20),
    ("ring_reduce_scatter", 1 << 18, 16 << 20),
    ("ring_reduce_scatter_chunked", 2 * 1024 + 1, 4096),
    ("ring_reduce_scatter_chunked", 250_001, 100_000),
    ("ring_reduce_scatter_chunked", 1 << 20, 512 << 10),
    ("ring_all_gather", 1, 4 << 20),
    ("ring_all_gather", 3 * 1024 + 5, 4 << 20),
    ("ring_all_gather", 1 << 18, 16 << 20),
    ("ring_all_gather_chunked", 2 * 1024 + 1, 4096),
    ("ring_all_gather_chunked", 250_001, 100_000),
    ("ring_all_gather_chunked", 1 << 20, 512 << 10),
]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name,per,chunk_bytes", CASES, ids=lambda v: str(v))
def test_kernel_bitwise_equals_plain(cuda, name, per, chunk_bytes, n):
    rs = name.startswith("ring_reduce_scatter")
    for i, dtype in enumerate(DTYPES):
        x = _stack(cuda, (n, n * per if rs else per), dtype,
                   seed=n * 100 + i)
        x_before = x.clone()
        plan = _plan(name, n, per, dtype, chunk_bytes)
        before = ring.LAUNCHES[name]
        got = ring.WRAPPERS[name](x, *plan)
        again = ring.WRAPPERS[name](x, *plan)
        want = ring.PLAINS[name](x, *plan)
        torch.cuda.synchronize()
        assert ring.LAUNCHES[name] == before + 2
        assert got.dtype == dtype
        assert got.shape == ((n, per) if rs else (n, n, per))
        assert torch.equal(x, x_before)  # the input is not modified
        assert torch.equal(got, want), f"{name} n={n} {dtype}"
        assert torch.equal(got, again), f"{name} n={n} {dtype}: repeat"
        if rs and dtype == torch.int32:
            assert torch.equal(got, x.view(n, n, per).sum(
                0, dtype=torch.int32))
        if not rs:
            assert torch.equal(got, x.expand(n, n, per))


def test_entry_points_schedule_every_row(cuda):
    """ring_reduce_scatter and ring_all_gather pick each row from the
    config, match the plain entry points bitwise, and compose to the ring
    allreduce's function."""
    from torchmpi_tpu_torch import runtime

    n = 4
    xs = _stack(cuda, (n, n * 75_001, 3), torch.float32, seed=1)
    configs = {"chunked": 64 << 10, "resident": 16 << 20}
    runtime.stop()
    runtime.init(device="cuda")
    try:
        for mode, cb in configs.items():
            runtime.set_config(chunk_bytes=cb)
            suffix = "_chunked" if mode == "chunked" else ""
            rs, ag = "ring_reduce_scatter" + suffix, "ring_all_gather" + suffix
            before = dict(ring.LAUNCHES)
            shard = ring.ring_reduce_scatter(xs)
            gathered = ring.ring_all_gather(shard)
            assert ring.LAUNCHES[rs] == before[rs] + 1, mode
            assert ring.LAUNCHES[ag] == before[ag] + 1, mode
            assert shard.shape == (n, 75_001, 3)
            assert gathered.shape == (n, n, 75_001, 3)
            assert torch.equal(shard, ring.ring_reduce_scatter_plain(xs))
            assert torch.equal(gathered, ring.ring_all_gather_plain(shard))
            for r in range(n):
                assert torch.equal(gathered[r].reshape(n * 75_001, 3),
                                   gathered[0].reshape(n * 75_001, 3))
            summed = xs.sum(0)
            torch.testing.assert_close(gathered[0].reshape(summed.shape),
                                       summed, rtol=1e-5, atol=1e-5)
    finally:
        runtime.stop()


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        ring.reduce_scatter_resident(torch.ones(4, 400, device=cuda,
                                                dtype=torch.float16))
    with pytest.raises(ValueError):
        ring.reduce_scatter_resident(torch.ones(1, 100, device=cuda))
    with pytest.raises(ValueError, match="divisible"):
        ring.reduce_scatter_resident(torch.ones(4, 402, device=cuda))
    with pytest.raises(ValueError):
        ring.all_gather_resident(torch.ones(400, device=cuda))
    # A plan that does not fit the chunk: refused before any launch.
    with pytest.raises(ValueError, match="does not fit"):
        ring.all_gather_chunked(torch.ones(4, 5000, device=cuda), 1024, 2)
    with pytest.raises(ValueError, match="does not fit"):
        ring.reduce_scatter_chunked(torch.ones(4, 4000, device=cuda), 1024, 1)
    # More ranks than the card can keep resident together (a block each):
    # refused, never shrunk or serialized.
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 4 * sms + 1
    with pytest.raises(RuntimeError, match="launch"):
        ring.all_gather_resident(torch.ones(n, 1, device=cuda))
