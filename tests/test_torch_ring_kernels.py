"""The port's CUDA ring-allreduce kernels against their plain versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_ring_kernels.py -q

n ranks' buffers sit on the one card, rank-major; one launch runs the whole
ring.  The kernels add in the schedule's order, as the plain versions do, so
every comparison is bitwise, for float32, bfloat16 and int32.  No row
walks the ring: one kernel (ring_direct.cu) folds every rank's value of an
element in the ring's order, rows 8 (``ring_allreduce_chunked``) and 11
(``ring_allreduce``) in one rotation, rows 7
(``ring_allreduce_bidir_chunked``) and 12 (``ring_allreduce_bidir``) with
their second half in the other rotation's, on a 16-byte path where the
rows are aligned and element by element otherwise.  The CPU parity of the
plain versions with the JAX package is tests/test_torch_ring.py.
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
# unevenly, and at 16,385 row 12's halves pad to different ring chunks
# for 4 and 8 ranks.
CASES = [
    ("ring_allreduce", 1, 4 << 20),
    ("ring_allreduce", 3 * 1024 + 5, 4 << 20),
    ("ring_allreduce", 1 << 20, 16 << 20),
    ("ring_allreduce_bidir", 16 * 1024 + 77, 4 << 20),
    ("ring_allreduce_bidir", 16_385, 4 << 20),
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
        assert torch.equal(got, ring.FOLDS[name](x, *plan))
        if dtype == torch.int32:
            assert torch.equal(got[0], x.sum(0, dtype=torch.int32))


# Row 8 is a direct reduction (ring_direct.cu): (L, row padding in
# elements or "align" for 16 bytes).  Odd contiguous rows take the element
# path; rows padded to 16 bytes take the 16-byte path, L odd with an
# element tail.  11 ranks take two rounds of loads in flight (8, then 3).
DIRECT_CASES = [(1, 0), (40_001, 0), (40_001, "align"), (65_536, 0)]


@pytest.mark.parametrize("n", [2, 3, 4, 8, 11])
@pytest.mark.parametrize("L,pad", DIRECT_CASES, ids=lambda v: str(v))
def test_direct_allreduce_paths(cuda, n, L, pad):
    name = "ring_allreduce_chunked"
    for i, dtype in enumerate(DTYPES):
        v = 16 // dtype.itemsize
        width = -(-L // v) * v if pad == "align" else L + pad
        x = _stack(cuda, n, width, dtype, seed=n * 10 + i)[:, :L]
        plan = ring._chunk_plan(max(L, 2 * n * 1024), n, dtype,
                                4096 * dtype.itemsize // 4)
        vector = (x.stride(0) * dtype.itemsize) % 16 == 0
        before = dict(ring.LAUNCHES), dict(ring.VECTOR_LAUNCHES)
        got = ring.allreduce_chunked(x, *plan)
        again = ring.allreduce_chunked(x, *plan)
        want = ring.allreduce_chunked_plain(x, *plan)
        torch.cuda.synchronize()
        assert ring.LAUNCHES[name] == before[0][name] + 2
        assert ring.VECTOR_LAUNCHES[name] == before[1][name] + 2 * vector
        assert got.shape == x.shape and got.dtype == dtype
        assert torch.equal(got, want), f"n={n} L={L} {dtype}"
        assert torch.equal(got, again), f"n={n} L={L} {dtype}: repeat"
        assert torch.equal(got, ring.allreduce_direct_plain(x, *plan))
    # An empty rank launches nothing.
    before = ring.LAUNCHES[name]
    got = ring.allreduce_chunked(torch.ones(n, 0, device=cuda), 1024, 2)
    assert got.shape == (n, 0) and ring.LAUNCHES[name] == before


# Row 7 on the same kernel: (L, row padding).  On 16-byte rows, L 40,003
# puts the second half's first element (20,001) off the boundary for every
# dtype, so its chunks peel their first elements; L 40,001 splits at
# 20,000, on it.  11 ranks take two rounds of loads in flight; L 1 leaves
# the first half empty.
BIDIR_DIRECT_CASES = [(1, 0), (40_001, 0), (40_003, "align"),
                      (40_001, "align"), (65_536, 0)]


@pytest.mark.parametrize("n", [2, 3, 4, 8, 11])
@pytest.mark.parametrize("L,pad", BIDIR_DIRECT_CASES, ids=lambda v: str(v))
def test_direct_bidir_allreduce_paths(cuda, n, L, pad):
    name = "ring_allreduce_bidir_chunked"
    for i, dtype in enumerate(DTYPES):
        v = 16 // dtype.itemsize
        width = -(-L // v) * v if pad == "align" else L + pad
        x = _stack(cuda, n, width, dtype, seed=n * 10 + i + 5)[:, :L]
        plan = ring._chunk_plan(max(-(-L // 2), 2 * n * 1024), n, dtype,
                                4096 * dtype.itemsize // 4)
        assert plan[1] > 1
        vector = (x.stride(0) * dtype.itemsize) % 16 == 0
        before = dict(ring.LAUNCHES), dict(ring.VECTOR_LAUNCHES)
        got = ring.allreduce_bidir_chunked(x, *plan)
        again = ring.allreduce_bidir_chunked(x, *plan)
        want = ring.allreduce_bidir_chunked_plain(x, *plan)
        torch.cuda.synchronize()
        assert ring.LAUNCHES[name] == before[0][name] + 2
        assert ring.VECTOR_LAUNCHES[name] == before[1][name] + 2 * vector
        assert got.shape == x.shape and got.dtype == dtype
        assert torch.equal(got, want), f"n={n} L={L} {dtype}"
        assert torch.equal(got, again), f"n={n} L={L} {dtype}: repeat"
        assert torch.equal(got, ring.allreduce_bidir_direct_plain(x, *plan))
        if dtype == torch.int32:
            assert torch.equal(got[0], x.sum(0, dtype=torch.int32))
    before = ring.LAUNCHES[name]
    got = ring.allreduce_bidir_chunked(torch.ones(n, 0, device=cuda), 1024,
                                       2)
    assert got.shape == (n, 0) and ring.LAUNCHES[name] == before


# Rows 11 and 12 on the same kernel, one ring chunk of the padded P / n
# (row 12: of each half's own): (L, row padding) as for rows 8 and 7; L
# 16,385 on 16-byte rows gives row 12's halves different ring chunks for 4
# and 8 ranks and starts half 2 off the boundary.  Row 12's plain version
# takes L >= 2 (a half of one element).
RESIDENT_CASES = [(1, 0), (40_001, 0), (40_001, "align"), (16_385, "align"),
                  (65_536, 0)]
RESIDENT_BIDIR_CASES = [(2, 0), (40_001, 0), (40_003, "align"),
                        (16_385, "align"), (65_536, 0)]


@pytest.mark.parametrize("n", [2, 3, 4, 8, 11])
@pytest.mark.parametrize("name,L,pad", [
    ("ring_allreduce", L, pad) for L, pad in RESIDENT_CASES] + [
    ("ring_allreduce_bidir", L, pad) for L, pad in RESIDENT_BIDIR_CASES],
    ids=lambda v: str(v))
def test_direct_resident_allreduce_paths(cuda, name, n, L, pad):
    wrapper, plain = ring.WRAPPERS[name], ring.PLAINS[name]
    for i, dtype in enumerate(DTYPES):
        v = 16 // dtype.itemsize
        width = -(-L // v) * v if pad == "align" else L + pad
        x = _stack(cuda, n, width, dtype, seed=n * 10 + i + 9)[:, :L]
        vector = (x.stride(0) * dtype.itemsize) % 16 == 0
        before = dict(ring.LAUNCHES), dict(ring.VECTOR_LAUNCHES)
        got, again, want = wrapper(x), wrapper(x), plain(x)
        torch.cuda.synchronize()
        assert ring.LAUNCHES[name] == before[0][name] + 2
        assert ring.VECTOR_LAUNCHES[name] == before[1][name] + 2 * vector
        assert got.shape == x.shape and got.dtype == dtype
        assert torch.equal(got, want), f"{name} n={n} L={L} {dtype}"
        assert torch.equal(got, again), f"{name} n={n} L={L} {dtype}: repeat"
        assert torch.equal(got, ring.FOLDS[name](x))
        if dtype == torch.int32:
            assert torch.equal(got[0], x.sum(0, dtype=torch.int32))
    before = ring.LAUNCHES[name]
    got = wrapper(torch.ones(n, 0, device=cuda))
    assert got.shape == (n, 0) and ring.LAUNCHES[name] == before


def test_entry_point_schedules_every_row(cuda):
    """ring_allreduce picks each row from the config and matches the plain
    entry point bitwise, for sum and mean; every row is a direct launch,
    on its 16-byte path where the rows are 16 bytes apart."""
    from torchmpi_tpu_torch import runtime

    x = _stack(cuda, 4, 300_001, torch.float32, seed=1)
    x16 = torch.empty(4, 300_004, device=cuda)[:, :300_001].copy_(x)
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
            assert name in ring.KERNELS
            for op in ("sum", "mean"):
                for xs, vector in ((x, 0), (x16, 1)):
                    before = ring.LAUNCHES[name], ring.VECTOR_LAUNCHES[name]
                    got = ring.ring_allreduce(xs, op=op)
                    assert ring.LAUNCHES[name] == before[0] + 1, name
                    assert ring.VECTOR_LAUNCHES[name] == before[1] + vector
                    assert torch.equal(got,
                                       ring.ring_allreduce_plain(x, op=op))
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
    # More ranks than the card keeps blocks resident (the ring-walking
    # kernel refused this): the direct kernel needs no co-residency, so it
    # computes.  The step-by-step plain ring is too slow at this many ranks;
    # the fold and the sum stand in for it.
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 4 * sms + 1
    x = _stack(cuda, n, 1, torch.int32, seed=3)
    got = ring.allreduce_resident(x)
    assert torch.equal(got, ring.allreduce_resident_direct_plain(x))
    assert torch.equal(got[0], x.sum(0, dtype=torch.int32))
