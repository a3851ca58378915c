"""The add order of the direct ring rows (rows 7-14 of the kernel table,
``ops/csrc/ring_direct.cu``) on the CPU.

The CUDA kernels do not walk the ring: they load every rank's value of an
element and add the values in the order the ring would have.  Their plain
versions, ``ring.allreduce_direct_plain``,
``ring.allreduce_bidir_direct_plain`` and
``ring.reduce_scatter_direct_plain``, are torch folds in that order; here
they are held bitwise to the ring's own plain versions (the step-by-step
schedules), chunked and resident, over ring sizes, dtypes, ragged and
aligned lengths, plans and a row-padded (strided) input.  The second half
of rows 7 and 12 runs the schedule in the other rotation, so its chunks
fold ranks c, c - 1, ..., c - n + 1; row 12's halves pad apart, so each
folds in ring chunks of its own length.  The wrappers' launch arguments
(the chunk lengths of rows 7, 8, 11 and 12; rows 13 and 14 the same
launcher and arguments as rows 9 and 10) are checked through a stand-in
for the launch that folds or copies as the kernel does.  Row 10, the
all-gather, adds nothing: its kernel stores each shard to every rank, and
its torch form ``ring.all_gather_direct_plain`` (the shards expanded to
[n, n, per]) is held bitwise to the ring's step-by-step all-gather on
padded and unpadded plans.  The ring's plain
versions are held bitwise to the JAX kernels by tests/test_torch_ring*.py,
and the kernels to the plain versions on the card by the ``gpu``-marked
tests/test_torch_ring_kernels.py and tests/test_torch_ring_rs_ag_kernels.py.
"""

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.ops import ring

torch.set_num_threads(2)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
# Elements a rank: ragged (against every plan's padding) and aligned.
LENGTHS = (20_000, 77_777, 65_536)
# chunk_bytes of f32 (scaled by the element size, so that every dtype gets
# the same plans): chunked plans of C 2 to 38 at these lengths.
CHUNK_BYTES = (4096, 8192)


def _stack(n, L, dtype, seed, pad=0):
    """[n, L] rank-major, numpy-seeded; with ``pad`` the rows sit ``L +
    pad`` elements apart (a view of a wider buffer)."""
    rng = np.random.RandomState(seed)
    if dtype == torch.int32:
        a = rng.randint(-2 ** 30, 2 ** 30, (n, L + pad)).astype(np.int32)
        x = torch.from_numpy(a)
    else:
        x = torch.from_numpy(rng.randn(n, L + pad).astype(np.float32))
        x = x.to(dtype)
    return x[:, :L]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("row", ["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_direct_order_equals_the_ring(n, dtype, row, L):
    dt = DTYPES[dtype]
    if row == "reduce_scatter":
        L -= L % n
    for pad in (0, 3):
        x = _stack(n, L, dt, seed=n * 1000 + L + pad, pad=pad)
        xc = x.contiguous()
        if row == "allreduce":
            got_all = []
            for cb in CHUNK_BYTES:
                cb = cb * dt.itemsize // 4
                name, plan = ring.schedule(L, n, dt, chunk_bytes=cb,
                                           bidirectional=False)
                assert name == "ring_allreduce_chunked", (n, L, cb)
                got = ring.allreduce_direct_plain(x, *plan)
                assert torch.equal(got, ring.allreduce_chunked_plain(xc,
                                                                     *plan))
                got_all.append(got)
            # Resident: one ring chunk of the padded P / n elements.
            P = -(-L // (n * ring._TILE)) * n * ring._TILE
            got = ring.allreduce_direct_plain(x, P // n, 1)
            assert torch.equal(got, ring.allreduce_resident_plain(xc))
            assert torch.equal(got, ring.allreduce_resident_direct_plain(x))
            got_all.append(got)
            # Every rank holds the same sum.
            for g in got_all:
                assert all(torch.equal(g[r], g[0]) for r in range(n))
        else:
            got = ring.reduce_scatter_direct_plain(x)
            assert got.shape == (n, L // n) and got.dtype == dt
            for cb in CHUNK_BYTES:
                cb = cb * dt.itemsize // 4
                name, plan = ring.schedule_reduce_scatter(L, n, dt,
                                                          chunk_bytes=cb)
                assert name == "ring_reduce_scatter_chunked", (n, L, cb)
                assert torch.equal(got, ring.reduce_scatter_chunked_plain(
                    xc, *plan))
            assert torch.equal(got, ring.reduce_scatter_resident_plain(xc))
        if dt == torch.int32:
            want = xc.sum(0, dtype=torch.int32)
            if row == "allreduce":
                assert torch.equal(got[0], want)
            else:
                assert torch.equal(got.reshape(-1), want)


# Row 7 also at 40,003 elements: the second half starts at element 20,001,
# off every dtype's 16-byte boundary (the kernel peels it to the boundary;
# the fold's order does not depend on it).
BIDIR_LENGTHS = LENGTHS + (40_003,)


@pytest.mark.parametrize("L", BIDIR_LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_bidir_direct_order_equals_the_ring(n, dtype, L):
    dt = DTYPES[dtype]
    chunked = 0
    for pad in (0, 3):
        x = _stack(n, L, dt, seed=n * 1000 + L + pad + 7, pad=pad)
        xc = x.contiguous()
        for cb in CHUNK_BYTES:
            cb = cb * dt.itemsize // 4
            # The half plan; where its halves are chunked (C > 1) it is the
            # plan the schedule gives row 7.  A one-chunk plan (8 KiB at the
            # smallest L and n >= 5) still fixes an order to hold.
            plan = ring._chunk_plan(-(-L // 2), n, dt, cb)
            if plan[1] > 1:
                chunked += 1
                assert ring.schedule(L, n, dt, chunk_bytes=cb,
                                     bidirectional=True) == (
                    "ring_allreduce_bidir_chunked", plan)
            got = ring.allreduce_bidir_direct_plain(x, *plan)
            assert got.shape == x.shape and got.dtype == dt
            assert torch.equal(got, ring.allreduce_bidir_chunked_plain(
                xc, *plan)), (n, L, cb, pad)
            # Every rank holds the same sum.
            assert all(torch.equal(got[r], got[0]) for r in range(n))
        if dt == torch.int32:
            assert torch.equal(got[0], xc.sum(0, dtype=torch.int32))
    assert chunked >= 2


def _resident_ce(m, n):
    """A resident half's ring chunk: m padded to a multiple of n TILE,
    over n."""
    return -(-m // (n * 1024)) * 1024


# Row 12: L 16,385 pads its halves (8,192 and 8,193) apart for 4 and 8
# ranks; 40,003 starts half 2 off every dtype's 16-byte boundary.
RESIDENT_BIDIR_LENGTHS = (16_385, 40_003, 65_536, 77_777)


@pytest.mark.parametrize("L", RESIDENT_BIDIR_LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_bidir_resident_fold_equals_the_ring(n, dtype, L):
    dt = DTYPES[dtype]
    ce1, ce2 = _resident_ce(L // 2, n), _resident_ce(L - L // 2, n)
    if L == 16_385 and n in (4, 8):
        assert ce1 != ce2, (n, ce1, ce2)
    assert ring.schedule(L, n, dt, chunk_bytes=4 << 20,
                         bidirectional=True) == ("ring_allreduce_bidir", ())
    for pad in (0, 3):
        x = _stack(n, L, dt, seed=n * 1000 + L + pad + 11, pad=pad)
        want = ring.allreduce_bidir_resident_plain(x.contiguous())
        got = ring.allreduce_bidir_fold(x, ce1, ce2)
        assert got.shape == x.shape and got.dtype == dt
        assert torch.equal(got, want), (n, L, pad)
        assert torch.equal(ring.allreduce_bidir_resident_direct_plain(x),
                           want)
        assert all(torch.equal(got[r], got[0]) for r in range(n))
        if dt == torch.int32:
            assert torch.equal(got[0], x.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_row7_fold_is_the_two_length_fold_with_equal_lengths(n, dtype):
    dt = DTYPES[dtype]
    L = 40_003
    x = _stack(n, L, dt, seed=n + 31, pad=3)
    plan = ring._chunk_plan(-(-L // 2), n, dt, 4096 * dt.itemsize // 4)
    assert plan[1] > 1
    ce = plan[0] * plan[1]
    got = ring.allreduce_bidir_fold(x, ce, ce)
    assert torch.equal(got, ring.allreduce_bidir_direct_plain(x, *plan))
    assert torch.equal(got, ring.allreduce_bidir_chunked_plain(
        x.contiguous(), *plan))


def _folding_call(log):
    """A stand-in for ``ring._call`` on the direct allreduce rows: records
    the launcher's arguments and folds as ring_direct.cu does with them."""
    def call(lib, name, args, x):
        assert lib == "ring_direct"
        xs, ldx, out, ldo, L, *ces, n, _ = args
        assert xs is x and ldx == x.stride(0) and ldo == out.shape[1]
        assert n == x.shape[0] and L == x.shape[1]
        log.append((name, tuple(ces)))
        if len(ces) == 2:
            out[:, :L] = ring.allreduce_bidir_fold(x, *ces)
        else:
            out[:, :L] = ring.allreduce_direct_plain(x, ces[0], 1)
    return call


@pytest.mark.parametrize("L", [16_385, 40_003])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", ["ring_allreduce", "ring_allreduce_bidir",
                                  "ring_allreduce_chunked",
                                  "ring_allreduce_bidir_chunked"])
def test_wrapper_launch_arguments(monkeypatch, name, n, L):
    """What the wrappers pass the launcher on a CUDA tensor: the chunked
    rows the plan's C sub_elems (row 7 twice), row 11 the padded P / n,
    row 12 each half's own; with the launch standing in as a fold, the
    kernel path's result is the plain ring's, bitwise."""
    log = []
    monkeypatch.setattr(ring, "_call", _folding_call(log))
    dt = torch.float32
    x = _stack(n, L, dt, seed=n * 7 + L, pad=3)
    bidir = "bidir" in name
    cb = 4 << 20 if "chunked" not in name else 4096
    picked, plan = ring.schedule(L, n, dt, chunk_bytes=cb,
                                 bidirectional=bidir)
    assert picked == name
    got = ring._run(name, x, plan, plain=False)
    assert torch.equal(got, ring.PLAINS[name](x, *plan))
    if plan:
        want = (plan[0] * plan[1],) * (2 if bidir else 1)
    elif bidir:
        want = (_resident_ce(L // 2, n), _resident_ce(L - L // 2, n))
    else:
        want = (_resident_ce(L, n),)
    assert log == [(name, want)]
    assert torch.equal(got, ring.FOLDS[name](x, *plan))


# Shard lengths of the all-gather: 4096 fills its plan (C 4 of 1024, no
# padding), 5000 and 20_001 pad the last subchunk.
GATHER_LENGTHS = (4096, 5000, 20_001)


@pytest.mark.parametrize("per", GATHER_LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 11])
def test_direct_gather_equals_the_ring(n, dtype, per):
    dt = DTYPES[dtype]
    name, plan = ring.schedule_all_gather(per, n, dt,
                                          chunk_bytes=4096 * dt.itemsize // 4)
    assert name == "ring_all_gather_chunked", (n, per)
    E, C = plan
    assert (C * E == per) == (per == 4096), plan
    for pad in (0, 3):
        x = _stack(n, per, dt, seed=n * 100 + per + pad, pad=pad)
        got = ring.all_gather_direct_plain(x)
        assert got.shape == (n, n, per) and got.dtype == dt
        assert got.is_contiguous()
        assert torch.equal(got, ring.all_gather_chunked_plain(
            x.contiguous(), *plan))
        assert torch.equal(got, ring.all_gather_resident_plain(
            x.contiguous()))
        for r in range(n):
            assert torch.equal(got[r], x)


def _scatter_gather_call(log):
    """A stand-in for ``ring._call`` on the reduce-scatter and all-gather
    rows: records the launcher and its size arguments, and folds (or
    copies) as ring_direct.cu does with them."""
    def call(lib, name, args, x):
        assert lib == "ring_direct"
        sym = ring._SIGNATURES[name][0]
        if name.startswith("ring_reduce_scatter"):
            xs, ldx, out, ldo, per, n, _ = args
            assert ldo == out.stride(0)
            out[:, :per] = ring.reduce_scatter_direct_plain(xs[:, :n * per])
            sizes = (ldx, ldo, per, n)
        else:
            xs, ldx, out, per, n, _ = args
            assert out.is_contiguous() and out.shape == (n, n, per)
            out.copy_(ring.all_gather_direct_plain(xs[:, :per]))
            sizes = (ldx, per, n)
        assert xs is x and ldx == x.stride(0) and n == x.shape[0]
        log.append((sym, sizes))
    return call


# Elements of one ring chunk (reduce-scatter) or one shard (all-gather):
# odd, so neither a TILE nor a 16-byte multiple.
SCATTER_GATHER_PER = 20_001


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("verb", ["reduce_scatter", "all_gather"])
def test_scatter_gather_launch_arguments(monkeypatch, verb, n, pad):
    """Rows 9 and 13 (10 and 14) on a CUDA tensor, the launch standing in
    as the kernel's fold (copy): the chunked and the resident row call the
    same launcher with the same arguments, and each gives the plain ring's
    result bitwise, on contiguous and on row-padded inputs."""
    log = []
    monkeypatch.setattr(ring, "_call", _scatter_gather_call(log))
    dt = torch.float32
    per = SCATTER_GATHER_PER
    rs = verb == "reduce_scatter"
    x = _stack(n, n * per if rs else per, dt, seed=n * 13 + pad, pad=pad)
    schedule = (ring.schedule_reduce_scatter if rs
                else ring.schedule_all_gather)
    for name, cb in ((f"ring_{verb}_chunked", 4096), (f"ring_{verb}",
                                                       4 << 20)):
        picked, plan = schedule(x.shape[1], n, dt, chunk_bytes=cb)
        assert picked == name and bool(plan) == name.endswith("_chunked")
        got = ring._run_rs(name, x, plan, plain=False) if rs else \
            ring._run_ag(name, x, plan, plain=False)
        assert torch.equal(got, ring.PLAINS[name](x.contiguous(), *plan))
        fold = (ring.reduce_scatter_direct_plain if rs
                else ring.all_gather_direct_plain)
        assert torch.equal(got, fold(x))
    assert len(log) == 2 and log[0] == log[1], log
    sym = ("tm_ring_reduce_scatter_direct" if rs
           else "tm_ring_all_gather_direct")
    assert log[0][0] == sym
