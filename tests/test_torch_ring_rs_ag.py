"""The port's ring reduce-scatter and all-gather (torchmpi_tpu_torch/ops/ring.py,
rows 9, 10, 13 and 14 of the kernel table) against the JAX package's ring
kernels on the CPU, for rings of 2 and 4 ranks; the schedules against the
port's simulator; the new collective verbs and their selector routes.

The comparison is in tests/_torch_ring_cases.py (the JAX kernels in Pallas
interpret mode on sub-meshes of the 8-device CPU mesh, the port's plain
versions on CPU tensors); rings of 8 ranks are
tests/test_torch_ring_rs_ag_wide.py.  Both runtimes are set up once per
module with explicit configs and torn down after it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.ops import ring as jring
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import collectives as tcoll
from torchmpi_tpu_torch import selector as tsel
from torchmpi_tpu_torch.ops import ring as tring
from torchmpi_tpu_torch.ops import ring_sim as tsim

from _torch_ring_cases import (DTYPES, RS_AG_KERNELS, bits,
                               check_rs_ag_parity, configure,
                               jax_all_gather, jax_reduce_scatter, runtimes,
                               stack, to_torch)  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel", RS_AG_KERNELS)
def test_rs_ag_bitwise_equals_jax(kernel, n, dtype):
    check_rs_ag_parity(kernel, n, dtype, seed=100 * n + len(dtype))


@pytest.mark.parametrize("chunk_bytes", [4096, 4 << 20])
def test_trailing_dims_bitwise_equal_jax(chunk_bytes):
    """Leading-dim tiles of [k, 3, 5] tensors (whole rows, as
    ``psum_scatter(tiled=True)``), then their all-gather."""
    configure(chunk_bytes=chunk_bytes)
    n = 4
    x = stack(n, (4 * 37, 3, 5), np.float32, seed=5)
    shard = tring.ring_reduce_scatter(to_torch(x))
    assert shard.shape == (n, 37, 3, 5)
    np.testing.assert_array_equal(bits(shard), bits(jax_reduce_scatter(x)))
    gathered = tring.ring_all_gather(shard)
    assert gathered.shape == (n, n, 37, 3, 5)
    np.testing.assert_array_equal(
        bits(gathered), bits(jax_all_gather(shard.numpy())))


def test_plan_functions_match_jax():
    """The row and plan each entry picks, against the JAX entries' choice
    (:1030-1036, :1076-1079) with the full (uncoarsened) plan."""
    for n in (2, 4, 8):
        for per in (1, 1000, 8193, 100_000, 486_731_776 // 4):
            for tdt, jdt in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
                for cb in (4096, 1 << 20, 4 << 20, 512 << 20):
                    want = jring._effective_plan(n * per, n, jdt, cb, False,
                                                 steps=n - 1)
                    name, plan = tring.schedule_reduce_scatter(
                        n * per, n, tdt, chunk_bytes=cb)
                    assert (plan or (None, 1))[1] == want[1]
                    assert plan in ((), want)
                    assert name.endswith("_chunked") == (want[1] > 1)
                    name, plan = tring.schedule_all_gather(
                        per, n, tdt, chunk_bytes=cb)
                    assert plan in ((), want)
                    assert name.endswith("_chunked") == (want[1] > 1)
    # The flagship's ZeRO shapes: 4 ranks, 486,731,776 f32 a rank.
    assert tring.schedule_reduce_scatter(
        486_731_776, 4, torch.float32, chunk_bytes=4 << 20)[0] == \
        "ring_reduce_scatter_chunked"
    assert tring.schedule_reduce_scatter(
        486_731_776, 4, torch.float32, chunk_bytes=4 << 20)[1][1] == 117
    assert tring.schedule_all_gather(
        486_731_776 // 4, 4, torch.float32, chunk_bytes=512 << 20)[0] == \
        "ring_all_gather"


@pytest.mark.parametrize("n,C", [(2, 5), (4, 3), (8, 2)])
def test_schedules_match_the_simulator(n, C):
    """The plain reduce-scatter and all-gather, run on chunks of C
    subchunks, against the port's simulator of the chunked kernels' slot /
    ack protocol under a random interleaving: the same bits."""
    sub = 1024
    rng = np.random.RandomState(n * 10 + C)
    x = rng.randn(n, n, C, sub).astype(np.float32)
    got = tring.reduce_scatter_chunked(torch.from_numpy(x).reshape(n, -1),
                                       sub, C)
    want = tsim.simulate_reduce_scatter(x, C, rng=np.random.RandomState(3))
    np.testing.assert_array_equal(got.numpy(), want.reshape(n, -1))
    chunks = rng.randn(n, C, sub).astype(np.float32)
    gathered = tring.all_gather_chunked(
        torch.from_numpy(chunks).reshape(n, -1), sub, C)
    for d, w in enumerate(tsim.simulate_all_gather(
            chunks, C, rng=np.random.RandomState(4))):
        np.testing.assert_array_equal(gathered[d].numpy(),
                                      w.reshape(n, -1))


@pytest.mark.parametrize("chunk_bytes", [4096, 4 << 20])
def test_reduce_scatter_then_all_gather_is_the_allreduce(chunk_bytes):
    """The two legs compose to the ring allreduce's function: bitwise for
    int32, to float32 rounding otherwise (each adds in its own ring
    order)."""
    configure(chunk_bytes=chunk_bytes)
    n = 4
    for dt in (np.int32, np.float32):
        x = to_torch(stack(n, n * 3001, dt, seed=8))
        composed = tring.ring_all_gather(tring.ring_reduce_scatter(x))
        composed = composed.reshape(n, -1)
        allreduced = tring.ring_allreduce(x)
        if dt == np.int32:
            assert torch.equal(composed, allreduced)
        else:
            torch.testing.assert_close(composed, allreduced, rtol=1e-6,
                                       atol=1e-5)


def test_entries_reject_what_jax_rejects():
    xs = torch.ones(4, 8)
    with pytest.raises(KeyError):
        tring.ring_reduce_scatter(xs, op="mean")
    with pytest.raises(ValueError, match="divisible"):
        tring.ring_reduce_scatter(torch.ones(4, 6))
    with pytest.raises(TypeError, match="float32"):
        tring.ring_reduce_scatter(xs.half())
    with pytest.raises(TypeError, match="float32"):
        tring.ring_all_gather(xs.half())
    one = torch.arange(6.0).reshape(1, 6)
    assert torch.equal(tring.ring_reduce_scatter(one), one)
    assert tring.ring_all_gather(one).shape == (1, 1, 6)
    before = dict(tring.LAUNCHES)
    tring.ring_all_gather(tring.ring_reduce_scatter(torch.ones(4, 4000)))
    assert tring.LAUNCHES == before  # CPU tensors never launch


def test_selector_routes():
    """The rank-major verbs' routes (xla: a sum over the rank axis / a
    stacked copy; pallas: the ring) under the selector's rules, against
    the JAX package's eager stock routes; the process world of one."""
    stock_rs = tsel.available("reduce_scatter_rank_major")["xla"]
    ring_rs = tsel.available("reduce_scatter_rank_major")["pallas"]
    assert ring_rs is tring.ring_reduce_scatter
    assert tsel.available("allgather_rank_major")["pallas"] is \
        tring.ring_all_gather
    x = stack(8, (16, 3), np.int32, seed=21)
    np.testing.assert_array_equal(
        tcoll.reduce_scatter_rank_major(to_torch(x), backend="xla").numpy(),
        np.asarray(jmpi.reduce_scatter(x, backend="xla")))
    np.testing.assert_array_equal(
        tcoll.allgather_rank_major(to_torch(x), backend="xla").numpy(),
        np.asarray(jmpi.allgather(x, backend="xla")))
    configure(backend="pallas", custom_min_bytes=64 * 1024)
    try:
        assert tsel.select("reduce_scatter_rank_major", nbytes=1024) is \
            stock_rs
        assert tsel.select("reduce_scatter_rank_major",
                           nbytes=1 << 20) is ring_rs
        assert tsel.select("reduce_scatter_rank_major", "pallas",
                           nbytes=1024) is ring_rs
        xs = to_torch(stack(4, 4 * 300, np.float32, seed=3))
        for backend in ("xla", "pallas"):
            shard = tmpi.reduce_scatter_rank_major(xs, backend=backend)
            torch.testing.assert_close(shard.reshape(-1), xs.sum(0))
            assert torch.equal(tmpi.allgather_rank_major(shard,
                                                         backend=backend),
                               shard.expand(4, *shard.shape))
        with pytest.raises(ValueError, match="sum"):
            tmpi.reduce_scatter_rank_major(xs, op="mean", backend="xla")
        # The process world of one: the ring of one member.
        y = tmpi.reduce_scatter(xs[0], backend="pallas")
        assert torch.equal(y, xs[0]) and y.data_ptr() != xs[0].data_ptr()
        assert torch.equal(tmpi.allgather(xs[0], backend="pallas"),
                           xs[0][None])
        assert torch.equal(tmpi.reduce_scatter_in_axis(xs[0]), xs[0])
        assert torch.equal(tmpi.allgather_in_axis(xs[0], ("dcn", "ici")),
                           xs[0][None])
        assert torch.equal(tmpi.allgather_in_axis(xs[0], "ici"),
                           xs[0][None])
        with pytest.raises(ValueError, match="unknown axis 'tp'"):
            tmpi.allgather_in_axis(xs[0], "tp")
    finally:
        configure(backend="xla", custom_min_bytes=64 * 1024)
