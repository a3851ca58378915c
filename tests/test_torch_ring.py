"""The port's ring allreduce (torchmpi_tpu_torch/ops/ring.py, the "pallas"
backend) against the JAX package's ring kernels on the CPU, for rings of 2
and 4 ranks, and the port's selector rules and process-world behaviour.

The comparison itself is in tests/_torch_ring_cases.py; rings of 8 ranks
and the fused gradient sync are tests/test_torch_ring_wide.py.  Both
runtimes are set up once per module with explicit configs (never left to
whatever an earlier test file in the same worker initialized) and torn
down after it.
"""

import os
import socket
import subprocess
import sys
import textwrap

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

from _torch_ring_cases import (DTYPES, KERNELS, check_parity, configure,
                               runtimes, stack, to_torch)  # noqa: F401

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_ring_allreduce_bitwise_equals_jax(kernel, n, dtype):
    check_parity(kernel, n, dtype, seed=100 * n + len(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", ["ring_allreduce",
                                    "ring_allreduce_bidir_chunked"])
def test_ring_allreduce_mean_bitwise_equals_jax(kernel, dtype):
    """op="mean" is ``out / n`` on both sides; an int32 mean is float32."""
    check_parity(kernel, 2, dtype, op="mean", seed=7)


def test_plan_functions_match_jax():
    for n in (2, 4, 8):
        for L in (1, 1000, 8192, 8193, 100_000, 486_731_776 // 59):
            for tdt, jdt in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
                for cb in (4096, 1 << 20, 4 << 20, 16 << 20):
                    assert tring._chunk_plan(L, n, tdt, cb) == \
                        jring._chunk_plan(L, n, jdt, cb)
                    assert tring._chunk_plan(L, n, tdt, cb) == \
                        jring._effective_plan(L, n, jdt, cb, False)
            x = np.arange(2 * L, dtype=np.float32).reshape(2, L)
            t, pad = tring._pad_and_tile(torch.from_numpy(x), n)
            j, jpad = jring._pad_and_tile(jnp.asarray(x[1]), n)
            assert pad == jpad and tuple(t.shape[1:]) == j.shape
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j))


def test_ring_rejects_what_jax_rejects():
    xs = torch.ones(4, 10, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        tring.ring_allreduce(xs)
    with pytest.raises(KeyError):
        tring.ring_allreduce(torch.ones(4, 10), op="max")
    one = torch.arange(6.0).reshape(1, 6)
    out = tring.ring_allreduce(one)
    assert torch.equal(out, one) and out.data_ptr() != one.data_ptr()
    before = dict(tring.LAUNCHES)
    tring.ring_allreduce(torch.ones(4, 3000))
    assert tring.LAUNCHES == before  # CPU tensors never launch


def test_selector_rules():
    """The JAX selector's rules (selector.py :86-150) on the rank-major
    allreduce: the custom_min_bytes cutover for a config backend, its
    bypass by an explicit backend, the fallback for an op with no pallas
    implementation, and the refusal of unknown backends."""
    ring_impl = tsel.available("allreduce_rank_major")["pallas"]
    stock = tsel.available("allreduce_rank_major")["xla"]
    configure(backend="pallas", custom_min_bytes=64 * 1024)
    try:
        small, big = 1024, 64 * 1024
        assert tsel.select("allreduce_rank_major", nbytes=small) is stock
        assert tsel.select("allreduce_rank_major", nbytes=big) is ring_impl
        assert tsel.select("allreduce_rank_major", "pallas",
                           nbytes=small) is ring_impl
        assert tsel.select("broadcast", "pallas") is \
            tsel.available("broadcast")["xla"]
        with pytest.raises(ValueError):
            tsel.select("allreduce", "nccl")
        with pytest.warns(RuntimeWarning, match="flat world"):
            tsel._warned_fallbacks.discard(("allreduce_rank_major",
                                            "hierarchical"))
            assert tsel.select("allreduce_rank_major", "hierarchical",
                               ranks=4) is stock
        with pytest.raises(ValueError):
            tsel.select("fused_reduce_scatter", "xla")
        # Through the collective: below the cutover the stock route runs
        # (no ring arithmetic), above it the ring; both give the sum.
        x = to_torch(stack(4, 300, np.float32, seed=3))
        got = tmpi.allreduce_rank_major(x)
        assert torch.equal(got, x.sum(0).expand_as(x))
        for op in ("sum", "mean"):
            want = tring.ring_allreduce(x, op=op)
            assert torch.equal(
                tmpi.allreduce_rank_major(x, op=op, backend="pallas"), want)
        # The process world of one: the ring of one member is a copy.
        y = tmpi.allreduce(x[0], backend="pallas")
        assert torch.equal(y, x[0]) and y.data_ptr() != x[0].data_ptr()
    finally:
        configure(backend="xla", custom_min_bytes=64 * 1024)
    with pytest.raises(ValueError, match="leading"):
        tmpi.allreduce_rank_major(torch.ones(()))


TWO_RANKS = textwrap.dedent("""
    import sys
    import torch
    sys.path.insert(0, {repo!r})
    import torchmpi_tpu_torch as mpi

    rank, port = {rank}, {port}
    mpi.init(device="cpu", init_method=f"tcp://localhost:{{port}}",
             rank=rank, world_size=2)
    try:
        mpi.allreduce(torch.ones(4), backend="pallas")
        print("NO RAISE")
    except NotImplementedError as e:
        print("RAISED", "queue B" in str(e))
    print("STOCK", mpi.allreduce(torch.ones(4) * (rank + 1)).tolist())
    mpi.barrier()
    mpi.stop()
""")


def test_pallas_across_two_gloo_processes_raises():
    """Across processes the ring's peers would be another process's
    buffers: backend "pallas" raises naming ROADMAP queue B, and never
    falls back to the process group's own allreduce."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", TWO_RANKS.format(repo=REPO, rank=r,
                                                port=port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "RAISED True" in out, out
        assert "STOCK [3.0, 3.0, 3.0, 3.0]" in out, out


def test_stock_rank_major_route_matches_jax_eager():
    """backend "xla" of the rank-major allreduce against the JAX package's
    eager rank-major allreduce (stock route) on its 8-device mesh."""
    x = stack(8, 1000, np.int32, seed=21)
    want = np.asarray(jmpi.allreduce(x, backend="xla"))
    got = tcoll.allreduce_rank_major(torch.from_numpy(x), backend="xla")
    np.testing.assert_array_equal(got.numpy(), want)
