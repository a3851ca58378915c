"""Shared cases of the port's ring tests (tests/test_torch_ring*.py): the
port's ring allreduce, reduce-scatter and all-gather against the JAX
package's ring kernels.

The JAX side runs ``ring.ring_allreduce`` under ``shard_map`` on an n-device
sub-mesh of the 8-device CPU mesh, its Pallas kernels in interpret mode (as
tests/test_ring.py runs them).  The port's side runs the same rank-major
stack through its wrapper, which takes the plain PyTorch version of each
kernel for CPU tensors.  The layouts are the same (padding, half split,
[n, C, sub] views), and an element's ring chunk fixes the order of its adds,
so the two must agree bitwise for float32, bfloat16 and int32.  Every size
is chosen so that the plan JAX's interpreter executes is the full plan.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.ops import ring as jring
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.ops import ring as tring

TILE = 1024
SMALL_CHUNK = 4096  # chunk_bytes of the chunked cases: 1024 f32 / i32, 2048 bf16
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (np.int32, torch.int32)}
KERNELS = ("ring_allreduce", "ring_allreduce_bidir", "ring_allreduce_chunked",
           "ring_allreduce_bidir_chunked")
RS_AG_KERNELS = ("ring_reduce_scatter", "ring_reduce_scatter_chunked",
                 "ring_all_gather", "ring_all_gather_chunked")


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """One JAX runtime (flat 1 x 8 mesh, explicit Config) and one port
    runtime (CPU, gloo, world of one) for the whole module, whatever an
    earlier test file in the worker left running; the JAX ring in
    interpret mode."""
    if not hasattr(pltpu, "InterpretParams"):
        pytest.skip("pallas TPU interpreter unavailable on this jax")
    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1))
    tmpi.init(device="cpu")
    jring.set_interpret(pltpu.InterpretParams())
    yield
    jring.set_interpret(None)
    tmpi.stop()
    jmpi.stop()


def configure(**kw):
    """The same knobs on both runtimes."""
    jmpi.set_config(**kw)
    tmpi.set_config(**kw)


def jax_allreduce(x, op="sum"):
    """x [n, L] through the JAX ring on the first n CPU devices."""
    n = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("ring",))

    def body(xs):
        return jring.ring_allreduce(xs[0], ("ring",), op=op)[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("ring"),
                           out_specs=P("ring"), check_vma=False))
    return np.asarray(fn(jax.device_put(jnp.asarray(x),
                                        NamedSharding(mesh, P("ring")))))


def jax_reduce_scatter(x):
    """x [n, k, ...] through the JAX ring reduce-scatter on the first n CPU
    devices: [n, k / n, ...]."""
    return _jax_ring(lambda v: jring.ring_reduce_scatter(v, ("ring",)), x)


def jax_all_gather(x):
    """x [n, ...] through the JAX ring all-gather: [n, n, ...]."""
    return _jax_ring(lambda v: jring.ring_all_gather(v, ("ring",)), x)


def _jax_ring(fn, x):
    n = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("ring",))
    body = jax.jit(shard_map(lambda xs: fn(xs[0])[None], mesh=mesh,
                             in_specs=P("ring"), out_specs=P("ring"),
                             check_vma=False))
    return np.asarray(body(jax.device_put(jnp.asarray(x),
                                          NamedSharding(mesh, P("ring")))))


def to_torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def bits(a):
    """Bit pattern of a numpy / torch array, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    elif a.dtype == jnp.bfloat16:
        a = a.view(np.int16)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def stack(n, L, dtype, seed):
    """Seeded [n, L] (or [n, *L] for a tuple L) of ``dtype``."""
    shape = (n,) + (tuple(L) if isinstance(L, tuple) else (L,))
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return rng.randint(-1000, 1000, size=shape).astype(np.int32)
    return np.asarray(jnp.asarray(rng.randn(*shape).astype(np.float32),
                                  dtype))


def max_c(n):
    """The deepest plan JAX's interpreter runs uncoarsened (ring.py :410)."""
    return max(2, jring._INTERPRET_MAX_ITERS // (2 * (n - 1)))


def case(kernel, n, dtype, ragged):
    """(L, config) for which the schedule picks ``kernel`` with a plan the
    interpreter runs uncoarsened; ``ragged`` sizes are off every padding
    boundary (and odd, so the halves differ by one)."""
    sub = SMALL_CHUNK // np.dtype(dtype).itemsize
    C = min(3, max_c(n))
    if kernel == "ring_allreduce":
        L = 3 * TILE + 5 if ragged else 2 * n * TILE
        cfg = dict(chunk_bytes=4 << 20, pallas_bidirectional=False)
    elif kernel == "ring_allreduce_bidir":
        L = 2 * n * TILE + (77 if ragged else 0)
        cfg = dict(chunk_bytes=4 << 20, pallas_bidirectional=True)
    elif kernel == "ring_allreduce_chunked":
        L = n * C * sub - (3 if ragged else 0)
        cfg = dict(chunk_bytes=SMALL_CHUNK, pallas_bidirectional=False)
    else:
        L = 2 * n * C * sub - (3 if ragged else 0)
        cfg = dict(chunk_bytes=SMALL_CHUNK, pallas_bidirectional=True)
    return L, cfg


def check_parity(kernel, n, dtype_name, *, op="sum", seed=0):
    """Run ``kernel``'s case for (n, dtype) through both packages and hold
    the port bitwise to JAX.  float32 and int32 take ragged sizes, bfloat16
    one on the padding boundary."""
    npdt, tdt = DTYPES[dtype_name]
    L, cfg = case(kernel, n, npdt, ragged=dtype_name != "bf16")
    configure(**cfg)
    cb, bidir = cfg["chunk_bytes"], cfg["pallas_bidirectional"]
    picked, plan = tring.schedule(L, n, tdt, chunk_bytes=cb,
                                  bidirectional=bidir)
    assert picked == kernel, (dtype_name, L)
    # The plan the JAX kernel executes is the full one: its interpreter
    # does not coarsen it (the warning is an error here).  Row 7 runs the
    # half plan; JAX also plans the whole length first, only to pick the
    # row, and may coarsen that unused plan.
    planned = -(-L // 2) if kernel == "ring_allreduce_bidir_chunked" else L
    with warnings.catch_warnings():
        warnings.simplefilter("error", jring.RingInterpretCoarseningWarning)
        assert jring._effective_plan(planned, n, npdt, cb, True) == \
            tring._chunk_plan(planned, n, tdt, cb)
    x = stack(n, L, npdt, seed=seed)
    with warnings.catch_warnings():
        if kernel == "ring_allreduce_bidir_chunked":
            warnings.simplefilter("ignore",
                                  jring.RingInterpretCoarseningWarning)
        else:
            warnings.simplefilter("error",
                                  jring.RingInterpretCoarseningWarning)
        want = jax_allreduce(x, op=op)
    got = tring.ring_allreduce(to_torch(x), op=op)
    assert got.shape == (n, L)
    assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name
    np.testing.assert_array_equal(bits(got), bits(want),
                                  err_msg=f"{kernel} n={n} {dtype_name} {op}")
    if dtype_name == "i32" and op == "sum":
        np.testing.assert_array_equal(want[0], x.sum(0))
    return plan


def rs_ag_case(kernel, n, dtype, ragged):
    """(elements of one ring chunk, chunk_bytes) for which the schedule
    picks ``kernel`` with a plan the interpreter runs uncoarsened (its cap
    on the n - 1 steps' iterations, ring.py :410): ragged chunks are off
    every padding boundary.  Chunks stay within 12 KB: on 8-rank rings the
    Pallas interpreter wedges (no progress, no error) once a ring chunk
    pads to 16 KB (4096 float32), which no real lowering does."""
    if kernel.endswith("_chunked"):
        sub = SMALL_CHUNK // np.dtype(dtype).itemsize
        C = min(3, max(2, jring._INTERPRET_MAX_ITERS // (n - 1)))
        return C * sub - (3 if ragged else 0), SMALL_CHUNK
    return (2 * TILE + 5 if ragged else 2 * TILE), 4 << 20


def check_rs_ag_parity(kernel, n, dtype_name, *, seed=0):
    """Run ``kernel``'s case for (n, dtype) through both packages' entry
    points and hold the port bitwise to JAX; float32 and int32 take ragged
    chunks, bfloat16 one on the padding boundary."""
    npdt, tdt = DTYPES[dtype_name]
    per, cb = rs_ag_case(kernel, n, npdt, ragged=dtype_name != "bf16")
    configure(chunk_bytes=cb)
    rs = kernel.startswith("ring_reduce_scatter")
    if rs:
        picked, plan = tring.schedule_reduce_scatter(n * per, n, tdt,
                                                     chunk_bytes=cb)
    else:
        picked, plan = tring.schedule_all_gather(per, n, tdt, chunk_bytes=cb)
    assert picked == kernel, (dtype_name, per)
    # Both JAX entries plan on the n ranks' n * per elements (:1030, :1076).
    planned = n * per
    x = stack(n, n * per if rs else per, npdt, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("error", jring.RingInterpretCoarseningWarning)
        assert jring._effective_plan(planned, n, npdt, cb, True,
                                     steps=n - 1) == \
            tring._chunk_plan(planned, n, tdt, cb)
        want = jax_reduce_scatter(x) if rs else jax_all_gather(x)
    got = (tring.ring_reduce_scatter if rs else tring.ring_all_gather)(
        to_torch(x))
    assert got.shape == want.shape
    assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name
    np.testing.assert_array_equal(bits(got), bits(want),
                                  err_msg=f"{kernel} n={n} {dtype_name}")
    if dtype_name == "i32":
        expect = (x.reshape(n, n, per).sum(0) if rs
                  else np.broadcast_to(x, (n,) + x.shape))
        np.testing.assert_array_equal(want, expect)
    return plan
