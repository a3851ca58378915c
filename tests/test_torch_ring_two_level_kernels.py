"""The ring kernels on a two-level (dcn x ici) grid, on the card.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_ring_two_level_kernels.py -q

On ``n_dcn`` nodes (the selector passes the world's, ``Config.dcn_size``),
``ring_allreduce`` / ``ring_reduce_scatter`` / ``ring_all_gather`` ring over
each node's ici ranks (one launch of the row
per node, on the node's rows of the stack) and fold or gather the dcn
level around it (ROADMAP queue B variant 3).  Each call is held bitwise to
the same composition through the plain versions, its launches counted
(one per node), and the replicated rows' launches on the 16-byte path
where the rows are 16-byte aligned.  The CPU parity of the composition
with the JAX package's ring is tests/test_torch_hierarchical.py.
"""

import pytest
import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.ops import _build, ring

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _build.build(["ring_direct"])
    mpi.stop()
    mpi.init()
    yield torch.device("cuda")
    mpi.stop()


def _stack(dev, n, L, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2 ** 20, 2 ** 20, (n, L), generator=g,
                             device=dev, dtype=torch.int32)
    return torch.randn(n, L, generator=g, device=dev).to(dtype)


# (verb, n_dcn, n, L, chunk_bytes, row): every row of the replicated sync
# and of ZeRO's legs, on 2 x 2, 2 x 4 and 4 x 2 grids.
CASES = [
    ("allreduce", 2, 4, 100_000, 4 << 20, "ring_allreduce"),
    ("allreduce", 2, 4, 1_000_003, 64 << 10, "ring_allreduce_chunked"),
    ("allreduce", 2, 8, 300_000, 64 << 10, "ring_allreduce_chunked"),
    ("allreduce", 4, 8, 50_001, 4 << 20, "ring_allreduce"),
    ("reduce_scatter", 2, 4, 800_000, 4 << 20, "ring_reduce_scatter"),
    ("reduce_scatter", 2, 4, 2_000_000, 64 << 10,
     "ring_reduce_scatter_chunked"),
    ("reduce_scatter", 2, 8, 640_000, 64 << 10,
     "ring_reduce_scatter_chunked"),
    ("all_gather", 2, 4, 100_000, 4 << 20, "ring_all_gather"),
    ("all_gather", 2, 4, 1_000_000, 64 << 10, "ring_all_gather_chunked"),
    ("all_gather", 4, 8, 200_000, 64 << 10, "ring_all_gather_chunked"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("verb,n_dcn,n,L,chunk_bytes,row", CASES,
                         ids=lambda v: str(v))
def test_two_level_rows_bitwise_and_one_launch_per_node(
        cuda, verb, n_dcn, n, L, chunk_bytes, row, dtype):
    mpi.set_config(chunk_bytes=chunk_bytes * torch.empty(
                       (), dtype=dtype).element_size() // 4)
    x = _stack(cuda, n, L, dtype, seed=L + n)
    fn = getattr(ring, f"ring_{verb}")
    plain = getattr(ring, f"ring_{verb}_plain")
    ring.reset_launches()
    got = fn(x, n_dcn=n_dcn)
    launched = {k: v for k, v in ring.LAUNCHES.items() if v}
    want = plain(x, n_dcn=n_dcn)
    assert launched == {row: n_dcn}, launched
    assert torch.equal(got, want)
    if verb == "allreduce" and L * x.element_size() % 16 == 0:
        assert ring.VECTOR_LAUNCHES[row] == n_dcn


def test_fused_sync_on_the_grid(cuda):
    """The fused rank-major sync (``backend="pallas"``) on a 2 x 2 grid:
    each bucket launches once per node, and every rank's rows are within
    1e-6 of the plain composition of each stack."""
    mpi.set_config(dcn_size=2, chunk_bytes=4 << 20,
                   fuse_max_bytes=4 << 20)
    stacks = [_stack(cuda, 4, L, torch.float32, seed=L)
              for L in (700_000, 1_300_001, 5)]
    want = [ring.ring_allreduce_plain(s.reshape(4, -1), op="mean", n_dcn=2)
            for s in stacks]
    ring.reset_launches()
    spec = mpi.fusion.FusedSpec([s[0] for s in stacks])
    mpi.fusion.fused_allreduce_rank_major_(stacks, backend="pallas",
                                           op="mean")
    assert sum(ring.LAUNCHES.values()) == 2 * spec.n_launches
    # The fused buckets cut the stacks at other bounds than one call per
    # stack, so each element folds in its bucket's ring chunk: compare the
    # sums, not the bits, across layouts.
    for s, w in zip(stacks, want):
        torch.testing.assert_close(s, w, rtol=1e-6, atol=1e-6)
