"""The port's ring allreduce against the JAX package's ring kernels for
rings of 8 ranks (the JAX package's own test mesh), and the fused
rank-major gradient sync of a small TransformerLM against the JAX
package's ``synchronize_gradients(..., backend="pallas")``.

The comparison is in tests/_torch_ring_cases.py; rings of 2 and 4 ranks
are tests/test_torch_ring.py.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.ops import ring as jring
from torchmpi_tpu.parallel import gradsync as jgradsync
from torchmpi_tpu_torch import fusion as tfusion
from torchmpi_tpu_torch.models import TransformerLM

from _torch_ring_cases import (DTYPES, KERNELS, bits, check_parity, configure,
                               runtimes)  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", KERNELS)
def test_ring_allreduce_bitwise_equals_jax_8_ranks(kernel, dtype):
    check_parity(kernel, 8, dtype, seed=800 + len(dtype))


LM_CFG = dict(vocab=64, embed=32, depth=1, num_heads=4, head_dim=8,
              num_kv_heads=2, max_len=16, window=8, pos_emb="rope")


def test_fused_rank_major_gradsync_bitwise_equals_jax():
    """Eight ranks' gradients of a small TransformerLM (one sequence each,
    computed by the port): the port's fused rank-major allreduce under
    backend "pallas" against the JAX package's synchronize_gradients(...,
    backend="pallas") on the 8-device mesh.  Both cut the gradient list
    into the same FusedSpec buckets (fuse_max_bytes 32 KiB: two
    buckets) and run one ring per bucket, so the means agree bitwise."""
    n = 8
    model = TransformerLM(**LM_CFG, attn_impl="flash", device="cpu",
                          generator=torch.Generator().manual_seed(5))
    tok = torch.from_numpy(np.random.RandomState(9).randint(
        0, LM_CFG["vocab"], size=(n, 16))).long()
    params = list(model.parameters())
    stacks = [torch.empty(n, *p.shape) for p in params]
    for r in range(n):
        model.zero_grad(set_to_none=True)
        logits = model(tok[r:r + 1])
        torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, LM_CFG["vocab"]),
            tok[r:r + 1, 1:].reshape(-1)).backward()
        for s, p in zip(stacks, params):
            s[r] = p.grad
    per_rank = [s.numpy().copy() for s in stacks]

    configure(fuse_max_bytes=32 * 1024, chunk_bytes=4 << 20,
               pallas_bidirectional=False)
    try:
        spec = tfusion.FusedSpec([s[0] for s in stacks])
        assert spec.n_launches == 2
        launches = tfusion.fused_allreduce_rank_major_(
            stacks, backend="pallas", op="mean")
        assert launches == spec.n_launches

        mesh = jmpi.world_mesh()
        axes = tuple(mesh.axis_names)

        def body(*gs):
            synced = jgradsync.synchronize_gradients(
                [g[0] for g in gs], axes, backend="pallas")
            return tuple(g[None] for g in synced)

        spec_in = tuple(P(axes) for _ in per_rank)
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=spec_in,
                               out_specs=spec_in, check_vma=False))
        with warnings.catch_warnings():
            warnings.simplefilter("error",
                                  jring.RingInterpretCoarseningWarning)
            want = fn(*[jax.device_put(g, NamedSharding(mesh, P(axes)))
                        for g in per_rank])
    finally:
        configure(fuse_max_bytes=32 * 1024 * 1024)
    for name, got, w, g in zip([nm for nm, _ in model.named_parameters()],
                               stacks, want, per_rank):
        np.testing.assert_array_equal(bits(got), bits(np.asarray(w)),
                                      err_msg=name)
        # and it is the mean over ranks, to rounding
        np.testing.assert_allclose(got[0].numpy(), g.mean(0), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
