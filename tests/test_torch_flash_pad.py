"""Head dims the flash kernels are not built for, on the CPU (no JAX).

The CUDA kernels are instantiated for head dims 16, 32, 64 and 128; on a
CUDA tensor the wrappers (``flash.flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``) zero-pad q / k / v / dO to the next of them
(``flash.pad_head_dim``), launch with the scale of the true D, and slice
the outputs back.  Here the plain versions (the kernels' references) are
run on inputs padded that way and held to their unpadded results: zero
columns add nothing to q . k, and v's only give output columns that are
sliced off.  The kernels at these head dims against the plain versions
are the ``gpu``-marked tests/test_torch_flash_kernels.py.
"""

import math

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.ops import flash

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, B, Tq, Tkv, H, Hkv, D):
    rng = np.random.RandomState(seed)
    shapes = ((B, Tq, H, D), (B, Tkv, Hkv, D), (B, Tkv, Hkv, D), (B, Tq, H, D))
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in shapes)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("D,Dk", [(8, 16), (24, 32), (48, 64), (96, 128)])
def test_padded_plain_versions_equal_unpadded(D, Dk, window):
    q, k, v, do = _inputs(D + (window or 0), 2, 37, 45, 4, 2, D)
    kw = dict(scale=1.0 / math.sqrt(D), causal=True, window=window,
              q_offset=8, kv_offset=0)
    qp, kp, vp, dop = flash.pad_head_dim("flash_bwd_dq", q, k, v, do)
    assert qp.shape[-1] == kp.shape[-1] == dop.shape[-1] == Dk
    assert qp.is_contiguous() and torch.equal(qp[..., :D], q)
    assert not qp[..., D:].any()

    o, lse = flash.flash_fwd_plain(q, k, v, **kw)
    op, lsep = flash.flash_fwd_plain(qp, kp, vp, **kw)
    torch.testing.assert_close(op[..., :D], o, **TOL)
    torch.testing.assert_close(lsep, lse, **TOL)
    assert not op[..., D:].any()

    dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
    dq = flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw)
    dqp = flash.flash_bwd_dq_plain(qp, kp, vp, dop, lse, dvec, **kw)
    torch.testing.assert_close(dqp[..., :D], dq, **TOL)
    dk, dv = flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    dkp, dvp = flash.flash_bwd_dkv_plain(qp, kp, vp, dop, lse, dvec, **kw)
    torch.testing.assert_close(dkp[..., :D], dk, **TOL)
    torch.testing.assert_close(dvp[..., :D], dv, **TOL)


def test_kernel_head_dims():
    got = {D: flash.kernel_head_dim(D) for D in (1, 8, 16, 17, 24, 33, 48,
                                                  64, 65, 96, 127, 128)}
    assert got == {1: 16, 8: 16, 16: 16, 17: 32, 24: 32, 33: 64, 48: 64,
                   64: 64, 65: 128, 96: 128, 127: 128, 128: 128}
    # A kernel head dim is not copied.
    q = torch.zeros(1, 4, 2, 32)
    assert flash.pad_head_dim("flash_fwd", q, q)[0] is q
    with pytest.raises(ValueError, match="flash_fwd: head_dim 160"):
        flash.pad_head_dim("flash_fwd", torch.zeros(1, 4, 2, 160))
