"""The port's CUDA flash-attention kernels against their plain versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_flash_kernels.py -q

The CPU parity of the plain versions with the JAX package is
tests/test_torch_flash.py.
"""

import math

import pytest
import torch

from torchmpi_tpu_torch.ops import flash
from torchmpi_tpu_torch.parallel.sequence import reference_attention

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# f32 kernel vs f32 plain version: same math, another summation order.
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset)
CASES = [
    (1, 64, 64, 2, 2, 16, False, None, 0, 0),
    (2, 100, 100, 4, 2, 32, True, None, 0, 0),      # ragged edge, GQA
    (1, 130, 130, 4, 1, 64, True, 24, 0, 0),        # window, MQA
    (2, 96, 160, 8, 2, 128, True, 40, 64, 0),       # offsets, Tq != Tkv
    (1, 257, 257, 4, 4, 128, True, 1, 0, 0),        # window 1: diagonal
    (1, 33, 70, 2, 2, 64, True, None, 0, 20),       # rows with no key
]


def _close(got, want, what):
    tol = RTOL * max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_plain(cuda, case):
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, Tq, H, D, generator=g, device=cuda)
    k = torch.randn(B, Tkv, Hkv, D, generator=g, device=cuda)
    v = torch.randn(B, Tkv, Hkv, D, generator=g, device=cuda)
    do = torch.randn(B, Tq, H, D, generator=g, device=cuda)
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=window,
              q_offset=qo, kv_offset=ko)
    before = dict(flash.LAUNCHES)
    o, lse = flash.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_ref, "o")
    _close(lse, lse_ref, "lse")
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    _close(dq, flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw), "dq")
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    _close(dk, dk_ref, "dk")
    _close(dv, dv_ref, "dv")
    torch.cuda.synchronize()
    assert all(flash.LAUNCHES[n] == before[n] + 1 for n in before)
    assert torch.isfinite(o).all() and torch.isfinite(dq).all()


def test_autograd_matches_dense_oracle(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 200, h, 64, generator=g, device=cuda) * 0.5
               for h in (8, 2, 2))
    w = torch.randn(2, 200, 8, 64, generator=g, device=cuda)
    grads = []
    for fn in (flash.flash_attention_grad, reference_attention):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*xs, causal=True, window=50) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b, what in zip(*grads, "qkv"):
        _close(a, b, f"d{what}")


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        flash.flash_fwd(q.half(), q.half(), q.half(), scale=1.0,
                        causal=True)
    with pytest.raises(ValueError):
        flash.flash_fwd(q.transpose(1, 2), q, q, scale=1.0, causal=True)
    with pytest.raises(ValueError):
        qq = torch.randn(1, 8, 2, 24, device=cuda)
        flash.flash_fwd(qq, qq, qq, scale=1.0, causal=True)
