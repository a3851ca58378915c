"""The flash kernels' bf16 route against their plain versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_flash_bf16_kernels.py -q

Tolerance: max |kernel - plain| <= 2^-7 max |plain| (one bf16 ulp of the
largest element: the kernel rounds P against each kv block's running max,
the plain version against the row's final max), and a second call gives
the same bits.  dv, which rounds no dS, is held to 2^-12 max |plain|
besides: the split keeps P^T dO to float32's order (a few 1e-6 on the
card), and dropping one of its terms (dO or P rounded to bf16) costs
2^-9 or more (tests/test_torch_flash_bwd_bf16_split.py).  The plain versions' parity with the JAX package is
tests/test_torch_flash_bf16.py.

Each case checks which design ran, by the route counters: the forward on
"bf16" (mma.sync), the backward on "wgmma_bf16" (wgmma on TMA tiles, the
float32-operand products as bf16 splits of dO and P; head dims 16 and 32
zero-padded to 64); the dO split (flash_bwd_split) once per backward
wrapper call on a float32 dO, never on a bf16 one.
"""

import pytest
import torch

from torchmpi_tpu_torch.ops import flash

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

ULP = 2.0 ** -7
DV_F32_ULP = 2.0 ** -12


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
    (1, 33, 70, 2, 2, 64, True, None, 0, 20),       # rows with no key
    (1, 45, 77, 8, 1, 16, False, None, 0, 0),
    (1, 300, 300, 16, 4, 128, True, 100, 0, 0),
    (1, 257, 257, 4, 4, 128, True, 1, 0, 0),        # window 1: dK pure rounding
    (1, 200, 200, 8, 2, 64, True, 64, 0, 0),        # GQA 4
    (2, 140, 140, 4, 1, 128, True, None, 0, 0),     # MQA
]
IDS = [f"B{c[0]}-Tq{c[1]}-Tkv{c[2]}-H{c[3]}/{c[4]}-D{c[5]}"
       f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
       for c in CASES]


def _routes(name):
    """The route counters of one launch of ``name``."""
    want = dict.fromkeys(flash.ROUTE_LAUNCHES[name], 0)
    want["bf16" if name.startswith("flash_fwd") else "wgmma_bf16"] = 1
    return want


def _close(got, want, what, ulp=ULP):
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    err = float((got.float() - want.float()).abs().max())
    bound = ulp * float(want.float().abs().max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _inputs(dev, B, Tq, Tkv, H, Hkv, D):
    g = torch.Generator(device=dev).manual_seed(B * 1000 + Tq + D)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q = mk(B, Tq, H, D).bfloat16()
    k = mk(B, Tkv, Hkv, D).bfloat16()
    v = mk(B, Tkv, Hkv, D).bfloat16()
    do = mk(B, Tq, H, D)
    return q, k, v, do


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_kernels_match_plain(cuda, case):
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko = case
    q, k, v, do = _inputs(cuda, B, Tq, Tkv, H, Hkv, D)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, q_offset=qo,
              kv_offset=ko)
    flash.reset_launches()
    o, lse = flash.flash_fwd(q, k, v, **kw)
    num, m, l = flash.flash_fwd_residual(q, k, v, **kw)
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o.float()).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_fwd_residual", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        assert flash.ROUTE_LAUNCHES[name] == _routes(name), name
    assert flash.LAUNCHES["flash_bwd_split"] == 2
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_ref, "o")
    _close(lse, lse_ref, "lse")
    for got, want, name in zip((num, m, l),
                               flash.flash_fwd_residual_plain(q, k, v, **kw),
                               ("num", "m", "l")):
        _close(got, want, name)
    _close(dq, flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw), "dq")
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    _close(dk, dk_ref, "dk")
    _close(dv, dv_ref, "dv", DV_F32_ULP)
    # Deterministic: a second call gives the same bits.
    assert torch.equal(o, flash.flash_fwd(q, k, v, **kw)[0])
    assert torch.equal(dq, flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw))
    dk2, dv2 = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_bf16_grad_launches_bf16_route(cuda):
    """flash_attention_grad on bf16 runs the bf16 route forward and the
    wgmma_bf16 route back (head dim 64), its outputs in bf16."""
    q, k, v, do = _inputs(cuda, 2, 128, 128, 8, 2, 64)
    flash.reset_launches()
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash.flash_attention_grad(*xs, causal=True, window=48)
    o.backward(do.bfloat16())
    assert o.dtype == torch.bfloat16
    assert flash.ROUTE_LAUNCHES["flash_fwd"]["bf16"] == 1
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert flash.ROUTE_LAUNCHES[name]["wgmma_bf16"] == 1, name
    assert all(x.grad.dtype == torch.bfloat16 for x in xs)


def _decades(dev, shape, seed):
    """A float32 dO over six decades, not bf16-exact."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev)
    return x * 10.0 ** (6 * torch.rand(*shape, generator=g, device=dev) - 3)


# (B, T, H, Hkv, D, window): both new head dims, GQA 4 and MQA.
DO_CASES = [(1, 192, 8, 2, 128, 96), (2, 130, 4, 1, 64, None),
            (1, 160, 4, 1, 128, 40), (1, 100, 8, 2, 64, 1)]


@pytest.mark.parametrize("case", DO_CASES, ids=str)
def test_float32_do_and_its_bf16_twin(cuda, case):
    """A float32 dO over six decades through flash_attention_bwd: one dO
    split for both kernels, all split products; the same dO rounded to
    bf16 through flash_attention_grad: no split, its lo products skipped
    (the gradients as flash_attention_bwd gives them on that bf16 dO, bit
    for bit).  Each against the plain versions within 2^-7 max |plain|,
    and dv within 2^-12 max |plain| on both dO kinds."""
    B, T, H, Hkv, D, window = case
    q, k, v, _ = _inputs(cuda, B, T, T, H, Hkv, D)
    do = _decades(cuda, (B, T, H, D), D + T)
    kw = dict(scale=D ** -0.5, causal=True, window=window)
    o, lse = flash.flash_fwd(q, k, v, **kw)
    for d_o in (do, do.bfloat16()):
        dvec = torch.einsum("bqhd,bqhd->bhq", d_o.float(),
                            o.float()).contiguous()
        flash.reset_launches()
        dq, dk, dv = flash.flash_attention_bwd(q, k, v, d_o, lse, dvec,
                                               causal=True, window=window,
                                               scale=kw["scale"])
        torch.cuda.synchronize()
        assert flash.LAUNCHES["flash_bwd_split"] == \
            (1 if d_o.dtype == torch.float32 else 0)
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert flash.ROUTE_LAUNCHES[name] == _routes(name), name
        # The plain versions take dO in float32, as JAX does (:667).
        _close(dq, flash.flash_bwd_dq_plain(q, k, v, d_o.float(), lse, dvec,
                                            **kw), "dq")
        dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, d_o.float(), lse,
                                                   dvec, **kw)
        _close(dk, dk_ref, "dk")
        _close(dv, dv_ref, "dv", DV_F32_ULP)
    # The bf16 twin through autograd: the same launches, the same bits.
    flash.reset_launches()
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    flash.flash_attention_grad(*xs, **kw).backward(do.bfloat16())
    torch.cuda.synchronize()
    assert flash.LAUNCHES["flash_bwd_split"] == 0
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert flash.ROUTE_LAUNCHES[name]["wgmma_bf16"] == 1, name
    for x, want in zip(xs, (dq, dk, dv)):
        assert torch.equal(x.grad, want.to(torch.bfloat16))


def test_other_dtypes_raise(cuda):
    q, k, v, do = _inputs(cuda, 1, 64, 64, 2, 2, 16)
    kw = dict(scale=0.25, causal=True)
    with pytest.raises(TypeError, match="float16"):
        flash.flash_fwd(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(TypeError, match="bfloat16 / torch.bfloat16 / "
                       "torch.float32"):
        flash.flash_fwd(q, k, v.float(), **kw)
