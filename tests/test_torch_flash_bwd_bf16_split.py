"""The bf16 flash backward's split arithmetic and route, on the CPU.

On bf16 q / k / v the two backward kernels (``ops/csrc/flash_bwd_dq_wgmma.cu``,
``flash_bwd_dkv_wgmma.cu``, the ``"wgmma_bf16"`` route, head dims 64 and
128, smaller ones zero-padded to 64) run their float32-operand products as bf16
tensor-core products of split operands: dO = dO_hi + dO_lo (the
``flash_bwd_split`` pre-pass), P = P_hi + P_lo in registers, and

    dP = dO_hi V^T + dO_lo V^T,
    dV = P_hi dO_hi + P_lo dO_hi + P_hi dO_lo.

The sources' notes bound what that misses: 2^-16 sum |dO| |V| for dP and
3 2^-16 sum P |dO| for dV.  This file holds the split, emulated in torch
(bf16 parts, products and sums in float64), to those bounds on
adversarial magnitudes, shows that the card's tighter dV gate (2^-12 max
|ref| on a float32 dO) tells the split from one with a term dropped, holds
the pre-pass's plain form bit for bit, and the Python around the kernels:
the route and the padded head dim by q / k / v's dtype, the dO operands each route's launcher takes (a float32 dO split, a
bf16 dO as it came with no lo part), the launchers' names and pointer
counts against the sources.  No JAX, no card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.ops import _build, flash

U = 2.0 ** -8  # bf16 rounds to nearest with 8 significant bits


def _adversarial(rng, shape):
    """float32 values over twelve decades, both signs, plus values a half
    bf16 ulp off a bf16 number (the ties and near-ties of the rounding)."""
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    x = x.astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size // 4
    base = torch.from_numpy(flat[:n].copy()).bfloat16().float().numpy()
    half = np.abs(base) * np.float32(2.0 ** -8)
    flat[:n] = base + half * rng.choice([-1.0, -0.999, 0.999, 1.0], n)
    return torch.from_numpy(x)


def _split64(x):
    hi, lo = flash.flash_bwd_split_plain(x)
    return hi.double(), lo.double()


@pytest.mark.parametrize("seed", range(4))
def test_dp_split_within_its_budget(seed):
    """dP = dO_hi V^T + dO_lo V^T misses at most 2^-16 sum |dO| |V| of
    each element (V is bf16-exact)."""
    rng = np.random.default_rng(seed)
    do = _adversarial(rng, (48, 128))
    v = torch.from_numpy(rng.standard_normal((40, 128)) *
                         10.0 ** rng.uniform(-3, 3, (40, 1))).bfloat16()
    hi, lo = _split64(do)
    vd = v.double()
    exact = do.double() @ vd.T
    split = hi @ vd.T + lo @ vd.T
    budget = U * U * (do.double().abs() @ vd.abs().T)
    assert ((split - exact).abs() <= budget).all()
    # One bf16 product alone is far outside it.
    assert ((hi @ vd.T - exact).abs() > budget).any()


@pytest.mark.parametrize("seed", range(4))
def test_dv_split_within_its_budget(seed):
    """dV = P_hi dO_hi + P_lo dO_hi + P_hi dO_lo misses at most
    3 2^-16 sum P |dO| (plus terms of 2^-24), P in [0, 1] as exp() gives
    it, from 1 down to the smallest normal floats."""
    rng = np.random.default_rng(100 + seed)
    p = torch.from_numpy(np.exp(-rng.exponential(8.0, (64, 96)))
                         .astype(np.float32))
    p[0, :8] = torch.tensor([1.0, 0.5, 0.999, 1e-30, 2.0 ** -126, 0.75,
                             1.0 - 2.0 ** -24, 3e-8])
    do = _adversarial(rng, (96, 128))
    ph, pl = _split64(p)
    dh, dl = _split64(do)
    exact = p.double() @ do.double()
    split = ph @ dh + pl @ dh + ph @ dl
    budget = 3 * U * U * (1 + 2 * U) * (p.double() @ do.double().abs())
    assert ((split - exact).abs() <= budget).all()
    assert ((ph @ dh - exact).abs() > budget).any()


# The card's gate on dV from a float32 dO (chip_smoke.py
# FLASH_BF16_DV_F32_RTOL, tests/test_torch_flash_bf16_kernels.py
# DV_F32_ULP): dV has no dS rounding, so only the split's own error lands
# in it.
DV_F32_GATE = 2.0 ** -12


@pytest.mark.parametrize("drop", ["none", "do_lo", "p_lo"])
def test_dv_gate_tells_the_split_from_a_dropped_term(drop):
    """dV = P^T dO at an attention-like shape (P a causal softmax, dO
    float32), the split emulated in float64: with every term it sits far
    inside 2^-12 max |ref|; with dO_lo or P_lo dropped (dO or P rounded to
    bf16, the precision the JAX semantics rule out) it lands outside."""
    rng = np.random.default_rng(11)
    T, D = 256, 128
    s = rng.standard_normal((T, T)) * 2.0
    s[np.triu_indices(T, 1)] = -np.inf
    p = np.exp(s - s.max(1, keepdims=True))
    p = torch.from_numpy((p / p.sum(1, keepdims=True)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    ph, pl = _split64(p)
    dh, dl = _split64(do)
    exact = p.double().T @ do.double()
    terms = {"ph_dh": ph.T @ dh, "pl_dh": pl.T @ dh, "ph_dl": ph.T @ dl}
    dropped = {"none": (), "do_lo": ("ph_dl",), "p_lo": ("pl_dh",)}[drop]
    dv = sum(t for n, t in terms.items() if n not in dropped)
    err = (dv - exact).abs().max() / exact.abs().max()
    if drop == "none":
        assert err <= DV_F32_GATE / 16
    else:
        assert err > 2 * DV_F32_GATE


def test_split_plain_form():
    """hi = bf16(dO) and lo = bf16(dO - hi), both rounded to nearest even
    as torch casts: hi + lo is dO to 2^-16 of |dO|, lo is 0 exactly where
    dO is bf16-exact, and flash_bwd_split on a CPU tensor is the plain
    form, counting no launch."""
    rng = np.random.default_rng(7)
    do = _adversarial(rng, (3, 17, 2, 64))
    hi, lo = flash.flash_bwd_split_plain(do)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, do.bfloat16())
    assert torch.equal(lo, (do - do.bfloat16().float()).bfloat16())
    rest = (do.double() - hi.double() - lo.double()).abs()
    assert (rest <= U * U * do.double().abs()).all()
    exact = do.bfloat16().float()
    assert not flash.flash_bwd_split_plain(exact)[1].any()
    before = dict(flash.LAUNCHES)
    got = flash.flash_bwd_split(do)
    assert all(torch.equal(a, b) for a, b in zip(got, (hi, lo)))
    assert flash.LAUNCHES == before


# (D, dtype, route): the backward's route by q / k / v's dtype, at every
# head dim.
ROUTE_CASES = [
    (8, torch.bfloat16, "wgmma_bf16"),
    (16, torch.bfloat16, "wgmma_bf16"),
    (24, torch.bfloat16, "wgmma_bf16"),
    (32, torch.bfloat16, "wgmma_bf16"),
    (33, torch.bfloat16, "wgmma_bf16"),
    (48, torch.bfloat16, "wgmma_bf16"),
    (64, torch.bfloat16, "wgmma_bf16"),
    (96, torch.bfloat16, "wgmma_bf16"),
    (128, torch.bfloat16, "wgmma_bf16"),
    (64, torch.float32, "tf32x3"),
    (128, torch.float32, "tf32x3"),
    (16, torch.float32, "tf32x3"),
]


@pytest.mark.parametrize("D,dtype,route", ROUTE_CASES, ids=str)
def test_bwd_route_by_head_dim_and_dtype(D, dtype, route):
    q = torch.zeros(1, 4, 2, D, dtype=dtype)
    k = torch.zeros(1, 4, 1, D, dtype=dtype)
    assert flash.bwd_route("flash_bwd_dq", q, k, k) == route
    # The forward keeps its dtype's route at every head dim.
    assert flash.route_of("flash_fwd", q, k, k) == \
        flash.ROUTE_DTYPES[dtype]


def test_bwd_route_refuses_what_no_kernel_takes():
    b = torch.zeros(1, 4, 1, 160, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash_bwd_dkv: head_dim 160 > "
                       r"128, the largest the kernels are built for \(\(64, "
                       r"128\)\)"):
        flash._bwd_operands("flash_bwd_dkv", b, b, b, b)
    with pytest.raises(TypeError, match="float16"):
        flash.bwd_route("flash_bwd_dq", *(b.half(),) * 3)


def _qkv(D, dtype, H=4, Hkv=2, T=8):
    g = torch.Generator().manual_seed(D)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    return mk(1, T, H, D), mk(1, T, Hkv, D), mk(1, T, Hkv, D)


@pytest.mark.parametrize("D,Dk", [(8, 64), (16, 64), (32, 64), (64, 64),
                                  (96, 128), (128, 128)])
def test_wgmma_route_splits_a_float32_do_once(D, Dk):
    """On wgmma_bf16 a float32 dO becomes (hi, lo, dO) zero-padded to the
    route's kernel head dim (64 or 128), hi and lo the split's plain form;
    a bf16 dO is read as it came, with no lo part."""
    q, k, v = _qkv(D, torch.bfloat16)
    do = _adversarial(np.random.default_rng(D), tuple(q.shape))
    route, d, qp, kp, vp, ops = flash._bwd_operands("flash_bwd_dq", q, k, v,
                                                    do)
    assert flash.kernel_head_dim(D, dims=flash.WGMMA_HEAD_DIMS) == Dk
    assert (route, d) == ("wgmma_bf16", D)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == Dk
    assert not (qp[..., D:].any() or kp[..., D:].any() or vp[..., D:].any())
    hi, lo, dof = ops
    assert dof.dtype == torch.float32 and dof.shape[-1] == Dk
    assert torch.equal(dof[..., :D], do) and not dof[..., D:].any()
    want = flash.flash_bwd_split_plain(dof)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    b = do.bfloat16()
    route, _, _, _, _, ops = flash._bwd_operands("flash_bwd_dkv", q, k, v, b)
    assert route == "wgmma_bf16" and ops[1:] == (None, None)
    assert ops[0].dtype == torch.bfloat16 and ops[0].shape[-1] == Dk
    assert torch.equal(ops[0][..., :D], b)


@pytest.mark.parametrize("D,Dk", [(24, 32), (16, 16), (128, 128)])
def test_other_routes_take_one_float32_do(D, Dk):
    """On "tf32x3" the launcher takes one float32 dO, padded to the next of
    KERNEL_HEAD_DIMS: a bf16 dO is upcast, as JAX upcasts it."""
    q, k, v = _qkv(D, torch.float32)
    do = torch.randn(q.shape).bfloat16()
    route, _, qp, _, _, ops = flash._bwd_operands("flash_bwd_dq", q, k, v,
                                                  do)
    assert route == "tf32x3" and qp.shape[-1] == Dk
    assert len(ops) == 1 and ops[0].dtype == torch.float32
    assert torch.equal(ops[0][..., :D], do.float())


@pytest.mark.parametrize("bf16_do", [False, True])
def test_wrappers_hand_the_launcher_its_operands(monkeypatch, bf16_do):
    """_bwd_dq / _bwd_dkv pass q, k, v, the route's dO operands, lse, D
    and the float32 outputs, on the route of their operands."""
    calls = []
    monkeypatch.setattr(flash, "_launch",
                        lambda name, ts, q, k, **kw: calls.append(
                            (name, ts, kw["route"])))
    q, k, v = _qkv(128, torch.bfloat16)
    do = torch.randn(q.shape)
    do = do.bfloat16() if bf16_do else do
    lse = torch.zeros(1, 4, 8)
    ops = flash._bwd_operands("flash_attention_bwd", q, k, v, do)
    kw = dict(scale=0.1, causal=True, window=None, q_offset=0, kv_offset=0)
    dq = flash._bwd_dq(ops, lse, lse, kw)
    dk, dv = flash._bwd_dkv(ops, lse, lse, kw)
    assert [c[0] for c in calls] == ["flash_bwd_dq", "flash_bwd_dkv"]
    assert all(c[2] == "wgmma_bf16" for c in calls)
    for (_, ts, _), outs in zip(calls, ((dq,), (dk, dv))):
        assert ts[:3] == (ops[2], ops[3], ops[4])
        assert ts[3:6] == ops[5] and ts[6:8] == (lse, lse)
        assert all(o.dtype == torch.float32 for o in ts[8:])
        assert len(ts) == 8 + len(outs)
    assert (ts[4] is None) == bf16_do and (ts[5] is None) == bf16_do


@pytest.mark.parametrize("Tq,Tkv", [(0, 8), (8, 0)])
def test_wgmma_route_with_no_rows_or_keys_launches_nothing(monkeypatch, Tq,
                                                          Tkv):
    """No q row or no key: zero gradients of the unpadded head dim, no
    launch (the kernels' TMA maps take no empty dimension)."""
    monkeypatch.setattr(flash, "_launch", lambda *a, **k: pytest.fail(
        "launched"))
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, Tq, 4, 96, generator=g).bfloat16()
    k = torch.randn(1, Tkv, 2, 96, generator=g).bfloat16()
    lse = torch.zeros(1, 4, Tq)
    ops = flash._bwd_operands("flash_attention_bwd", q, k, k,
                              torch.zeros(q.shape))
    kw = dict(scale=0.1, causal=False, window=None, q_offset=0, kv_offset=0)
    dq = flash._bwd_dq(ops, lse, lse, kw)
    dk, dv = flash._bwd_dkv(ops, lse, lse, kw)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert not (dq.any() or dk.any() or dv.any())


# (kernel, route, library, C launcher, pointers).
SYMBOLS = [
    ("flash_fwd", "tf32x3", "flash_fwd", "tm_flash_fwd", 5),
    ("flash_fwd", "bf16", "flash_fwd", "tm_flash_fwd_bf16", 5),
    ("flash_bwd_dq", "tf32x3", "flash_bwd_dq", "tm_flash_bwd_dq", 7),
    ("flash_bwd_dq", "wgmma_bf16", "flash_bwd_dq_wgmma",
     "tm_flash_bwd_dq_bf16", 9),
    ("flash_bwd_dkv", "tf32x3", "flash_bwd_dkv", "tm_flash_bwd_dkv", 8),
    ("flash_bwd_dkv", "wgmma_bf16", "flash_bwd_dkv_wgmma",
     "tm_flash_bwd_dkv_bf16", 10),
    ("flash_fwd_residual", "bf16", "flash_fwd_residual",
     "tm_flash_fwd_residual_bf16",
     6),
    ("flash_fwd_residual", "tf32x3", "flash_fwd_residual",
     "tm_flash_fwd_residual", 6),
]


@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_float32_backward_sources_hold_no_bf16_route(name):
    """The backward's f32 sources launch f32 alone: bf16 q / k / v take the
    wgmma sources, and no launcher of another route is left behind."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert re.findall(r'extern "C" int (\w+)\(', src) == [f"tm_{name}"]
    assert "bf16" not in src.split("#include")[1]


@pytest.mark.parametrize("name,route,lib,sym,n", SYMBOLS, ids=str)
def test_launchers_match_the_sources(name, route, lib, sym, n):
    """Each route's C launcher is declared in its library's source, with
    as many pointers as the wrapper passes before the scalars."""
    assert flash._symbol(name, route) == (lib, sym, n)
    lib = _build.SHARED_LIBRARY.get(lib, lib)
    assert lib in _build.KERNELS
    src = (_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + sym + r"\((.*?)\)\s*\{", src, re.S)
    assert m, f"{sym} not in {lib}.cu"
    params = [p for p in m.group(1).split(",") if "*" in p]
    assert len(params) == n + 1  # and the stream


def test_split_launcher_and_counters():
    assert _build.SHARED_LIBRARY["flash_bwd_split"] == "flash_bwd_dq_wgmma"
    src = Path(_build.CSRC / "flash_bwd_dq_wgmma.cu").read_text()
    assert 'extern "C" int tm_flash_bwd_split(const float* x, void* hi, ' \
           'void* lo, long n,' in src
    assert set(flash.LAUNCHES) == set(flash.KERNEL_ROUTES)
    assert set(flash.ROUTE_LAUNCHES["flash_bwd_split"]) == {"wgmma_bf16"}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert set(flash.ROUTE_LAUNCHES[name]) == {"tf32x3", "wgmma_bf16"}
    flash.ROUTE_LAUNCHES["flash_bwd_split"]["wgmma_bf16"] += 2
    flash.reset_launches()
    assert not any(c for r in flash.ROUTE_LAUNCHES.values()
                   for c in r.values())
