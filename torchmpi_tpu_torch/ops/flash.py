"""Flash attention on Hopper: the forward and both backward kernels.

The PyTorch counterpart of ``torchmpi_tpu/ops/flash.py``.  Three CUDA
kernels (``ops/csrc/flash_fwd.cu``, ``flash_bwd_dq.cu``,
``flash_bwd_dkv.cu``) replace the three Pallas TPU kernels
(``_flash_kernel`` :265, ``_flash_bwd_dq_kernel`` :358,
``_flash_bwd_dkv_kernel`` :424); on bf16 operands the two backward
kernels are ``flash_bwd_dq_wgmma.cu`` and ``flash_bwd_dkv_wgmma.cu`` (the
``"wgmma_bf16"`` route below), which read dO split into bf16 parts by a
pre-pass kernel, ``flash_bwd_split``.  The
forward has a second launcher, ``flash_fwd_residual``: ``_flash_kernel``'s
``residuals`` epilogue
(:337-356), the un-normalized numerator and the row statistics m and l
that each step of ring attention combines (``parallel/sequence.py``).
Each has a plain PyTorch version here, written out in dense torch ops with
the kernel's masking conventions.

Every kernel wrapper takes its plain version when, and only when, the
tensors it was given lie on the CPU; on a CUDA tensor it launches the
kernel or raises.  Each launch adds one to ``LAUNCHES[name]`` and to
``ROUTE_LAUNCHES[name][route]``.

Layouts are the JAX package's: q ``[B, Tq, H, D]``, k / v
``[B, Tkv, Hkv, D]`` with ``Hkv`` dividing ``H`` (GQA: q head ``h`` reads kv
head ``h // (H // Hkv)``, the ``jnp.repeat`` layout), lse ``[B, H, Tq]``.
The kernels take contiguous tensors whose q / k / v (and dO) start 16-byte
aligned (they copy rows in 16-byte pieces), on one of two routes chosen by
q / k / v's dtype (all three the same): ``"tf32x3"`` for float32 (every
product TF32 in the three-product form; the model casts q / k / v to
float32 before attention, ``models/transformer.py``, as the JAX model
does) and, for bfloat16, ``"bf16"`` in the forward and ``"wgmma_bf16"``
in the backward (``bwd_route``).  On both the products with two bf16
operands run in bf16 on the tensor cores, P and dS rounded to bf16
before them where the JAX kernels round them
(``torchmpi_tpu/ops/flash.py:321``, :407, :478); ``"wgmma_bf16"`` runs
wgmma on TMA tiles, its products with a float32 operand (dO V^T, P^T dO)
as sums of bf16 products of split operands.  lse and D are float32 on
every route; dO is float32 or bf16 (JAX upcasts dO to float32, :667, and
a bf16 dO is exact there: ``"tf32x3"`` upcasts it, ``"wgmma_bf16"`` reads
it as it is and skips its zero lo part).  o is in q's dtype, the residual
form's num, m and l
and the gradients float32, as in JAX.  Any other dtype, or mixed q / k /
v, raises on the card.  The plain versions take any floating dtype and
round P and dS to v's, k's and q's dtype where the kernels do.  They are
built for head dims 16, 32, 64 and 128 (``"wgmma_bf16"`` for 64 and 128);
the wrappers take any D up to 128 by zero-padding q / k / v / dO to the
next of their route's (the scale is an
argument, taken from the true D, so the zero columns add nothing to
q . k, and v's give output columns that are sliced off).  A larger D
raises: it needs tiles of its own.
Masked scores are the finite ``NEG_INF``; a row with no valid key yields
output 0 and lse ``+1e30``, never NaN.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import runtime
from ..parallel.sequence import causal_window_mask
from . import _build

# Finite stand-in for -inf in masked scores: exp() of it is exactly 0 and
# the running-max rescale never computes (-inf) - (-inf).
NEG_INF = -1e30

# The route of each launch, by q / k / v's dtype; the backward's bf16
# route is WGMMA_ROUTE (bwd_route).
ROUTES = ("tf32x3", "bf16")
ROUTE_DTYPES = {torch.float32: "tf32x3", torch.bfloat16: "bf16"}
WGMMA_ROUTE = "wgmma_bf16"
# Each wrapper's routes; flash_bwd_split (the dO split that the backward's
# wgmma_bf16 route reads) runs only on that route.
KERNEL_ROUTES = {
    "flash_fwd": ROUTES,
    "flash_bwd_dq": ("tf32x3", WGMMA_ROUTE),
    "flash_bwd_dkv": ("tf32x3", WGMMA_ROUTE),
    "flash_fwd_residual": ROUTES,
    "flash_bwd_split": (WGMMA_ROUTE,),
}
# Kernel launches per wrapper since the last reset_launches(): a run can
# show that its path went through the kernels.
LAUNCHES = {name: 0 for name in KERNEL_ROUTES}
ROUTE_LAUNCHES = {name: {r: 0 for r in routes}
                  for name, routes in KERNEL_ROUTES.items()}

# Head dims the kernels are instantiated for (flash_*.cu, the D switch;
# flash_bwd_*_wgmma.cu, those of the wgmma_bf16 route); any other D up to
# the largest runs zero-padded to the next of its route's.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTE_LAUNCHES.values():
        for r in counts:
            counts[r] = 0


def _gqa_group(h: int, h_kv: int) -> int:
    """Query heads per kv head (grouped-query attention); 1 is MHA."""
    if h_kv == h:
        return 1
    if h_kv < 1 or h % h_kv != 0:
        raise ValueError(f"num q heads {h} must be a multiple of kv "
                         f"heads {h_kv}")
    return h // h_kv


def _check_window(window: Optional[int], causal: bool) -> None:
    """A sliding window counts the query itself plus the ``window - 1``
    keys before it, so it is defined only over causal order."""
    if window is None:
        return
    if not causal:
        raise ValueError("window= requires causal=True (a sliding window "
                         "is defined over causal order)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q' = q * scale in q's dtype (``Config.flash_prescale``)."""
    return (q.float() * scale).to(q.dtype)


def lse_from_residuals(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp per row from the running max ``m`` and denominator
    ``l``; rows with no valid key (l == 0) get +1e30, so the backward's
    ``exp(s - lse)`` is 0 there."""
    return torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)),
                       torch.full_like(m, -NEG_INF))


def _check_shapes(q, k, v, causal, window, q_offset, kv_offset) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected [B, T, H, D] tensors, got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)}")
    B, _, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Tkv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if not (isinstance(q_offset, int) and isinstance(kv_offset, int)):
        raise TypeError("q_offset / kv_offset must be Python ints")
    _check_window(window, causal)
    _gqa_group(H, Hkv)


def _check_bwd_shapes(q, do, lse, dvec) -> None:
    B, Tq, H, _ = q.shape
    if do.shape != q.shape or tuple(lse.shape) != (B, H, Tq) or \
            dvec.shape != lse.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} do "
                         f"{tuple(do.shape)} lse {tuple(lse.shape)} dvec "
                         f"{tuple(dvec.shape)}")


def _repeat_kv(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """k or v with each kv head repeated over its GQA group (float32)."""
    group = _gqa_group(num_heads, t.shape[2])
    t = t.float()
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` rounded to ``dtype`` and back (the identity for
    float32): P before P V, dS before dS K and dS^T Q, as the JAX kernels
    round them to the operand's dtype."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _masked_scores(q, kr, scale, causal, window, q_offset, kv_offset):
    """Dense [B, H, Tq, Tkv] scaled scores, NEG_INF where masked (the
    kernels' ``tmf::valid``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale
    if not causal:
        return s
    keep = causal_window_mask(
        q_offset + torch.arange(q.shape[1], device=q.device),
        kv_offset + torch.arange(kr.shape[1], device=q.device), window)
    return s.masked_fill(~keep, NEG_INF)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------


def flash_fwd_residual_plain(q, k, v, *, scale: float, causal: bool,
                             window: Optional[int] = None, q_offset: int = 0,
                             kv_offset: int = 0):
    """(num [B, Tq, H, D], m [B, H, Tq], l [B, H, Tq]) of the residual
    kernel, in dense float32 ops: the un-normalized numerator, the row max
    of the masked scores and the row denominator, l summed from the float32
    P and num from P rounded to v's dtype (JAX :321).  A row with no valid
    key has m = NEG_INF, l = 0 and num = 0."""
    H = q.shape[2]
    s = _masked_scores(q.float(), _repeat_kv(k, H), scale, causal, window,
                       q_offset, kv_offset)
    m = s.amax(dim=-1)                                   # [B, H, Tq]
    m_safe = torch.where(m > 0.5 * NEG_INF, m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bhqk,bkhd->bqhd", _round_to(p, v.dtype),
                       _repeat_kv(v, H))
    return num, m, l


def flash_fwd_plain(q, k, v, *, scale: float, causal: bool,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_offset: int = 0):
    """(o, lse) of the forward kernel, in dense float32 ops: the residual
    form's numerator divided by l (rows with l = 0 read 0), o in q's
    dtype."""
    num, m, l = flash_fwd_residual_plain(
        q, k, v, scale=scale, causal=causal, window=window,
        q_offset=q_offset, kv_offset=kv_offset)
    denom = torch.where(l > 0, l, torch.ones_like(l))
    o = num / denom.transpose(1, 2)[..., None]
    return o.to(q.dtype), lse_from_residuals(m, l)


def _bwd_plain_terms(q, k, v, do, lse, dvec, scale, causal, window,
                     q_offset, kv_offset):
    """p, ds = p * (dO . v - D) and the group-repeated k of the backward,
    dense, float32."""
    H = q.shape[2]
    kr = _repeat_kv(k, H)
    s = _masked_scores(q.float(), kr, scale, causal, window, q_offset,
                       kv_offset)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _repeat_kv(v, H))
    return p, p * (dp - dvec[..., None]), kr


def flash_bwd_dq_plain(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                       window: Optional[int] = None, q_offset: int = 0,
                       kv_offset: int = 0):
    """dq of the dQ kernel, in dense float32 ops, dS rounded to k's dtype
    (JAX :407)."""
    _, ds, kr = _bwd_plain_terms(q, k, v, do, lse, dvec, scale, causal,
                                 window, q_offset, kv_offset)
    return scale * torch.einsum("bhqk,bkhd->bqhd", _round_to(ds, k.dtype), kr)


def flash_bwd_split_plain(do):
    """(hi, lo) of the split kernel: hi = bf16(dO), lo = bf16(dO - hi),
    both rounded to nearest even (hi + lo is dO to 2^-16 of |dO|)."""
    hi = do.to(torch.bfloat16)
    return hi, (do - hi.float()).to(torch.bfloat16)


def flash_bwd_dkv_plain(q, k, v, do, lse, dvec, *, scale: float,
                        causal: bool, window: Optional[int] = None,
                        q_offset: int = 0, kv_offset: int = 0):
    """(dk, dv) of the dK/dV kernel, in dense float32 ops: per-q-head
    terms summed over each kv head's group; dS rounded to q's dtype (JAX
    :478), P not rounded (dO is float32: JAX :471)."""
    p, ds, _ = _bwd_plain_terms(q, k, v, do, lse, dvec, scale, causal,
                                window, q_offset, kv_offset)
    B, Tkv, Hkv, D = k.shape
    group = q.shape[2] // Hkv
    dv = torch.einsum("bhqk,bqhd->bkhd", _round_to(p, do.dtype), do.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", _round_to(ds, q.dtype),
                              q.float())
    return (dk.reshape(B, Tkv, Hkv, group, D).sum(dim=3),
            dv.reshape(B, Tkv, Hkv, group, D).sum(dim=3))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C launcher and pointer count of each kernel; after the pointers every
# launcher takes B, Tq, Tkv, H, Hkv, D, scale, causal, window, q_offset,
# kv_offset and the stream.
_SIGNATURES = {
    "flash_fwd": ("tm_flash_fwd", 5),
    "flash_bwd_dq": ("tm_flash_bwd_dq", 7),
    "flash_bwd_dkv": ("tm_flash_bwd_dkv", 8),
    "flash_fwd_residual": ("tm_flash_fwd_residual", 6),
}
_SCALARS = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]


def _symbol(name: str, route: str):
    """(library, C launcher, pointer count) of kernel ``name`` on
    ``route``.  The bf16 route's launcher carries a _bf16 suffix in the
    same library; the wgmma_bf16 route's is ``<name>_wgmma``'s _bf16
    launcher, which takes dO as three pointers (its bf16 hi part, its lo
    part and the float32 dO, both null for a bf16 dO) where the others
    take one."""
    sym, n = _SIGNATURES[name]
    if route == "tf32x3":
        return name, sym, n
    if route == "bf16":
        return name, sym + "_bf16", n
    return f"{name}_wgmma", sym + "_bf16", n + 2


def route_of(name: str, q, k, v) -> str:
    """The kernel route of q / k / v's dtype: ``"tf32x3"`` (float32) or
    ``"bf16"``; any other dtype, or q / k / v of different dtypes, raises
    by name."""
    dtypes = {q.dtype, k.dtype, v.dtype}
    route = ROUTE_DTYPES.get(q.dtype) if len(dtypes) == 1 else None
    if route is None:
        raise TypeError(f"{name}: the kernels take float32 or bfloat16 q / "
                        f"k / v of one dtype, got {q.dtype} / {k.dtype} / "
                        f"{v.dtype}")
    return route


def bwd_route(name: str, q, k, v) -> str:
    """The backward kernels' route: :func:`route_of`'s, with bf16 q / k / v
    on ``"wgmma_bf16"``."""
    route = route_of(name, q, k, v)
    return WGMMA_ROUTE if route == "bf16" else route


def _launch(name: str, tensors, q, k, scale, causal, window, q_offset,
            kv_offset, route: Optional[str] = None) -> None:
    """Launch kernel ``name`` on ``tensors`` (q, k, v, the other inputs,
    then the outputs) on ``route`` (by default q / k / v's), on the current
    stream of q's device; raise on a refused launch.  Every tensor after
    q / k / v is float32 but the bf16 forward's o and, on the wgmma_bf16
    route, dO's bf16 parts (operands 3 and 4; None stands for a null
    pointer)."""
    dev = q.device
    route = route or route_of(name, *tensors[:3])
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
        want = q.dtype if i < 3 or (name == "flash_fwd" and i == 3) else \
            torch.bfloat16 if route == WGMMA_ROUTE and i in (3, 4) else \
            torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: the {route} route takes {want} "
                            f"operand {i}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    B, Tq, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    lib, sym, n_ptrs = _symbol(name, route)
    with torch.cuda.device(dev):
        _build.launch(lib, sym, [_P] * n_ptrs + _SCALARS,
                      *[None if t is None else t.data_ptr()
                        for t in tensors], B, Tq, Tkv, H, Hkv,
                      D, float(scale), int(causal), window or 0, q_offset,
                      kv_offset, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[name][route] += 1


def _check_aligned(name: str, tensors) -> None:
    """The kernels copy q / k / v / do rows in 16-byte pieces (cp.async):
    a tensor that starts elsewhere is refused, not read misaligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        names = ", ".join(("q", "k", "v", "do")[:len(tensors)])
        raise ValueError(f"{name}: the kernel takes {names} 16-byte aligned")


def kernel_head_dim(D: int, name: str = "flash",
                    dims=KERNEL_HEAD_DIMS) -> int:
    """The head dim the kernels run ``D`` at: the least of ``dims`` (the
    route's: KERNEL_HEAD_DIMS, or WGMMA_HEAD_DIMS) that holds it.  Raises
    for a larger D, which needs tiles of its own (ROADMAP queue B,
    variant 4)."""
    for d in dims:
        if D <= d:
            return d
    raise ValueError(f"{name}: head_dim {D} > {dims[-1]}, the largest the "
                     f"kernels are built for ({dims}); a larger head dim "
                     f"needs its own tiling")


def pad_head_dim(name: str, *ts: torch.Tensor, dims=KERNEL_HEAD_DIMS):
    """``ts`` (q, k, v, dO) with the last dim zero-padded to
    :func:`kernel_head_dim` of it in ``dims``, each a new contiguous
    tensor, or the tensors themselves when D is one of ``dims``."""
    D = ts[0].shape[-1]
    Dk = kernel_head_dim(D, name, dims)
    if Dk == D:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, Dk - D)) for t in ts)


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    """An output of the padded kernels cut back to head dim ``D``."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def flash_fwd(q, k, v, *, scale: float, causal: bool,
              window: Optional[int] = None, q_offset: int = 0,
              kv_offset: int = 0):
    """(o [B, Tq, H, D] in q's dtype, lse [B, H, Tq]) — the ``flash_fwd``
    kernel on CUDA tensors, its plain version on CPU tensors."""
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        return flash_fwd_plain(q, k, v, **kw)
    B, Tq, H, D = q.shape
    q, k, v = pad_head_dim("flash_fwd", q, k, v)
    _check_aligned("flash_fwd", (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("flash_fwd", (q, k, v, o, lse), q, k, **kw)
    return _unpad(o, D), lse


def flash_fwd_residual(q, k, v, *, scale: float, causal: bool,
                       window: Optional[int] = None, q_offset: int = 0,
                       kv_offset: int = 0):
    """(num [B, Tq, H, D], m [B, H, Tq], l [B, H, Tq]), all float32 — the
    ``flash_fwd_residual`` kernel on CUDA tensors, its plain version on CPU
    tensors."""
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        return flash_fwd_residual_plain(q, k, v, **kw)
    B, Tq, H, D = q.shape
    q, k, v = pad_head_dim("flash_fwd_residual", q, k, v)
    _check_aligned("flash_fwd_residual", (q, k, v))
    num = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.numel():
        _launch("flash_fwd_residual", (q, k, v, num, m, l), q, k, **kw)
    return _unpad(num, D), m, l


def flash_bwd_split(do):
    """(hi, lo) [dO's shape], bfloat16: hi = bf16(dO), lo = bf16(dO - hi)
    — the ``flash_bwd_split`` kernel on a CUDA tensor (float32,
    contiguous, 16-byte aligned), its plain version on a CPU tensor."""
    if _device_kind(do) == "cpu":
        return flash_bwd_split_plain(do)
    if do.dtype != torch.float32 or not do.is_contiguous() or \
            do.data_ptr() % 16:
        raise ValueError("flash_bwd_split: the kernel takes a contiguous, "
                         "16-byte aligned float32 dO")
    hi = torch.empty(do.shape, dtype=torch.bfloat16, device=do.device)
    lo = torch.empty_like(hi)
    if do.numel():
        with torch.cuda.device(do.device):
            _build.launch("flash_bwd_split", "tm_flash_bwd_split",
                          [_P, _P, _P, ctypes.c_long, _P], do.data_ptr(),
                          hi.data_ptr(), lo.data_ptr(), do.numel(),
                          torch.cuda.current_stream(do.device).cuda_stream)
        LAUNCHES["flash_bwd_split"] += 1
        ROUTE_LAUNCHES["flash_bwd_split"][WGMMA_ROUTE] += 1
    return hi, lo


def _bwd_operands(name: str, q, k, v, do):
    """The backward kernels' operands on the card, made once for both:
    (route, D, q, k, v, dO) with q / k / v / dO zero-padded to the route's
    kernel head dim and dO as the route's launcher takes it, a tuple:
    (float32 dO,) on "tf32x3" (a bf16 dO upcast there, as JAX upcasts
    it); on "wgmma_bf16" (hi, lo, float32 dO) from flash_bwd_split, or a
    bf16 dO as it came with no lo part, (dO, None, None)."""
    D = q.shape[-1]
    route = bwd_route(name, q, k, v)
    if route != WGMMA_ROUTE or do.dtype != torch.bfloat16:
        do = do.float()
    q, k, v, do = pad_head_dim(
        name, q, k, v, do,
        dims=WGMMA_HEAD_DIMS if route == WGMMA_ROUTE else KERNEL_HEAD_DIMS)
    _check_aligned(name, (q, k, v, do))
    if route != WGMMA_ROUTE:
        return route, D, q, k, v, (do,)
    if do.dtype == torch.bfloat16:
        return route, D, q, k, v, (do, None, None)
    return route, D, q, k, v, (*flash_bwd_split(do), do)


def _no_keys_or_rows(route, q, k) -> bool:
    """No q row or no key on the wgmma_bf16 route: every gradient is 0,
    and no launch (its TMA maps take no empty dimension)."""
    return route == WGMMA_ROUTE and not (q.numel() and k.numel())


def _bwd_dq(ops, lse, dvec, kw):
    route, D, q, k, v, do = ops
    if _no_keys_or_rows(route, q, k):
        return torch.zeros(q.shape[:-1] + (D,), dtype=torch.float32,
                           device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("flash_bwd_dq", (q, k, v, *do, lse, dvec, dq), q, k,
                route=route, **kw)
    return _unpad(dq, D)


def _bwd_dkv(ops, lse, dvec, kw):
    route, D, q, k, v, do = ops
    if _no_keys_or_rows(route, q, k):
        dk = torch.zeros(k.shape[:-1] + (D,), dtype=torch.float32,
                         device=k.device)
        return dk, dk.clone()
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    if k.numel():
        _launch("flash_bwd_dkv", (q, k, v, *do, lse, dvec, dk, dv), q, k,
                route=route, **kw)
    return _unpad(dk, D), _unpad(dv, D)


def flash_bwd_dq(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                 window: Optional[int] = None, q_offset: int = 0,
                 kv_offset: int = 0):
    """dq [B, Tq, H, D], float32 — the ``flash_bwd_dq`` kernel on CUDA
    tensors (on its wgmma_bf16 route after splitting a float32 dO), its
    plain version on CPU tensors."""
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    _check_bwd_shapes(q, do, lse, dvec)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw)
    return _bwd_dq(_bwd_operands("flash_bwd_dq", q, k, v, do), lse, dvec,
                   kw)


def flash_bwd_dkv(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                  window: Optional[int] = None, q_offset: int = 0,
                  kv_offset: int = 0):
    """(dk, dv) [B, Tkv, Hkv, D], float32, summed over each GQA group —
    the ``flash_bwd_dkv`` kernel on CUDA tensors (on its wgmma_bf16 route
    after splitting a float32 dO), its plain version on CPU tensors."""
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    _check_bwd_shapes(q, do, lse, dvec)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    return _bwd_dkv(_bwd_operands("flash_bwd_dkv", q, k, v, do), lse, dvec,
                    kw)


# ---------------------------------------------------------------------------
# Public entry points (the JAX package's signatures)
# ---------------------------------------------------------------------------


def _prescale_enabled() -> bool:
    return bool(runtime.effective_config().flash_prescale)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_offset: int = 0, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None,
                    return_residuals: bool = False):
    """Flash attention forward on one device: [B, Tq, H, D] in q's dtype.

    ``window`` (causal only) keeps each query's own key and the
    ``window - 1`` before it; blocks outside the band are skipped, so the
    cost is O(T * window).  With ``Config.flash_prescale`` the scale is
    folded into q once.  ``block_q`` / ``block_k`` (the TPU tiling) are
    accepted for the JAX signature and ignored: the Hopper kernels' tiles
    are fixed in their sources.

    ``return_residuals=True`` returns ``(num, m, l)`` instead (JAX
    :496-627): the un-normalized numerator [B, Tq, H, D] and the row max
    and denominator [B, H, Tq], all float32, ``NEG_INF`` / 0 / 0 on rows
    with no valid key: the contract of ring attention's combiner.  That
    path never prescales (JAX :542-550): its callers run the backward at
    the original scale.  ``q_offset`` / ``kv_offset`` are Python ints, so
    a ring step reads no offset from the device."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if return_residuals:
        return flash_fwd_residual(q, k, v, scale=scale, causal=causal,
                                  window=window, q_offset=q_offset,
                                  kv_offset=kv_offset)
    if scale != 1.0 and _prescale_enabled():
        q, scale = _prescale_q(q, scale), 1.0
    o, _ = flash_fwd(q, k, v, scale=scale, causal=causal, window=window,
                     q_offset=q_offset, kv_offset=kv_offset)
    return o.to(q.dtype)


def flash_attention_bwd(q, k, v, do, lse, dvec, *, causal: bool,
                        scale: float, q_offset: int = 0, kv_offset: int = 0,
                        block_q: int = 128, block_k: int = 128,
                        window: Optional[int] = None):
    """Gradients (dq, dk, dv) in float32, probabilities recomputed from
    ``lse``; ``dvec[b, h, i] = dO_i . O_i`` comes from the caller.  Runs
    the dQ kernel, then the dK/dV kernel, on operands made once for both
    (on the wgmma_bf16 route a float32 dO is split once; a bf16 dO is
    read as it came).  ``block_q`` / ``block_k`` are ignored, as in
    :func:`flash_attention`."""
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        do = do.float()
        return (flash_bwd_dq(q, k, v, do, lse, dvec, **kw),
                *flash_bwd_dkv(q, k, v, do, lse, dvec, **kw))
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    _check_bwd_shapes(q, do, lse, dvec)
    ops = _bwd_operands("flash_attention_bwd", q, k, v, do.contiguous())
    return (_bwd_dq(ops, lse, dvec, kw), *_bwd_dkv(ops, lse, dvec, kw))


class _FlashAttentionFn(torch.autograd.Function):
    """The JAX package's ``_flash_vjp`` (:768-849): the forward saves the
    kernel-side q (prescaled when ``prescale``), o and lse; the backward
    forms ``dvec = rowsum(dO * O)`` in plain torch, runs the two backward
    kernels, and puts the scale back on dq when q was prescaled."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, q_offset, kv_offset,
                prescale):
        kscale = 1.0 if prescale else scale
        if prescale:
            q = _prescale_q(q, scale)
        o, lse = flash_fwd(q, k, v, scale=kscale, causal=causal,
                           window=window, q_offset=q_offset,
                           kv_offset=kv_offset)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, kscale, window, q_offset, kv_offset,
                    prescale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, kscale, window, qo, ko, prescale = ctx.args
        dvec = torch.einsum("bqhd,bqhd->bhq", do.float(),
                            o.float()).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, dvec,
                                         causal=causal, scale=kscale,
                                         q_offset=qo, kv_offset=ko,
                                         window=window)
        if prescale:
            dq = dq * scale  # chain rule through q' = scale * q
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def flash_attention_grad(q, k, v, *, causal: bool = False,
                         scale: Optional[float] = None, q_offset: int = 0,
                         kv_offset: int = 0, block_q: Optional[int] = None,
                         block_k: Optional[int] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention: the forward of
    :func:`flash_attention`, gradients to q / k / v through the two
    backward kernels.  ``TransformerLM(attn_impl="flash")`` routes here.
    ``block_q`` / ``block_k`` are ignored, as in :func:`flash_attention`."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    prescale = scale != 1.0 and _prescale_enabled()
    return _FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, float(scale),
                                   window, q_offset, kv_offset, prescale)
