"""Flash attention on Hopper: the forward and both backward kernels.

The PyTorch counterpart of ``torchmpi_tpu/ops/flash.py``.  Three CUDA
kernels (``ops/csrc/flash_fwd.cu``, ``flash_bwd_dq.cu``,
``flash_bwd_dkv.cu``) replace the three Pallas TPU kernels
(``_flash_kernel`` :265, ``_flash_bwd_dq_kernel`` :358,
``_flash_bwd_dkv_kernel`` :424).  Each has a plain PyTorch version here,
written out in dense torch ops with the kernel's masking conventions.

Every kernel wrapper takes its plain version when, and only when, the
tensors it was given lie on the CPU; on a CUDA tensor it launches the
kernel or raises.  Each launch adds one to ``LAUNCHES[name]``.

Layouts are the JAX package's: q ``[B, Tq, H, D]``, k / v
``[B, Tkv, Hkv, D]`` with ``Hkv`` dividing ``H`` (GQA: q head ``h`` reads kv
head ``h // (H // Hkv)``, the ``jnp.repeat`` layout), lse ``[B, H, Tq]``.
The kernels take float32, contiguous tensors whose q / k / v (and dO)
start 16-byte aligned (they copy rows in 16-byte pieces): the model casts
q / k / v to float32 before attention (``models/transformer.py``), as the
JAX model does.  They are built for head dims 16, 32, 64 and 128; the
wrappers take any D up to 128 by zero-padding q / k / v / dO to the next
of those (the scale is an argument, taken from the true D, so the zero
columns add nothing to q . k, and v's give output columns that are sliced
off).  A larger D raises: it needs tiles of its own.
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

# Kernel launches per wrapper since the last reset_launches(): a run can
# show that its path went through the kernels.
LAUNCHES = {name: 0 for name in _build.KERNELS if name.startswith("flash_")}

# Head dims the kernels are instantiated for (flash_*.cu, the D switch);
# any other D up to the largest runs zero-padded to the next of them.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def flash_fwd_plain(q, k, v, *, scale: float, causal: bool,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_offset: int = 0):
    """(o, lse) of the forward kernel, in dense float32 ops."""
    H = q.shape[2]
    s = _masked_scores(q.float(), _repeat_kv(k, H), scale, causal, window,
                       q_offset, kv_offset)
    m = s.amax(dim=-1)                                   # [B, H, Tq]
    m_safe = torch.where(m > 0.5 * NEG_INF, m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(v, H))
    denom = torch.where(l > 0, l, torch.ones_like(l))
    return num / denom.transpose(1, 2)[..., None], lse_from_residuals(m, l)


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
    """dq of the dQ kernel, in dense float32 ops."""
    _, ds, kr = _bwd_plain_terms(q, k, v, do, lse, dvec, scale, causal,
                                 window, q_offset, kv_offset)
    return scale * torch.einsum("bhqk,bkhd->bqhd", ds, kr)


def flash_bwd_dkv_plain(q, k, v, do, lse, dvec, *, scale: float,
                        causal: bool, window: Optional[int] = None,
                        q_offset: int = 0, kv_offset: int = 0):
    """(dk, dv) of the dK/dV kernel, in dense float32 ops: per-q-head
    terms summed over each kv head's group."""
    p, ds, _ = _bwd_plain_terms(q, k, v, do, lse, dvec, scale, causal,
                                window, q_offset, kv_offset)
    B, Tkv, Hkv, D = k.shape
    group = q.shape[2] // Hkv
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
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
}
_SCALARS = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]


def _launch(name: str, tensors, q, k, scale, causal, window, q_offset,
            kv_offset) -> None:
    """Launch kernel ``name`` on ``tensors`` (inputs then outputs), on the
    current stream of q's device; raise on a refused launch."""
    dev = q.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    B, Tq, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    sym, n_ptrs = _SIGNATURES[name]
    with torch.cuda.device(dev):
        _build.launch(name, sym, [_P] * n_ptrs + _SCALARS,
                      *[t.data_ptr() for t in tensors], B, Tq, Tkv, H, Hkv,
                      D, float(scale), int(causal), window or 0, q_offset,
                      kv_offset, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1


def _check_aligned(name: str, tensors) -> None:
    """The kernels copy q / k / v / do rows in 16-byte pieces (cp.async):
    a tensor that starts elsewhere is refused, not read misaligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        names = ", ".join(("q", "k", "v", "do")[:len(tensors)])
        raise ValueError(f"{name}: the kernel takes {names} 16-byte aligned")


def kernel_head_dim(D: int, name: str = "flash") -> int:
    """The head dim the kernels run ``D`` at: the least of
    KERNEL_HEAD_DIMS that holds it.  Raises for a larger D, which needs
    tiles of its own (ROADMAP queue B, variant 4)."""
    for d in KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"{name}: head_dim {D} > {KERNEL_HEAD_DIMS[-1]}, the "
                     f"largest the kernels are built for "
                     f"({KERNEL_HEAD_DIMS}); a larger head dim needs its own "
                     f"tiling")


def pad_head_dim(name: str, *ts: torch.Tensor):
    """``ts`` (q, k, v, dO) with the last dim zero-padded to
    :func:`kernel_head_dim` of it, each a new contiguous tensor, or the
    tensors themselves when D is a kernel head dim."""
    D = ts[0].shape[-1]
    Dk = kernel_head_dim(D, name)
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
    """(o [B, Tq, H, D], lse [B, H, Tq]) — the ``flash_fwd`` kernel on CUDA
    tensors, its plain version on CPU tensors."""
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


def flash_bwd_dq(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                 window: Optional[int] = None, q_offset: int = 0,
                 kv_offset: int = 0):
    """dq [B, Tq, H, D] — the ``flash_bwd_dq`` kernel on CUDA tensors, its
    plain version on CPU tensors."""
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    _check_bwd_shapes(q, do, lse, dvec)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw)
    D = q.shape[-1]
    q, k, v, do = pad_head_dim("flash_bwd_dq", q, k, v, do)
    _check_aligned("flash_bwd_dq", (q, k, v, do))
    dq = torch.empty_like(q)
    if q.numel():
        _launch("flash_bwd_dq", (q, k, v, do, lse, dvec, dq), q, k, **kw)
    return _unpad(dq, D)


def flash_bwd_dkv(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                  window: Optional[int] = None, q_offset: int = 0,
                  kv_offset: int = 0):
    """(dk, dv) [B, Tkv, Hkv, D], summed over each GQA group — the
    ``flash_bwd_dkv`` kernel on CUDA tensors, its plain version on CPU
    tensors."""
    _check_shapes(q, k, v, causal, window, q_offset, kv_offset)
    _check_bwd_shapes(q, do, lse, dvec)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if _device_kind(q) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    D = q.shape[-1]
    q, k, v, do = pad_head_dim("flash_bwd_dkv", q, k, v, do)
    _check_aligned("flash_bwd_dkv", (q, k, v, do))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if k.numel():
        _launch("flash_bwd_dkv", (q, k, v, do, lse, dvec, dk, dv), q, k, **kw)
    return _unpad(dk, D), _unpad(dv, D)


# ---------------------------------------------------------------------------
# Public entry points (the JAX package's signatures)
# ---------------------------------------------------------------------------


def _prescale_enabled() -> bool:
    return bool(runtime.effective_config().flash_prescale)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_offset: int = 0, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward on one device: [B, Tq, H, D] in q's dtype.

    ``window`` (causal only) keeps each query's own key and the
    ``window - 1`` before it; blocks outside the band are skipped, so the
    cost is O(T * window).  With ``Config.flash_prescale`` the scale is
    folded into q once.  ``block_q`` / ``block_k`` (the TPU tiling) are
    accepted for the JAX signature and ignored: the Hopper kernels' tiles
    are fixed in their sources."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
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
    the dQ kernel, then the dK/dV kernel.  ``block_q`` / ``block_k`` are
    ignored, as in :func:`flash_attention`."""
    do = do.float().contiguous()
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    dq = flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    return dq, dk, dv


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
