"""Fused linear + softmax cross-entropy on Hopper: forward and backward.

The PyTorch counterpart of ``torchmpi_tpu/ops/xent.py``.  Three CUDA
kernels (``ops/csrc/xent_fwd.cu``, ``xent_bwd_dx.cu``, ``xent_bwd_dw.cu``,
sharing ``xent_common.cuh``) replace the three Pallas TPU kernels
(``_xent_fwd_kernel`` :35, ``_xent_bwd_dx_kernel`` :82,
``_xent_bwd_dw_kernel`` :114).  They compute ``softmax_xent(x @ w, labels)``
per token, and its gradients, without the [tokens, vocab] logits in device
memory.  Each has a plain PyTorch version here, written in dense torch ops
with the kernels' conventions:

- a label of -1, or any label outside [0, V), never matches: its logit
  term is 0;
- the backward reads a non-finite lse as 0 (:302);
- g = (exp(z - lse) - onehot) * dl is rounded to the operands' dtype
  before the dx and dW products, where the TPU kernels round it (:106,
  :140); the products accumulate in float32, dx and dW come out in x's and
  w's dtypes.

The TPU pads rows to its token block (lse +1e30, label -1, :300-303) and
vocab columns to its vocab block (masked to ``NEG_INF``, :57); the CUDA
kernels bound their rows and columns instead, and the plain versions have
no padding, so neither convention shows in a result.

Every kernel wrapper takes its plain version when, and only when, the
tensors it was given lie on the CPU; on CUDA tensors it launches the kernel
or raises.  The kernels take bfloat16 x and w (the stage B' loss casts
both); float32 CUDA tensors raise.  Each wrapper call that launches a
kernel adds one to ``LAUNCHES[name]``, however many chunks it launches.
The backward walks the tokens in chunks of ``BWD_CHUNK`` rows, one launch
of each backward kernel per chunk, with a [chunk, V] bf16 workspace for g
and an [E, V] float32 accumulator for dW
(the TPU kernel's own float32 ``out_shape``): memory O(chunk), never
O(N V).  The wrappers make no host-device synchronization.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash import NEG_INF, _device_kind

KERNELS = ("xent_fwd", "xent_bwd_dx", "xent_bwd_dw")

# Kernel launches per wrapper since the last reset_launches(): a run can
# show that its path went through the kernels.
LAUNCHES = {name: 0 for name in KERNELS}

# Token rows per backward chunk: the g workspace is BWD_CHUNK x V bf16
# (128 MiB at V 32768).
BWD_CHUNK = 2048

# The forward kernel's tiles (xent_common.cuh BM, BN) and the number of
# blocks it aims for: the vocab is split until (N / BM) x splits reaches it.
_BM, _BN, _FWD_BLOCKS = 128, 128, 512


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(x, w, labels) -> None:
    if x.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"expected x [N, E], w [E, V], labels [N]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    if w.shape[0] != x.shape[1] or labels.shape[0] != x.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} labels {tuple(labels.shape)}")
    if w.shape[1] < 1:
        raise ValueError("w needs at least one vocab column")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {labels.dtype}")


def _check_stats(x, lse, dl) -> None:
    n = x.shape[0]
    if tuple(lse.shape) != (n,) or tuple(dl.shape) != (n,):
        raise ValueError(f"lse / dl must be [{n}], got {tuple(lse.shape)} "
                         f"and {tuple(dl.shape)}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------


def _logits(x, w):
    """z = x @ w in float32 (products of bf16 operands are exact there)."""
    return x.float() @ w.float()


def _onehot(labels, V, like):
    """[N, V] float32 one-hot; a label outside [0, V) is an all-zero row."""
    cols = torch.arange(V, device=like.device)
    return (labels.long()[:, None] == cols[None, :]).float()


def xent_fwd_plain(x, w, labels):
    """(loss [N], lse [N]) float32 of the forward kernel, in dense ops:
    lse = logsumexp(x @ w), loss = lse - (x @ w)[label]."""
    z = _logits(x, w)
    lse = torch.logsumexp(z, dim=1)
    t = (z * _onehot(labels, z.shape[1], z)).sum(dim=1)
    return lse - t, lse


def _grad_plain(x, w, labels, lse, dl):
    """g = (exp(z - lse) - onehot) * dl, float32, dense."""
    z = _logits(x, w)
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(z - lse.float()[:, None])
    return (p - _onehot(labels, z.shape[1], z)) * dl.float()[:, None]


def xent_bwd_dx_plain(x, w, labels, lse, dl):
    """dx [N, E] in x's dtype: g rounded to w's dtype, then g @ w^T in
    float32 (the dx kernel's function)."""
    g = _grad_plain(x, w, labels, lse, dl).to(w.dtype)
    return (g.float() @ w.float().t()).to(x.dtype)


def xent_bwd_dw_plain(x, w, labels, lse, dl):
    """dW [E, V] in w's dtype: g rounded to x's dtype, then x^T @ g in
    float32 (the dW kernel's function)."""
    g = _grad_plain(x, w, labels, lse, dl).to(x.dtype)
    return (x.float().t() @ g.float()).to(w.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, labels, part, loss, lse, N, E, V, splits, stream
    "xent_fwd": ("tm_xent_fwd", [_P] * 6 + [_I] * 4 + [_P]),
    # x, w, labels, lse, dl, g, dx, rows, E, V, make_g, stream
    "xent_bwd_dx": ("tm_xent_bwd_dx", [_P] * 7 + [_I] * 4 + [_P]),
    # x, w, labels, lse, dl, g, acc, dw, rows, E, V, make_g, first, last,
    # stream
    "xent_bwd_dw": ("tm_xent_bwd_dw", [_P] * 8 + [_I] * 6 + [_P]),
}


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch kernel ``name`` with ``args`` (tensors as device pointers,
    None as a null pointer, ints as ints) on the current stream of ``dev``;
    raise on a refused launch."""
    sym, argtypes = _SIGNATURES[name]
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        _build.launch(name, sym, argtypes, *vals,
                      torch.cuda.current_stream(dev).cuda_stream)


def _cuda_operands(name, x, w, labels, *stats):
    """The kernels' operands on x's card: bf16 x and w as they are (raise
    otherwise), labels cast to int32 and stats to float32 on the device."""
    dev = x.device
    for t in (w, labels, *stats):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
    for t in (x, w):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16 x and w, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous x and w")
    return (labels.to(torch.int32).contiguous(),
            *(s.to(torch.float32).contiguous() for s in stats))


def _fwd_splits(n: int, v: int) -> int:
    """Vocab runs of the forward grid: enough blocks to fill the card."""
    row_blocks = -(-n // _BM)
    tiles = -(-v // _BN)
    return max(1, min(tiles, -(-_FWD_BLOCKS // row_blocks)))


def xent_fwd(x, w, labels):
    """(loss [N], lse [N]) float32 — the ``xent_fwd`` kernel on CUDA
    tensors, its plain version on CPU tensors."""
    _check(x, w, labels)
    if _device_kind(x) == "cpu":
        return xent_fwd_plain(x, w, labels)
    (lab,) = _cuda_operands("xent_fwd", x, w, labels)
    N, E = x.shape
    V = w.shape[1]
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if N:
        splits = _fwd_splits(N, V)
        part = torch.empty(3, splits, N, dtype=torch.float32,
                           device=x.device)
        _launch("xent_fwd", x.device, x, w, lab, part, loss, lse, N, E, V,
                splits)
        LAUNCHES["xent_fwd"] += 1
    return loss, lse


def _bwd_cuda(x, w, labels, lse, dl, want_dx: bool, want_dw: bool):
    """(dx or None, dW or None) on the card, chunk by chunk; with both
    wanted, g is formed once per chunk (by the dx launch) and read by the
    dW launch."""
    lab, lse, dl = _cuda_operands("xent_bwd", x, w, labels, lse, dl)
    N, E = x.shape
    V = w.shape[1]
    dev = x.device
    dx = torch.empty_like(x) if want_dx else None
    if not want_dw:
        dw = None
    elif N == 0:
        dw = torch.zeros_like(w)
    else:
        dw = torch.empty_like(w)
    if N == 0:
        return dx, dw
    C = min(BWD_CHUNK, N)
    g = torch.empty(C, V, dtype=torch.bfloat16, device=dev)
    acc = (torch.empty(E, V, dtype=torch.float32, device=dev)
           if want_dw and N > C else None)
    for c0 in range(0, N, C):
        c1 = min(N, c0 + C)
        rows = c1 - c0
        chunk = (x[c0:c1], w, lab[c0:c1], lse[c0:c1], dl[c0:c1], g)
        if want_dx:
            _launch("xent_bwd_dx", dev, *chunk, dx[c0:c1], rows, E, V, 1)
        if want_dw:
            _launch("xent_bwd_dw", dev, *chunk, acc, dw, rows, E, V,
                    int(not want_dx), int(c0 == 0), int(c1 == N))
    for name, wanted in (("xent_bwd_dx", want_dx), ("xent_bwd_dw", want_dw)):
        LAUNCHES[name] += int(wanted)
    return dx, dw


def xent_bwd_dx(x, w, labels, lse, dl):
    """dx [N, E] in x's dtype — the ``xent_bwd_dx`` kernel (g recomputed
    in each chunk) on CUDA tensors, its plain version on CPU tensors."""
    _check(x, w, labels)
    _check_stats(x, lse, dl)
    if _device_kind(x) == "cpu":
        return xent_bwd_dx_plain(x, w, labels, lse, dl)
    return _bwd_cuda(x, w, labels, lse, dl, True, False)[0]


def xent_bwd_dw(x, w, labels, lse, dl):
    """dW [E, V] in w's dtype — the ``xent_bwd_dw`` kernel (g recomputed
    in each chunk) on CUDA tensors, its plain version on CPU tensors."""
    _check(x, w, labels)
    _check_stats(x, lse, dl)
    if _device_kind(x) == "cpu":
        return xent_bwd_dw_plain(x, w, labels, lse, dl)
    return _bwd_cuda(x, w, labels, lse, dl, False, True)[1]


def xent_bwd(x, w, labels, lse, dl, *, want_dx: bool = True,
             want_dw: bool = True):
    """(dx, dW) of the loss, ``None`` for one not wanted: the two backward
    kernels on CUDA tensors, forming g once per chunk for both; the plain
    versions on CPU tensors."""
    _check(x, w, labels)
    _check_stats(x, lse, dl)
    if _device_kind(x) == "cpu":
        return (xent_bwd_dx_plain(x, w, labels, lse, dl) if want_dx else None,
                xent_bwd_dw_plain(x, w, labels, lse, dl) if want_dw else None)
    return _bwd_cuda(x, w, labels, lse, dl, want_dx, want_dw)


# ---------------------------------------------------------------------------
# Public entry point (the JAX package's signature)
# ---------------------------------------------------------------------------


class _FusedXentFn(torch.autograd.Function):
    """The JAX package's ``_xent_vjp`` (:277-352): the forward saves (x, w,
    labels, lse); the backward runs the dx and dW kernels on ``dloss``.
    Labels get no gradient."""

    @staticmethod
    def forward(ctx, x, w, labels):
        loss, lse = xent_fwd(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = xent_bwd(x, w, labels, lse, dloss.contiguous(),
                          want_dx=ctx.needs_input_grad[0],
                          want_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def fused_linear_cross_entropy(x, w, labels, *,
                               block_n: Optional[int] = None,
                               block_v: Optional[int] = None) -> torch.Tensor:
    """Per-token ``softmax_xent(x @ w, labels)`` without materializing the
    logits: float32 loss [N], differentiable in x and w.

    ``x``: [N, E] activations; ``w``: [E, V] unembedding; ``labels``: [N]
    int.  The backward recomputes probabilities chunk by chunk from the
    saved lse.  ``block_n`` / ``block_v`` (the TPU tiling) are accepted for
    the JAX signature and ignored: the Hopper kernels' tiles are fixed in
    their sources."""
    _check(x, w, labels)
    return _FusedXentFn.apply(x.contiguous(), w.contiguous(), labels)
