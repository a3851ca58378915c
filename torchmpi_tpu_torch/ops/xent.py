"""Fused linear + softmax cross-entropy on Hopper: forward and backward.

The PyTorch counterpart of ``torchmpi_tpu/ops/xent.py``.  Three CUDA
kernels (``ops/csrc/xent_fwd.cu``, ``xent_bwd_dx.cu``, ``xent_bwd_dw.cu``,
sharing ``xent_common.cuh`` and ``xent_wgmma.cuh``)
replace the three Pallas TPU kernels (``_xent_fwd_kernel`` :35,
``_xent_bwd_dx_kernel`` :82, ``_xent_bwd_dw_kernel`` :114).  They
compute ``softmax_xent(x @ w, labels)`` per token, and its gradients,
without the [tokens, vocab] logits in device memory.  Each has a plain
PyTorch version here, written in dense torch ops with the kernels'
conventions:

- a label of -1, or any label outside [0, V), never matches: its logit
  term is 0;
- the backward reads a non-finite lse as 0 (:302);
- g = (exp(z - lse) - onehot) * dl is cast to the operands' dtype before
  the dx and dW products, where the TPU kernels cast it (:106, :140):
  rounded for bf16, kept for float32; the products accumulate in float32,
  dx and dW come out in x's and w's dtypes.

The TPU pads rows to its token block (lse +1e30, label -1, :300-303) and
vocab columns to its vocab block (masked to ``NEG_INF``, :57); the CUDA
kernels bound their rows and columns instead, and the plain versions have
no padding, so neither convention shows in a result.

Every kernel wrapper takes its plain version when, and only when, the
tensors it was given lie on the CPU; on CUDA tensors it launches the kernel
or raises.  The kernels take x and w both bfloat16 (the stage B' loss
casts both) or both float32 (the model's default dtype); mixed or other
dtypes raise.  Each wrapper call that launches a kernel adds one to
``LAUNCHES[name]``, however many chunks it launches.  The backward walks
the tokens in chunks of ``BWD_CHUNK`` rows, one launch of each backward
kernel per chunk, with a [chunk, V] workspace for g in w's dtype and an
[E, V] float32 accumulator for dW (the TPU kernel's own float32
``out_shape``): memory O(chunk), never O(N V).  The forward writes
per-row partial statistics, (m, l, t) of each row over each 256-column
tile on the ``wgmma`` route (3 x ceil(V / 256) x N float32, 12.6 MB at
the flagship) and each 128-column tile on ``wgmma_tf32`` (25 MB), and
merges them in a second kernel.  Every call takes the route ``_route``
picks from its dtype, shapes and addresses, counted in
``ROUTE_LAUNCHES``.  On the ``wgmma_tf32`` route (float32) the wrappers
also make the K-major copies that TF32 ``wgmma`` needs, with their lo
parts (``tf32_split_plain``).  The forward makes W^T and its lo part and
x's lo part (2 x E x V + N x E float32, 604 MB at the flagship), freed
when it returns.  The backward makes its own: W^T and W's lo parts once
per call (3 x E x V float32, 805 MB), x^T and x's per chunk, and g's lo
part and g^T per chunk as the g kernel writes them (3 x chunk x V, 403
MB in that route's chunks of ``TF32_CHUNK`` rows).  The wrappers make no
host-device synchronization.
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

# Each kernel's launches per route (see _route).  A route's index here is
# its code in the C launchers (xent_common.cuh tmx::Route).
ROUTES = ("wgmma", "wmma", "tf32x3", "wgmma_tf32")
ROUTE_LAUNCHES = {name: {r: 0 for r in ROUTES} for name in KERNELS}

# Token rows per backward chunk: the g workspace is BWD_CHUNK x V in w's
# dtype (128 MiB of bf16 at V 32768, 256 MiB of float32).
BWD_CHUNK = 2048
# Token rows per chunk on the wgmma_tf32 route, whose chunk also holds g's
# lo part, g^T and its lo part (3 x TF32_CHUNK x V float32): 1024 keeps
# the float32 flagship step's peak 1.1 GB above the tf32x3 route's, where
# 2048 put it 1.66 GB above (H100, chip_smoke.py's float32 train line);
# dx's grid at 1024 rows is 8 x 16 = 128 blocks of 128 x 128.
TF32_CHUNK = 1024

# The operand dtypes the kernels take (x and w both of one).
_DTYPES = (torch.float32, torch.bfloat16)

# The forward's wmma route: its tiles (xent_common.cuh BM, BN) and the
# number of blocks it aims for: the vocab is split until (N / BM) x splits
# reaches it.  Its wgmma route writes one partial per 256-column tile
# (xent_wgmma.cuh BN), its wgmma_tf32 route one per 128-column tile (TBN).
_BM, _BN, _FWD_BLOCKS = 128, 128, 512
_TILE_COLS = {"wgmma": 256, "wgmma_tf32": 128}
# Rows of one split launch: its grid holds ceil(rows / 32) <= 65535 blocks
# down (xent_wgmma.cuh launch_split).
_SPLIT_ROWS = 65535 * 32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTE_LAUNCHES.values():
        for r in counts:
            counts[r] = 0


def _route(E: int, V: int, *ptrs: Optional[int], dtype: torch.dtype) -> str:
    """The kernels' route for x [., E] and w [E, V] of ``dtype`` and
    operands at device addresses ``ptrs`` (None: no operand), the same in
    the forward and the backward.  bfloat16: ``"wgmma"`` when TMA can read
    and write the operands, i.e. E and V are multiples of 8 (16-byte row
    pitches) and every address is 16-byte aligned; else ``"wmma"``.
    float32: ``"wgmma_tf32"`` (TF32 ``wgmma`` in the three-product form on
    K-major copies) when E and V are multiples of 4 (16-byte row pitches)
    and every address is 16-byte aligned; else ``"tf32x3"`` (the ``wmma``
    product on TF32 fragments in the three-product form)."""
    aligned = all(p is None or p % 16 == 0 for p in ptrs)
    if dtype == torch.float32:
        tma = E % 4 == 0 and V % 4 == 0 and aligned
        return "wgmma_tf32" if tma else "tf32x3"
    return "wgmma" if E % 8 == 0 and V % 8 == 0 and aligned else "wmma"


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


def tf32_split_plain(x):
    """(hi, lo) of float32 ``x`` in the truncating split of the
    ``wgmma_tf32`` route: hi = x with its low 13 bits cleared (the TF32
    value the tensor core reads from x's float32 bits), lo = x - hi, exact
    (x = hi + lo), |lo| < 2^-10 |x| for normal x.  The kernel's copies
    hold x itself as hi and this lo (xent_wgmma.cuh ``tf32_lo``)."""
    hi = (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# The wgmma_tf32 route's K-major copies, in the backward launchers' order
# (xent_wgmma.cuh tmw::Tf32Ops), and those of the forward's launcher; the
# other routes pass them as null.
TF32_OPS = ("x_lo", "xt", "xt_lo", "wt", "wt_lo", "w_lo", "g_lo", "gt",
            "gt_lo")
TF32_FWD_OPS = ("x_lo", "wt", "wt_lo")
_SIGNATURES = {
    # x, w, labels, part, loss, lse, N, E, V, splits, route, TF32_FWD_OPS,
    # stream
    "xent_fwd": ("xent_fwd", "tm_xent_fwd", [_P] * 6 + [_I] * 5 + [_P] * 4),
    # x, w, labels, lse, dl, g, dx, rows, E, V, make_g, route, TF32_OPS,
    # stream
    "xent_bwd_dx": ("xent_bwd_dx", "tm_xent_bwd_dx",
                    [_P] * 7 + [_I] * 5 + [_P] * 10),
    # x, w, labels, lse, dl, g, acc, dw, rows, E, V, make_g, first, last,
    # route, TF32_OPS, stream
    "xent_bwd_dw": ("xent_bwd_dw", "tm_xent_bwd_dw",
                    [_P] * 8 + [_I] * 7 + [_P] * 10),
    # src, lo, hi_t, lo_t, R, C, ldt, stream: the K-major copies of one
    # float32 operand (the dx library's copy of the kernel)
    "xent_split": ("xent_bwd_dx", "tm_xent_split", [_P] * 4 + [_I] * 3 + [_P]),
}


def _launch(name: str, dev: torch.device, *args, ops=None) -> None:
    """Launch kernel ``name`` with ``args`` (tensors as device pointers,
    None as a null pointer, ints as ints) on the current stream of ``dev``;
    raise on a refused launch.  The forward and backward launchers also
    take ``ops``, the wgmma_tf32 route's copies in ``TF32_FWD_OPS`` or
    ``TF32_OPS`` order (null without)."""
    lib, sym, argtypes = _SIGNATURES[name]
    names = {"xent_fwd": TF32_FWD_OPS, "xent_bwd_dx": TF32_OPS,
             "xent_bwd_dw": TF32_OPS}.get(name, ())
    args += tuple(ops) if ops is not None else (None,) * len(names)
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        _build.launch(lib, sym, argtypes, *vals,
                      torch.cuda.current_stream(dev).cuda_stream)


def _cuda_operands(name, x, w, labels, *stats):
    """The kernels' operands on x's card: x and w as they are, both
    bfloat16 or both float32 (raise on mixed or other dtypes: nothing is
    cast behind the caller's back), labels cast to int32 and stats to
    float32 on the device."""
    dev = x.device
    for t in (w, labels, *stats):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes x and w both bfloat16 or "
                        f"both float32, got {x.dtype} and {w.dtype}")
    for t in (x, w):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous x and w")
    return (labels.to(torch.int32).contiguous(),
            *(s.to(torch.float32).contiguous() for s in stats))


def _fwd_splits(n: int, v: int) -> int:
    """Vocab runs of the forward's wmma grid: enough blocks to fill the
    card."""
    row_blocks = -(-n // _BM)
    tiles = -(-v // _BN)
    return max(1, min(tiles, -(-_FWD_BLOCKS // row_blocks)))


def _fwd_tf32_copies(x, w) -> list:
    """The forward's K-major copies on the ``wgmma_tf32`` route, in
    ``TF32_FWD_OPS`` order: x's lo part [N, E] and W^T and its lo part
    [V, E], made by two ``xent_split`` launches (W's at pitch E, then x's
    lo part, no transposes; x in slabs of ``_SPLIT_ROWS`` rows)."""
    (N, E), V = x.shape, w.shape[1]
    dev = x.device
    x_lo = torch.empty(N, E, dtype=torch.float32, device=dev)
    wt = torch.empty(V, E, dtype=torch.float32, device=dev)
    wt_lo = torch.empty_like(wt)
    _launch("xent_split", dev, w, None, wt, wt_lo, E, V, E)
    for r0 in range(0, N, _SPLIT_ROWS):
        r1 = min(N, r0 + _SPLIT_ROWS)
        _launch("xent_split", dev, x[r0:r1], x_lo[r0:r1], None, None,
                r1 - r0, E, 0)
    return [x_lo, wt, wt_lo]


def xent_fwd(x, w, labels):
    """(loss [N], lse [N]) float32 — the ``xent_fwd`` kernel on CUDA
    tensors, its plain version on CPU tensors.  One partial (m, l, t) a
    row per 256-column tile on ``wgmma``, per 128-column tile on
    ``wgmma_tf32`` (whose K-major copies are made here and freed on
    return), per run of ``_fwd_splits`` tiles on the other routes."""
    _check(x, w, labels)
    if _device_kind(x) == "cpu":
        return xent_fwd_plain(x, w, labels)
    (lab,) = _cuda_operands("xent_fwd", x, w, labels)
    N, E = x.shape
    V = w.shape[1]
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if N:
        route = _route(E, V, x.data_ptr(), w.data_ptr(), dtype=x.dtype)
        splits = (-(-V // _TILE_COLS[route]) if route in _TILE_COLS
                  else _fwd_splits(N, V))
        part = torch.empty(3, splits, N, dtype=torch.float32,
                           device=x.device)
        kw = ({"ops": _fwd_tf32_copies(x, w)} if route == "wgmma_tf32"
              else {})
        _launch("xent_fwd", x.device, x, w, lab, part, loss, lse, N, E, V,
                splits, ROUTES.index(route), **kw)
        LAUNCHES["xent_fwd"] += 1
        ROUTE_LAUNCHES["xent_fwd"][route] += 1
    return loss, lse


def _tf32_pitch(rows: int) -> int:
    """Row pitch of a chunk's transposed copies (x^T, g^T and their lo
    parts, [E or V, pitch]): rows rounded up to 4 float32, the 16 bytes
    TMA needs (xent_wgmma.cuh ``tf32_pitch``).  A shorter last chunk
    packs its copies at its own pitch at the start of the buffers."""
    return -(-rows // 4) * 4


def _tf32_workspace(w, C: int, want_dx: bool, want_dw: bool) -> list:
    """The ``wgmma_tf32`` route's K-major copies for chunks of up to ``C``
    rows, in ``TF32_OPS`` order, None where the call needs none: x_lo [C,
    E] (the g kernel's A operand), W^T and its lo part [V, E] (its B
    operand), W's lo part [E, V] (dx's B operand), g's lo part [C, V]
    (dx's A operand), x^T, g^T and their lo parts [E or V, pitch] (dW's
    operands).  W's copies are made here, once per call; x's are made
    per chunk, g's by the launch that forms g."""
    E, V = w.shape
    ldt = _tf32_pitch(C)

    def new(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=w.device)

    ops = dict(x_lo=new(C, E), wt=new(V, E), wt_lo=new(V, E),
               w_lo=new(E, V) if want_dx else None,
               g_lo=new(C, V) if want_dx else None,
               xt=new(E, ldt) if want_dw else None,
               xt_lo=new(E, ldt) if want_dw else None,
               gt=new(V, ldt) if want_dw else None,
               gt_lo=new(V, ldt) if want_dw else None)
    _launch("xent_split", w.device, w, ops["w_lo"], ops["wt"], ops["wt_lo"],
            E, V, E)
    return [ops[k] for k in TF32_OPS]


def _bwd_cuda(x, w, labels, lse, dl, want_dx: bool, want_dw: bool):
    """(dx or None, dW or None) on the card, chunk by chunk; with both
    wanted, g is formed once per chunk (by the dx launch) and read by the
    dW launch.  Every chunk takes the route ``_route`` picks for the
    call; on ``wgmma_tf32`` the chunk's x copies are made before its
    launches, and W's once before the first."""
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
    route = _route(E, V, *(t.data_ptr() for t in (x, w, dx, dw)
                           if t is not None), dtype=x.dtype)
    code = ROUTES.index(route)
    C = min(TF32_CHUNK if route == "wgmma_tf32" else BWD_CHUNK, N)
    acc = (torch.empty(E, V, dtype=torch.float32, device=dev)
           if want_dw and N > C else None)
    ops = (_tf32_workspace(w, C, want_dx, want_dw)
           if route == "wgmma_tf32" else None)
    # The g workspace (dW alone on wgmma_tf32 forms only g^T: none).
    g = (torch.empty(C, V, dtype=w.dtype, device=dev)
         if ops is None or want_dx else None)
    kw = {} if ops is None else {"ops": ops}
    for c0 in range(0, N, C):
        c1 = min(N, c0 + C)
        rows = c1 - c0
        if ops is not None:
            _launch("xent_split", dev, x[c0:c1], *ops[:3], rows, E,
                    _tf32_pitch(rows))
        chunk = (x[c0:c1], w, lab[c0:c1], lse[c0:c1], dl[c0:c1], g)
        if want_dx:
            _launch("xent_bwd_dx", dev, *chunk, dx[c0:c1], rows, E, V, 1,
                    code, **kw)
        if want_dw:
            _launch("xent_bwd_dw", dev, *chunk, acc, dw, rows, E, V,
                    int(not want_dx), int(c0 == 0), int(c1 == N), code,
                    **kw)
    for name, wanted in (("xent_bwd_dx", want_dx), ("xent_bwd_dw", want_dw)):
        LAUNCHES[name] += int(wanted)
        ROUTE_LAUNCHES[name][route] += int(wanted)
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
