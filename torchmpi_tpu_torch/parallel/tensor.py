"""Tensor (model) parallelism: the Megatron layers.

The PyTorch counterpart of ``torchmpi_tpu/parallel/tensor.py``, in JAX's
``x @ w`` layout (weights [d_in, d_out]; plain functions on tensors, no
``nn.Module``):

- :func:`column_parallel_dense`: the weight sharded on the output feature
  dim; no communication forward, the input's gradient summed over the
  axis in backward (``f``).
- :func:`row_parallel_dense`: the weight sharded on the input feature dim;
  the partial products summed over the axis forward (``g``).
- :func:`tp_mlp`, :func:`tp_attention` (the heads shard over the axis;
  ``impl="flash"`` runs them through ``ops/flash.py``'s
  ``flash_attention_grad``, the port's hand-written kernels) and
  :func:`tp_transformer_block` (pre-LN, eps 1e-6, exact GELU): one
  allreduce forward and one backward a sublayer.

The f / g pair (JAX :40-70) are two ``torch.autograd.Function``\\ s over the
allreduce: g sums forward and passes the cotangent through, f passes the
input through and sums the cotangent.  A raw allreduce's transpose is
another allreduce, which would count a replicated cotangent once per rank.

Each layer comes in two forms.  Over an axis of the process world
(``axis_name`` as the in-axis verbs take it: an axis or a tuple of axes of
the current communicator), on this rank's tensors, the allreduces
``collectives.allreduce_in_axis``.  And rank-major (``*_rank_major``), on
stacks [n, ...] of the current communicator's n ranks on one device (the
port's stand-in for ``shard_map``): every activation and weight is a
stack, rank r's slice its own; the allreduces are
``collectives.allreduce_rank_major(..., axis_names=axis)`` over the stack
(``backend="pallas"`` runs the ring kernels), the products one batched
``torch.matmul`` over the ranks, and the heads of every rank one flash
launch (the rank dim folded into the batch).  ``backend`` routes both
allreduces of the pair; None takes the Config's.  Layer-norm scales and
biases are [D], or [n, D] stacks in the rank-major form.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .. import collectives


def _sum(x, axis, backend, rank_major):
    """The allreduce (sum) over ``axis``: in the process world, or over the
    groups of a rank-major stack (a ``tp/allreduce`` profiler range)."""
    with record_function("tp/allreduce"):
        if rank_major:
            return collectives.allreduce_rank_major(
                x.contiguous(), op="sum", backend=backend, axis_names=axis)
        return collectives.allreduce_in_axis(x.contiguous(), axis, op="sum",
                                             backend=backend)


class _G(torch.autograd.Function):
    """g: forward the allreduce (sum) over the axis, backward identity."""

    @staticmethod
    def forward(ctx, x, axis, backend, rank_major):
        return _sum(x, axis, backend, rank_major)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _F(torch.autograd.Function):
    """f: forward identity, backward the allreduce (sum) over the axis."""

    @staticmethod
    def forward(ctx, x, axis, backend, rank_major):
        ctx.args = (axis, backend, rank_major)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, *ctx.args), None, None, None


def g_allreduce(x: torch.Tensor, axis_name, backend: Optional[str] = None
                ) -> torch.Tensor:
    """The end of a row-parallel layer: the sum over ``axis_name``, whose
    backward passes the cotangent through (JAX :40)."""
    return _G.apply(x, axis_name, backend, False)


def f_identity(x: torch.Tensor, axis_name, backend: Optional[str] = None
               ) -> torch.Tensor:
    """The entry of a column-parallel layer: identity, whose backward sums
    the cotangent over ``axis_name`` (JAX :57)."""
    return _F.apply(x, axis_name, backend, False)


def g_allreduce_rank_major(xs: torch.Tensor, axis_name,
                           backend: Optional[str] = None) -> torch.Tensor:
    """:func:`g_allreduce` on a stack [n, ...]: every rank's slice the sum
    over its group of ``axis_name``; the backward passes each rank's
    cotangent through to that rank."""
    return _G.apply(xs, axis_name, backend, True)


def f_identity_rank_major(xs: torch.Tensor, axis_name,
                          backend: Optional[str] = None) -> torch.Tensor:
    """:func:`f_identity` on a stack [n, ...]: the backward gives every rank
    the sum of its group's cotangents."""
    return _F.apply(xs, axis_name, backend, True)


class _Form:
    """What the layers need of a form: the axis size, the f / g pair, the
    product and a per-rank parameter's broadcast."""

    def __init__(self, axis_name, n: Optional[int]):
        self.axis = axis_name
        self.n_ranks = n  # None: the process world
        self.size = collectives.axis_size(axis_name, n=n)

    def f(self, x, backend):
        return _F.apply(x, self.axis, backend, self.n_ranks is not None)

    def g(self, x, backend):
        return _G.apply(x, self.axis, backend, self.n_ranks is not None)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` of every rank, one ``torch.bmm`` (a batch of one in
        the process world, so that a world of one computes the rank-major
        form's bits at n = 1)."""
        if self.n_ranks is None:
            w = w.unsqueeze(0)
        y = torch.bmm(x.reshape(w.shape[0], -1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    def param(self, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``p`` [d] (or a stack [n, d]) broadcastable against ``x``."""
        if self.n_ranks is None or p.dim() == 1:
            return p
        return p.reshape(p.shape[0], *([1] * (x.dim() - 2)), p.shape[-1])


def _column(form, x, w, b, backend):
    y = form.mm(form.f(x, backend), w)
    return y if b is None else y + form.param(b, y)


def _row(form, x, w, b, backend):
    y = form.g(form.mm(x, w), backend)
    return y if b is None else y + form.param(b, y)


def _mlp(form, x, w1, w2, act, backend):
    return _row(form, act(_column(form, x, w1, None, backend)), w2, None,
                backend)


def _attention(form, x, wq, wk, wv, wo, *, num_heads, causal, backend,
               impl, window):
    T = x.shape[-2]
    n = form.size
    if num_heads % n:
        raise ValueError(f"num_heads {num_heads} must divide by the "
                         f"axis size {n}")
    h_local = num_heads // n
    width = wq.shape[-1]
    if width % h_local:
        raise ValueError(f"local qkv width {width} must divide by local "
                         f"head count {h_local}")
    d_head = width // h_local
    if impl not in ("dense", "flash"):
        raise ValueError(f"impl must be 'dense' or 'flash', got {impl!r}")
    if impl == "dense" and window is not None:
        raise ValueError("window= requires impl='flash'")

    xr = form.f(x, backend)
    # Every rank's heads in one batch: [ranks * B, T, h_local, d_head].
    q, k, v = (form.mm(xr, w).reshape(-1, T, h_local, d_head)
               for w in (wq, wk, wv))
    if impl == "flash":
        from ..ops.flash import flash_attention_grad

        ctx = flash_attention_grad(q, k, v, causal=causal, window=window)
    else:
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d_head)
        if causal:
            mask = torch.ones(T, T, dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v)
    ctx = ctx.reshape(*x.shape[:-1], width)
    return _row(form, ctx, wo, None, backend)


def _layer_norm(form, h, scale, bias):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + 1e-6) * form.param(scale, h)
            + form.param(bias, h))


def _block(form, x, p, *, num_heads, causal, backend, attn_impl, window):
    a = _attention(form, _layer_norm(form, x, *p["ln1"]), p["wq"], p["wk"],
                   p["wv"], p["wo"], num_heads=num_heads, causal=causal,
                   backend=backend, impl=attn_impl, window=window)
    x = x + a
    m = _mlp(form, _layer_norm(form, x, *p["ln2"]), p["w1"], p["w2"],
             partial(F.gelu, approximate="none"), backend)
    return x + m


# ---------------------------------------------------------------------------
# Over an axis of the process world
# ---------------------------------------------------------------------------


def column_parallel_dense(x: torch.Tensor, w_local: torch.Tensor, axis_name,
                          b_local: Optional[torch.Tensor] = None, *,
                          backend: Optional[str] = None) -> torch.Tensor:
    """x: [..., d_in] replicated over ``axis_name``; w_local: [d_in,
    d_out / n] this rank's column block.  Returns [..., d_out / n], the
    local slice of the activations."""
    return _column(_Form(axis_name, None), x, w_local, b_local, backend)


def row_parallel_dense(x_local: torch.Tensor, w_local: torch.Tensor,
                       axis_name, b: Optional[torch.Tensor] = None,
                       backend: Optional[str] = None) -> torch.Tensor:
    """x_local: [..., d_in / n]; w_local: [d_in / n, d_out] this rank's row
    block.  The partial products are summed over the axis (g)."""
    return _row(_Form(axis_name, None), x_local, w_local, b, backend)


def tp_mlp(x: torch.Tensor, w1_local: torch.Tensor, w2_local: torch.Tensor,
           axis_name, act=torch.tanh, backend: Optional[str] = None
           ) -> torch.Tensor:
    """Column -> activation -> row: the Megatron MLP, one allreduce."""
    return _mlp(_Form(axis_name, None), x, w1_local, w2_local, act, backend)


def tp_attention(x: torch.Tensor, wq_local, wk_local, wv_local, wo_local,
                 axis_name, *, num_heads: int, causal: bool = True,
                 backend: Optional[str] = None, impl: str = "dense",
                 window: Optional[int] = None) -> torch.Tensor:
    """Megatron multi-head self-attention, the heads sharded over
    ``axis_name`` (JAX :98).  ``x``: [B, T, D] replicated; ``wq/wk/wv_local``
    [D, Hl * Dh] column blocks (this rank's Hl = num_heads / n heads,
    head-major columns: a :func:`shard_columns` slice); ``wo_local`` [Hl *
    Dh, D] a row block; ``num_heads`` the global head count.  ``impl``
    "dense" materializes the [B, Hl, T, T] scores; "flash" runs the heads
    through the flash kernels, and takes ``window``."""
    return _attention(_Form(axis_name, None), x, wq_local, wk_local, wv_local,
                      wo_local, num_heads=num_heads, causal=causal,
                      backend=backend, impl=impl, window=window)


def tp_transformer_block(x: torch.Tensor, p_local: dict, axis_name, *,
                         num_heads: int, causal: bool = True,
                         backend: Optional[str] = None,
                         attn_impl: str = "dense",
                         window: Optional[int] = None) -> torch.Tensor:
    """A pre-LN transformer block with both sublayers tensor-parallel:
    ``x + tp_attention(LN(x))`` then ``x + tp_mlp(LN(x))`` with exact GELU.
    ``p_local``: ``ln1`` / ``ln2`` (scale, bias; replicated), ``wq`` /
    ``wk`` / ``wv`` / ``wo`` as in :func:`tp_attention`, ``w1`` / ``w2`` as
    in :func:`tp_mlp`."""
    return _block(_Form(axis_name, None), x, p_local, num_heads=num_heads,
                  causal=causal, backend=backend, attn_impl=attn_impl,
                  window=window)


# ---------------------------------------------------------------------------
# Rank-major: stacks [n, ...] of the current communicator's ranks
# ---------------------------------------------------------------------------


def column_parallel_dense_rank_major(xs, ws, axis_name, bs=None, *,
                                     backend: Optional[str] = None):
    """:func:`column_parallel_dense` on stacks: ``xs`` [n, ..., d_in],
    ``ws`` [n, d_in, d_out / n_axis], ``bs`` [n, d_out / n_axis]."""
    return _column(_Form(axis_name, xs.shape[0]), xs, ws, bs, backend)


def row_parallel_dense_rank_major(xs, ws, axis_name, bs=None,
                                  backend: Optional[str] = None):
    """:func:`row_parallel_dense` on stacks: ``xs`` [n, ..., d_in /
    n_axis], ``ws`` [n, d_in / n_axis, d_out]."""
    return _row(_Form(axis_name, xs.shape[0]), xs, ws, bs, backend)


def tp_mlp_rank_major(xs, w1s, w2s, axis_name, act=torch.tanh,
                      backend: Optional[str] = None):
    """:func:`tp_mlp` on stacks [n, ...]."""
    return _mlp(_Form(axis_name, xs.shape[0]), xs, w1s, w2s, act, backend)


def tp_attention_rank_major(xs, wqs, wks, wvs, wos, axis_name, *,
                            num_heads: int, causal: bool = True,
                            backend: Optional[str] = None,
                            impl: str = "dense",
                            window: Optional[int] = None):
    """:func:`tp_attention` on stacks: ``xs`` [n, B, T, D], the weights
    [n, ...] of each rank's blocks; every rank's heads in one attention
    call (one flash launch)."""
    return _attention(_Form(axis_name, xs.shape[0]), xs, wqs, wks, wvs, wos,
                      num_heads=num_heads, causal=causal, backend=backend,
                      impl=impl, window=window)


def tp_transformer_block_rank_major(xs, ps: dict, axis_name, *,
                                    num_heads: int, causal: bool = True,
                                    backend: Optional[str] = None,
                                    attn_impl: str = "dense",
                                    window: Optional[int] = None):
    """:func:`tp_transformer_block` on stacks: ``xs`` [n, B, T, D], each
    leaf of ``ps`` [n, ...] (layer-norm parameters [D] or [n, D])."""
    return _block(_Form(axis_name, xs.shape[0]), xs, ps, num_heads=num_heads,
                  causal=causal, backend=backend, attn_impl=attn_impl,
                  window=window)


# ---------------------------------------------------------------------------
# Setup helpers
# ---------------------------------------------------------------------------


def shard_columns(w, axis_name, n: int, index: int):
    """This rank's column block of a full [d_in, d_out] weight (numpy or
    torch; ``axis_name`` unused, as in JAX)."""
    cols = w.shape[1] // n
    return w[:, index * cols:(index + 1) * cols]


def shard_rows(w, axis_name, n: int, index: int):
    """This rank's row block of a full [d_in, d_out] weight."""
    rows = w.shape[0] // n
    return w[index * rows:(index + 1) * rows, :]
