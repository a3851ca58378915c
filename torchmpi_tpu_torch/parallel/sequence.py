"""Sequence-parallel attention: ring and Ulysses, and the dense oracle.

The PyTorch counterpart of ``torchmpi_tpu/parallel/sequence.py``: the
sequence dimension is sharded over the ranks of an axis, and

- :func:`ring_attention` (JAX :86) keeps each rank's queries in place while
  the key / value shards rotate around the ring (JAX's ``ppermute``, rank i
  to i + 1), folding each step's block into a running online-softmax state
  (``_combine``, :37), so the whole sequence's scores never exist on one
  rank.  ``block_impl="dense"`` computes a step's block in torch ops
  (``_attn_block``, :54, differentiated by autograd); ``"flash"`` runs the
  residual form of the flash forward kernel for it
  (``ops.flash.flash_attention(..., return_residuals=True)``) and has a
  backward ring of its own (``_RingFlash``, JAX's ``_ring_flash_vjp``
  :193-247): the two backward kernels a step, k / v rotating n - 1 times
  and the dk / dv accumulators n times, so that they land home.
- :func:`ulysses_attention` (JAX :250) swaps the sequence shard for a head
  shard with an all-to-all, attends over the whole sequence on its heads
  (dense, or ``flash_attention_grad``) and swaps back.

Each comes in two forms.  Over an axis of the process world
(``axis_name`` as the in-axis verbs take it: "ici", "dcn", or both / None
for the whole world), on this rank's ``[B, T_local, H, D]`` tensors: the
rotation is ``collectives.shift_in_axis_grad`` (one ``batch_isend_irecv``
over the axis's group inside an autograd Function whose backward rotates
the other way, the transpose of ``ppermute``), and the all-to-all ``collectives.alltoall_in_axis_grad``,
whose backward is the inverse all-to-all.  And rank-major
(``*_rank_major``), on stacks ``[n, B, T_local, H, D]`` of n ranks'
shards on one device, the port's stand-in for ``shard_map``: the
rotation is a rotation of the list of the ranks' shards (``torch.roll``
on the rank dim without the copy), the all-to-all
``collectives.alltoall_rank_major``.  Rank r's shard starts at global
position ``r * T_local``; offsets are Python ints in both forms, so no
step reads one from the device.

Conventions copied from the JAX module: dense blocks mask with -inf, flash
blocks with the finite ``NEG_INF``; ``_combine``'s ``isfinite`` guards let
a fully masked block add nothing; a row with no valid key anywhere gives o
= 0 (and lse = +1e30 on the flash path), never NaN.  ``block_q`` /
``block_k`` are accepted and ignored (ROADMAP queue C note 4).
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """[Tq, Tk] bool: causal over global positions, optionally restricted
    to the sliding band ``q - k < window``."""
    keep = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        keep &= q_pos[:, None] - k_pos[None, :] < window
    return keep


def _combine(m_run, l_run, o_run, o_b, m_b, l_b):
    """Fold a block's partials (numerator ``o_b``, max ``m_b``, denominator
    ``l_b``) into the running state (JAX :37).  -inf (dense blocks) and the
    finite NEG_INF with l_b == 0 (flash blocks) alike add nothing; exp never
    sees a positive argument because m_run, m_b <= m_new."""
    m_new = torch.maximum(m_run, m_b)
    safe_new = torch.where(torch.isfinite(m_new), m_new, 0.0)
    c_run = torch.where(torch.isfinite(m_run), torch.exp(m_run - safe_new),
                        0.0)
    c_b = torch.where(torch.isfinite(m_b), torch.exp(m_b - safe_new), 0.0)
    l_run = l_run * c_run + l_b * c_b
    o_run = (o_run * c_run.transpose(-1, -2)[..., None]
             + o_b * c_b.transpose(-1, -2)[..., None])
    return m_new, l_run, o_run


def _attn_block(q, k, v, scale, mask):
    """One q block against one kv block with explicit max and denominator
    (JAX :54).  q ``[..., Tq, H, D]``, k / v ``[..., Tk, H, D]``, mask
    broadcastable to ``[..., H, Tq, Tk]`` or None.  Returns (numerator
    ``[..., Tq, H, D]``, max ``[..., H, Tq]``, denominator ``[..., H,
    Tq]``); a fully masked row has max -inf and p = 0, never NaN."""
    s = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("...hqk,...khd->...qhd", p, v)
    return o, m, l


def _normalize(o_run, l_run):
    """o / l, rows with no valid key (l == 0) reading 0."""
    denom = torch.where(l_run > 0, l_run, 1.0)
    return o_run / denom.transpose(-1, -2)[..., None]


# ---------------------------------------------------------------------------
# The two forms of a ring: this process's rank, or n ranks on one device
# ---------------------------------------------------------------------------


class _StackRing:
    """A ring as the algorithms below see it, here n ranks' shards stacked
    on one device (``[n, ...]``): ``n``, the ranks this form holds
    (``ranks``), a tensor as the list of those ranks' shards (``split``)
    and back (``join``), and ``rotate``, which moves each rank's shard to
    rank i + 1 (``grad``: so that autograd follows it)."""

    def __init__(self, n: int):
        self.n, self.ranks = n, list(range(n))

    def split(self, x):
        return list(x.unbind(0))

    def join(self, xs):
        return torch.stack(xs)

    def rotate(self, xs, grad: bool = False):
        # A rotation of the list, which autograd follows as it is.
        return xs[-1:] + xs[:-1]


class _WorldRing:
    """The ring of :class:`_StackRing`'s interface in the process world:
    this process's rank of ``axis_name``; the rotation is
    ``collectives.shift_in_axis(_grad)``."""

    def __init__(self, axis_name, verb: str):
        from .. import collectives

        self.axis = collectives._world_axes(verb, axis_name)
        _, self.my, self.n = collectives._peer_group(self.axis)
        self.axis_names = axis_name
        self.ranks = [self.my]

    def split(self, x):
        return [x]

    def join(self, xs):
        return xs[0]

    def rotate(self, xs, grad: bool = False):
        from .. import collectives

        shift = (collectives.shift_in_axis_grad if grad
                 else collectives.shift_in_axis)
        return [shift(xs[0], self.axis)]


def _check_block_impl(block_impl: str) -> None:
    if block_impl not in ("dense", "flash"):
        raise ValueError(f"unknown block_impl {block_impl!r}")


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def _ring_dense(ring, qs, ks, vs, causal, scale, window):
    """The dense ring (JAX :118-156) on the ranks' shards: autograd
    differentiates it, through the rotations."""
    n = ring.n
    Tq, Tk = qs[0].shape[1], ks[0].shape[1]
    dev = qs[0].device
    state = [(torch.full((q.shape[0], q.shape[2], Tq), float("-inf"),
                         dtype=q.dtype, device=dev),
              torch.zeros(q.shape[0], q.shape[2], Tq, dtype=q.dtype,
                          device=dev),
              torch.zeros_like(q)) for q in qs]
    for step in range(n):
        for i, r in enumerate(ring.ranks):
            mask = None
            if causal:
                owner = (r - step) % n
                mask = causal_window_mask(
                    r * Tq + torch.arange(Tq, device=dev),
                    owner * Tk + torch.arange(Tk, device=dev), window)
            o_b, m_b, l_b = _attn_block(qs[i], ks[i], vs[i], scale, mask)
            state[i] = _combine(*state[i], o_b, m_b, l_b)
        if step != n - 1:
            ks = ring.rotate(ks, grad=True)
            vs = ring.rotate(vs, grad=True)
    return [_normalize(o, l) for _, l, o in state]


def _ring_flash_forward(ring, qs, ks, vs, causal, scale, window):
    """The flash ring's forward (JAX :159-189): n residual launches a rank,
    combined; returns each rank's (o in q's dtype, lse float32)."""
    from ..ops.flash import flash_attention, lse_from_residuals

    n = ring.n
    Tq, Tk = qs[0].shape[1], ks[0].shape[1]
    runs = []
    for q in qs:
        B, _, H, _ = q.shape
        runs.append([torch.full((B, H, Tq), float("-inf"),
                                dtype=torch.float32, device=q.device),
                     torch.zeros(B, H, Tq, dtype=torch.float32,
                                 device=q.device),
                     torch.zeros(q.shape, dtype=torch.float32,
                                 device=q.device)])
    for step in range(n):
        for i, r in enumerate(ring.ranks):
            o_b, m_b, l_b = flash_attention(
                qs[i], ks[i], vs[i], causal=causal, scale=scale,
                q_offset=r * Tq, kv_offset=((r - step) % n) * Tk,
                window=window, return_residuals=True)
            runs[i] = _combine(*runs[i], o_b, m_b, l_b)
        if step != n - 1:
            ks, vs = ring.rotate(ks), ring.rotate(vs)
    outs, lses = [], []
    for q, (m_run, l_run, o_run) in zip(qs, runs):
        outs.append(_normalize(o_run, l_run).to(q.dtype))
        lses.append(lse_from_residuals(
            torch.where(torch.isfinite(m_run), m_run, 0.0), l_run))
    return outs, lses


class _RingFlash(torch.autograd.Function):
    """The flash ring as one differentiable unit (JAX ``_ring_flash_vjp``
    :193-247): the forward saves only (q, k, v, o, lse); the backward runs
    its own ring, the dQ and dK/dV kernels a step with that step's
    offsets, k / v rotating n - 1 times and the dk / dv accumulators n
    times, so that each shard's gradient visits every q owner and lands
    home."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, window):
        outs, lses = _ring_flash_forward(ring, ring.split(q), ring.split(k),
                                         ring.split(v), causal, scale, window)
        o, lse = ring.join(outs), ring.join(lses)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (ring, causal, scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        from ..ops.flash import flash_attention_bwd

        q, k, v, o, lse = ctx.saved_tensors
        ring, causal, scale, window = ctx.args
        n = ring.n
        do = do.float().contiguous()
        dvec = torch.einsum("...qhd,...qhd->...hq", do, o.float())
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        dos, lses = ring.split(do), ring.split(lse)
        dvecs = [d.contiguous() for d in ring.split(dvec)]
        Tq, Tk = qs[0].shape[1], ks[0].shape[1]
        dqs = [None] * len(qs)
        dks = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for x in ks]
        dvs = [torch.zeros_like(x) for x in dks]
        for step in range(n):
            for i, r in enumerate(ring.ranks):
                dq_c, dk_c, dv_c = flash_attention_bwd(
                    qs[i], ks[i], vs[i], dos[i], lses[i], dvecs[i],
                    causal=causal, scale=scale, q_offset=r * Tq,
                    kv_offset=((r - step) % n) * Tk, window=window)
                dqs[i] = dq_c if dqs[i] is None else dqs[i] + dq_c
                dks[i] = dks[i] + dk_c
                dvs[i] = dvs[i] + dv_c
            # The accumulators rotate every step (n in all) and land on
            # their owner; k / v are dead after their last use.
            dks, dvs = ring.rotate(dks), ring.rotate(dvs)
            if step != n - 1:
                ks, vs = ring.rotate(ks), ring.rotate(vs)
        return (ring.join(dqs).to(q.dtype), ring.join(dks).to(k.dtype),
                ring.join(dvs).to(v.dtype), None, None, None, None)


def _ring(ring, q, k, v, causal, scale, block_impl, window):
    from ..ops.flash import _check_window

    if window is not None:
        _check_window(window, causal)
    _check_block_impl(block_impl)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if block_impl == "flash":
        return _RingFlash.apply(q, k, v, ring, causal, float(scale), window)
    return ring.join(_ring_dense(ring, ring.split(q), ring.split(k),
                                 ring.split(v), causal, scale, window))


def ring_attention(q, k, v, axis_name=None, *, causal: bool = False,
                   scale: Optional[float] = None, block_impl: str = "dense",
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Blockwise ring attention over ``axis_name`` of the process world.

    q, k, v: this rank's ``[B, T_local, H, D]`` shard of a sequence of
    ``n * T_local`` positions in the axis's rank order.  Returns this
    rank's block of the output, shaped as ``q``.  ``n - 1`` rotations of
    (k, v), each rank sending ``2 * T_local * H * D`` elements a step.
    ``block_impl`` "dense" (torch ops, [T_local, T_local] scores a step)
    or "flash" (the residual flash kernel a step, and its own backward
    ring)."""
    return _ring(_WorldRing(axis_name, "ring_attention"), q, k, v, causal,
                 scale, block_impl, window)


def ring_attention_rank_major(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None,
                              block_impl: str = "dense",
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """:func:`ring_attention` for n ranks on one device: q, k, v ``[n, B,
    T_local, H, D]``, rank r's shard at global positions ``r * T_local``
    on; returns ``[n, B, T_local, H, D]``, each rank's block as the
    process-world form computes it.  The flash form launches the residual
    kernel once per rank and step (n² in all; the masked ones skip every
    block)."""
    return _ring(_StackRing(q.shape[0]), q, k, v, causal, scale, block_impl,
                 window)


# ---------------------------------------------------------------------------
# Ulysses attention
# ---------------------------------------------------------------------------


def _ulysses_check(q, n, causal, scale, block_impl, window):
    from ..ops.flash import _check_window

    H, D = q.shape[-2], q.shape[-1]
    if window is not None:
        _check_window(window, causal)
    if H % n != 0:
        raise ValueError(f"heads {H} not divisible by axis size {n}")
    _check_block_impl(block_impl)
    return 1.0 / (D ** 0.5) if scale is None else scale


def _full_attention(qg, kg, vg, causal, scale, block_impl, window):
    """Attention over the whole sequence on a head shard ([..., T, H/n, D]):
    the flash kernels with offsets 0 (the leading dims folded into the
    batch: one launch for all of them), or a dense block."""
    if block_impl == "flash":
        from ..ops.flash import flash_attention_grad

        lead = qg.shape[:-3]
        fold = lambda t: t.reshape(-1, *t.shape[-3:])  # noqa: E731
        o = flash_attention_grad(fold(qg), fold(kg), fold(vg), causal=causal,
                                 scale=scale, window=window)
        return o.reshape(*lead, *o.shape[1:])
    mask = None
    if causal:
        pos = torch.arange(qg.shape[-3], device=qg.device)
        mask = causal_window_mask(pos, pos, window)
    o, _, l = _attn_block(qg, kg, vg, scale, mask)
    return _normalize(o, l)


def ulysses_attention(q, k, v, axis_name=None, *, causal: bool = False,
                      scale: Optional[float] = None,
                      block_impl: str = "dense",
                      window: Optional[int] = None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention over
    ``axis_name`` of the process world: this rank's ``[B, T_local, H, D]``
    shard, ``H`` divisible by the axis size n.  An all-to-all turns the
    sequence shard into a head shard ``[B, n * T_local, H / n, D]``; full
    attention runs on it (dense, or ``flash_attention_grad``, offsets 0);
    the inverse all-to-all brings the sequence shard back."""
    ring = _WorldRing(axis_name, "ulysses_attention")
    scale = _ulysses_check(q, ring.n, causal, scale, block_impl, window)
    from ..collectives import alltoall_in_axis_grad

    qg, kg, vg = (alltoall_in_axis_grad(t, ring.axis_names, split_axis=2,
                                        concat_axis=1) for t in (q, k, v))
    o = _full_attention(qg, kg, vg, causal, scale, block_impl, window)
    return alltoall_in_axis_grad(o, ring.axis_names, split_axis=1,
                                 concat_axis=2)


def ulysses_attention_rank_major(q, k, v, *, causal: bool = False,
                                 scale: Optional[float] = None,
                                 block_impl: str = "dense",
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """:func:`ulysses_attention` for n ranks on one device: stacks ``[n, B,
    T_local, H, D]`` through ``collectives.alltoall_rank_major``; the
    flash form runs all n ranks' head shards in one launch a kernel."""
    from .. import collectives

    n = q.shape[0]
    scale = _ulysses_check(q, n, causal, scale, block_impl, window)
    qg, kg, vg = (collectives.alltoall_rank_major(t, split_axis=2,
                                                  concat_axis=1)
                  for t in (q, k, v))
    o = _full_attention(qg, kg, vg, causal, scale, block_impl, window)
    return collectives.alltoall_rank_major(o, split_axis=1, concat_axis=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Single-device full attention (the oracle of the flash kernels and of
    the parallel variants, JAX :309).

    q ``[B, T, H, D]``; k, v ``[B, T, H_kv, D]`` where ``H_kv`` divides
    ``H`` (GQA): each kv head serves ``H // H_kv`` consecutive q heads, the
    ``jnp.repeat`` layout.  Masked scores are -inf and go through softmax
    as they do in the JAX oracle."""
    from ..ops.flash import _check_window, _gqa_group

    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if window is not None:
        _check_window(window, causal)
    if k.shape[2] != H:
        g = _gqa_group(H, k.shape[2])
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(~causal_window_mask(pos, pos, window)[None, None],
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
