"""Pipeline-parallel decoding: the round-robin micro-group schedule over a
stage axis.

The PyTorch counterpart of ``torchmpi_tpu/models/pp_generate.py``.  The
layers of an :func:`.tp_generate.init_tp_lm` tree split into S contiguous
stages over ``axis`` (each rank holds 1/S of the blocks and of the KV
cache) and the batch into S micro-groups that rotate through them:

    tick t, stage s: micro-group (t - s) mod S at token k = (t - s) // S.

Every stage works on a different group's current token each tick.  One
wraparound shift a tick carries (activation, sampled token): stage s's
activation to s + 1, and the last stage's token back to stage 0, which
embeds it one tick later.  Prefill is teacher-forced through the same
loop (stage 0 reads ``prompt[g, k]`` while k < Tp), so prefill and decode
are one loop of ``S * (Tp + steps)`` ticks (JAX ``_pp_generate_body``
:112).  The last stage's output buffer holds the tokens (JAX sums it over
the axis, :221).

Sampling key: token ``col`` of batch row b draws from (seed + b, col),
the key :func:`.generate.generate` gives it, so the PP schedule's sampled
streams are the dense decoder's up to the logits' rounding (JAX's schedule
folds its key by (group, k) instead, ``pp_generate.py:195``).  Greedy
decoding equals the dense oracle's.  No beam search on PP, as in JAX: use
:func:`.tp_generate.tp_beam_search`.

Two forms: over ``axis`` of the process world (this rank's stage,
:func:`shard_pp_lm`; the hop ``collectives.shift_in_axis``, the final sum
the stock allreduce), and rank-major (``*_rank_major``: every stage's
layers stacked [n, L / S, ...]; the hop an index roll within each group of
the axis).  Inside, both carry a leading stack dim (1 in the process
world).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from .. import _tree, collectives
from .generate import _check_sampling, _row_seeds, _sample, _sample_keys
from .tp_generate import _bmm, _ln, _tokens, axis_indices
from .transformer import apply_rope


def _stack_blocks(blocks):
    """[L] list of per-layer dicts -> one tree with a leading layer dim
    (JAX :67)."""
    leaves = [_tree.flatten(b)[0] for b in blocks]
    td = _tree.flatten(blocks[0])[1]
    return _tree.unflatten(td, [torch.stack(ls) for ls in zip(*leaves)])


def _aux(params):
    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "head": params["head"]}


def _check_depth(depth: int, S: int) -> int:
    if depth % S:
        raise ValueError(f"depth {depth} must divide by the stage-axis "
                         f"size {S}")
    return depth // S


def shard_pp_lm(params, axis):
    """This rank's stage of a full tree (JAX :239, the process world):
    its ``L / S`` contiguous blocks stacked [L / S, ...], and ``aux`` (the
    embedding, ``ln_f`` and the head, whole).  Returns ``(blocks,
    aux)``."""
    S, s = collectives.axis_size(axis), collectives.axis_index(axis)
    per = _check_depth(len(params["blocks"]), S)
    return _stack_blocks(params["blocks"][s * per:(s + 1) * per]), \
        _aux(params)


def shard_pp_lm_rank_major(params, n: int, axis):
    """Every rank's stage, stacked: blocks [n, L / S, ...], aux leaves [n,
    ...] (one copy a rank)."""
    idx = axis_indices(int(n), axis).tolist()
    S = collectives.axis_size(axis, n=int(n))
    per = _check_depth(len(params["blocks"]), S)
    stages = [_stack_blocks(params["blocks"][s * per:(s + 1) * per])
              for s in idx]
    aux = _aux(params)
    return (_stack_blocks(stages),
            _tree.map(lambda a: a.expand(int(n), *a.shape).contiguous(),
                      aux))


class _Stages:
    """The stage stacks [R, ...] of one schedule and the hop: rank-major
    (``n`` ranks, the roll within each group of ``axis``) or the process
    world (R 1, ``collectives.shift_in_axis``)."""

    def __init__(self, blocks, aux, axis, n: Optional[int], device):
        self.axis, self.n = axis, n
        if n is None:
            blocks = _tree.map(lambda a: a[None], blocks)
            aux = _tree.map(lambda a: a[None], aux)
            self.S = collectives.axis_size(axis)
            self.s_idx = torch.tensor([collectives.axis_index(axis)],
                                      device=device)
        else:
            self.S = collectives.axis_size(axis, n=n)
            self.s_idx = axis_indices(n, axis).to(device)
            self.world_axis = collectives._world_axes("pp_generate", axis)
        self.blocks, self.aux = blocks, aux
        self.R = self.s_idx.numel()

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Each stage's ``x`` to the next stage, the last's to stage 0."""
        if self.n is None:
            return collectives.shift_in_axis(x[0].contiguous(), self.axis,
                                             wrap=True)[None]
        v = collectives._axis_view(x, self.world_axis)
        return collectives._from_axis_view(torch.roll(v, 1, dims=1),
                                           self.world_axis)

    def last_out(self, outbuf: torch.Tensor) -> torch.Tensor:
        """The last stage's buffer, on every rank (JAX's ``psum`` of the
        masked buffers; the stock route across processes)."""
        is_last = (self.s_idx == self.S - 1)[:, None, None]
        masked = torch.where(is_last, outbuf, 0)
        if self.n is None:
            return collectives.allreduce_in_axis(masked[0].contiguous(),
                                                 self.axis, backend="xla")
        return masked[int(torch.nonzero(is_last[:, 0, 0])[0])]


def _layer_decode(x, p, ck, cv, ri, bi, pos, valid):
    """One layer for every rank's micro-group token (JAX ``_layer_decode``
    :73): x [R, Bg, D]; ck, cv [R, B, t_max, H, dh] this layer's caches
    (the full batch); ``bi`` [R, Bg] the group's rows, ``pos`` [R] the
    token position.  A masked tick (``valid`` False) writes the row's old
    entry back.  Returns the layer's output."""
    R, Bg, D = x.shape
    t_max, H, dh = ck.shape[2:]
    h = _ln(x, *p["ln1"])
    q, k1, v1 = (_bmm(h, p[w]).reshape(R * Bg, 1, H, dh)
                 for w in ("wq", "wk", "wv"))
    posv = pos.repeat_interleave(Bg)[:, None]
    q = apply_rope(q, posv).view(R, Bg, H, dh)
    k1 = apply_rope(k1, posv).view(R, Bg, H, dh)
    v1 = v1.view(R, Bg, H, dh)
    pi = pos[:, None].expand(R, Bg)
    keep = valid[:, None, None, None]
    ck[ri, bi, pi] = torch.where(keep, k1, ck[ri, bi, pi])
    cv[ri, bi, pi] = torch.where(keep, v1, cv[ri, bi, pi])
    ck_g, cv_g = ck[ri, bi], cv[ri, bi]  # [R, Bg, t_max, H, dh]
    s = torch.einsum("rbhd,rbshd->rbhs", q, ck_g) / math.sqrt(dh)
    live = torch.arange(t_max, device=x.device) <= pos[:, None]
    s = s.masked_fill(~live[:, None, None], torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("rbhs,rbshd->rbhd", probs, cv_g).reshape(R, Bg, -1)
    x = x + _bmm(ctx, p["wo"])
    h2 = _ln(x, *p["ln2"])
    return x + _bmm(F.gelu(_bmm(h2, p["w1"]), approximate="tanh"), p["w2"])


def _pp_generate(st: _Stages, prompt: torch.Tensor, steps: int, *,
                 num_heads: int, temperature: float, top_k, top_p, eos_id,
                 seed) -> torch.Tensor:
    S, R = st.S, st.R
    B, Tp = prompt.shape
    if B % S:
        raise ValueError(f"batch {B} must divide by the stage-axis size "
                         f"{S}")
    Bg = B // S
    dev = prompt.device
    L = st.blocks["wq"].shape[1]
    H = num_heads
    dh = st.blocks["wq"].shape[-1] // H
    dt = torch.result_type(st.aux["embed"], st.blocks["wq"])
    t_max = Tp + steps
    caches = [(torch.zeros(R, B, t_max, H, dh, dtype=dt, device=dev),
               torch.zeros(R, B, t_max, H, dh, dtype=dt, device=dev))
              for _ in range(L)]
    layers = [_tree.map(lambda a, li=li: a[:, li], st.blocks)
              for li in range(L)]
    outbuf = torch.zeros(R, B, steps, dtype=prompt.dtype, device=dev)
    done = torch.zeros(R, B, dtype=torch.bool, device=dev)
    x_in = torch.zeros(R, Bg, st.aux["embed"].shape[-1], dtype=dt,
                       device=dev)
    tok_in = torch.zeros(R, Bg, dtype=prompt.dtype, device=dev)
    seeds = _row_seeds(seed, B, dev)
    ri = torch.arange(R, device=dev)[:, None]
    rank = torch.arange(R, device=dev)
    is_first, is_last = st.s_idx == 0, st.s_idx == S - 1
    for t in range(S * (Tp + steps)):
        u = t - st.s_idx
        g = torch.remainder(u, S)
        k = torch.div(u, S, rounding_mode="floor")
        valid = (u >= 0) & (k <= Tp + steps - 2)
        bi = (g * Bg)[:, None] + torch.arange(Bg, device=dev)  # [R, Bg]
        # Stage 0 reads the prompt while k < Tp, then the returned token.
        prom = prompt[bi, torch.clamp(k, 0, Tp - 1)[:, None]]
        tok = torch.where((k < Tp)[:, None], prom, tok_in)
        emb = st.aux["embed"][rank[:, None], tok.long()].to(dt)
        x = torch.where(is_first[:, None, None], emb, x_in)
        pos = torch.clamp(k, 0, t_max - 1)
        for p, (ck, cv) in zip(layers, caches):
            y = _layer_decode(x, p, ck, cv, ri, bi, pos, valid)
            x = torch.where(valid[:, None, None], y, x)
        # The last stage samples position k + 1's token.
        x_last = _ln(x, *st.aux["ln_f"])
        logits = _bmm(x_last, st.aux["head"])
        col = torch.clamp(k + 1 - Tp, 0, steps - 1)
        keys = _sample_keys(seeds[bi].reshape(-1),
                            col.repeat_interleave(Bg))
        nxt = _sample(logits.reshape(R * Bg, -1), keys, temperature, top_k,
                      top_p).to(prompt.dtype).view(R, Bg)
        done_g = done[ri, bi]
        if eos_id is not None:
            nxt = torch.where(done_g, eos_id, nxt)
            done_g = done_g | (nxt == eos_id)
        # Only an emitted token is recorded or may finish its row: during
        # the teacher-forced prefill the prediction is thrown away.
        emit = (valid & is_last & (k + 1 >= Tp))[:, None]
        ci = col[:, None].expand(R, Bg)
        outbuf[ri, bi, ci] = torch.where(emit, nxt, outbuf[ri, bi, ci])
        done[ri, bi] = torch.where(emit, done_g, done[ri, bi])
        x_in = st.shift(torch.where(valid[:, None, None], x, x_in))
        tok_in = st.shift(torch.where((valid & is_last)[:, None], nxt,
                                      tok_in))
    return torch.cat([prompt, st.last_out(outbuf)], dim=1)


def _check(prompt, steps, top_k, top_p, depth, S):
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be [batch, time], got "
                         f"{tuple(prompt.shape)}")
    _check_sampling(top_k, top_p)
    _check_depth(depth, S)
    if prompt.shape[0] % S:
        raise ValueError(f"batch {prompt.shape[0]} must divide by the "
                         f"stage-axis size {S} (micro-groups)")


@torch.no_grad()
def pp_generate(params, prompt, steps: int, *, axis, num_heads: int,
                temperature: float = 0.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None, eos_id: Optional[int] = None,
                seed: Union[int, Sequence[int]] = 0,
                sharded=None) -> torch.Tensor:
    """Pipeline-parallel generation over ``axis`` of the process world
    (JAX :254): this rank runs its stage.  ``params`` the full
    :func:`.tp_generate.init_tp_lm` tree (or ``sharded=shard_pp_lm(...)``
    to reuse a placement); depth and batch must divide by the stage count.
    Returns the [B, Tp + steps] tokens on every rank, with
    :func:`.generate.generate`'s sampling and EOS semantics."""
    blocks, aux = sharded if sharded is not None else \
        shard_pp_lm(params, axis)
    dev = aux["head"].device
    prompt = _tokens(dev, prompt)
    S = collectives.axis_size(axis)
    _check(prompt, steps, top_k, top_p, blocks["wq"].shape[0] * S, S)
    if steps <= 0:
        return prompt
    st = _Stages(blocks, aux, axis, None, dev)
    return _pp_generate(st, prompt, steps, num_heads=num_heads,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        eos_id=eos_id, seed=seed)


@torch.no_grad()
def pp_generate_rank_major(params, prompt, steps: int, *, axis,
                           num_heads: int, n: Optional[int] = None,
                           temperature: float = 0.0,
                           top_k: Optional[int] = None,
                           top_p: Optional[float] = None,
                           eos_id: Optional[int] = None,
                           seed: Union[int, Sequence[int]] = 0,
                           sharded=None) -> torch.Tensor:
    """:func:`pp_generate` for the ``n`` ranks of the current
    communicator on one device: every stage's tick in one batched call,
    the hop an index roll.  Returns [B, Tp + steps]."""
    if sharded is not None:
        blocks, aux = sharded
        n = blocks["wq"].shape[0]
    else:
        if n is None:
            raise ValueError("pp rank-major: pass n (the stack's ranks) or "
                             "sharded=shard_pp_lm_rank_major(...)")
        S = collectives.axis_size(axis, n=int(n))
        _check_depth(len(params["blocks"]), S)
        blocks, aux = shard_pp_lm_rank_major(params, n, axis)
    dev = aux["head"].device
    prompt = _tokens(dev, prompt)
    S = collectives.axis_size(axis, n=int(n))
    _check(prompt, steps, top_k, top_p, blocks["wq"].shape[1] * S, S)
    if steps <= 0:
        return prompt
    st = _Stages(blocks, aux, axis, int(n), dev)
    return _pp_generate(st, prompt, steps, num_heads=num_heads,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        eos_id=eos_id, seed=seed)
