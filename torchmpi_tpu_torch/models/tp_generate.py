"""Tensor-parallel decoding: prefill, steps and the slot pool of the
Megatron stack.

The PyTorch counterpart of ``torchmpi_tpu/models/tp_generate.py``.  The
layers are those of tensor-parallel training (:mod:`..parallel.tensor`):
the attention heads and the MLP's features shard over ``axis``, each
sublayer ends in the g allreduce (on ``backend="pallas"`` the ring
kernels), and the column-parallel LM head's vocabulary slices are
re-joined by an all-gather on the stock route (JAX's ``lax.all_gather``).
The KV cache is head-local: each rank caches only its own heads.

The tree (:func:`init_tp_lm`, JAX :41) is JAX's, in its ``x @ w`` layout:
``embed`` [V, D], ``blocks`` (``ln1`` / ``ln2`` (scale, bias), ``wq`` /
``wk`` / ``wv`` [D, H * dh], ``wo`` [H * dh, D], ``w1`` [D, 4D], ``w2``
[4D, D]), ``ln_f`` and the untied ``head`` [D, V];
``weights.from_numpy_tree`` carries a JAX tree across.  Two forms, as the
training layers:

- the process world: :func:`shard_tp_lm` gives this rank's shard
  (``wq`` / ``wk`` / ``wv`` / ``w1`` / ``head`` column blocks, ``wo`` /
  ``w2`` row blocks, the rest whole) for ``axis`` of the current
  communicator, and the decoders run on it (:func:`tp_generate`,
  :func:`tp_beam_search`, :func:`tp_slot_prefill`,
  :func:`tp_slot_decode`);
- rank-major (``*_rank_major``): :func:`shard_tp_lm_rank_major` stacks
  every rank's shard [n, ...] (the replicated leaves once a rank), and
  the decoders run every rank at once on one device, the products one
  batched ``torch.bmm`` over the ranks and the allreduces
  ``collectives.allreduce_rank_major``.

Inside, both forms carry a leading stack dim (1 in the process world), so
one code path serves them.  Every cache write goes through
``generate.clamp_slot_positions`` (ROADMAP queue C note 1), and every
token through the counter-based sampler of :mod:`.generate` (queue C note
2): token i of a row draws from (its seed, i), as ``generate`` and the
dense serving engine draw it, so a TP replica's sampled streams are the
dense replica's in distribution and bitwise across slot layouts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import _tree, collectives
from ..parallel import tensor as tp
from .generate import _beam_backtrack, _beam_expand, _check_sampling, \
    _row_seeds, _sample, _sample_keys, _sample_rows, _top_k, \
    clamp_slot_positions, graphed, greedy_sampling, to_device
from .layers import check_device
from .transformer import KVCache, apply_rope

COL, ROW, REP = "col", "row", "rep"


def init_tp_lm(generator: Optional[torch.Generator] = None, *, vocab: int,
               embed: int, depth: int, num_heads: int,
               head_dim: Optional[int] = None, mlp_ratio: int = 4,
               dtype: torch.dtype = torch.float32, device="cuda"):
    """The full (unsharded) tree of the TP decode stack (JAX :41): each
    dense weight a unit normal over sqrt(fan in), norms ones and zeros,
    drawn from ``generator`` (seeded 0 when None) on ``device`` in the
    order embed, head, then each block's wq, wk, wv, wo, w1, w2."""
    device = check_device(device)
    g = generator or torch.Generator(device).manual_seed(0)
    D, hd = embed, head_dim or embed // num_heads
    width, hidden = num_heads * hd, mlp_ratio * embed

    def dense(din, dout):
        return (torch.randn(din, dout, generator=g, device=device)
                / math.sqrt(din)).to(dtype)

    def norm():
        return (torch.ones(D, dtype=dtype, device=device),
                torch.zeros(D, dtype=dtype, device=device))

    emb, head = dense(vocab, D), dense(D, vocab)
    blocks = [{"ln1": norm(), "ln2": norm(),
               "wq": dense(D, width), "wk": dense(D, width),
               "wv": dense(D, width), "wo": dense(width, D),
               "w1": dense(D, hidden), "w2": dense(hidden, D)}
              for _ in range(depth)]
    return {"embed": emb, "blocks": blocks, "ln_f": norm(), "head": head}


def _tp_specs(depth: int):
    """Each leaf's placement (JAX :74): column-sharded, row-sharded or
    replicated."""
    return {"embed": REP,
            "blocks": [{"ln1": (REP, REP), "ln2": (REP, REP), "wq": COL,
                        "wk": COL, "wv": COL, "wo": ROW, "w1": COL,
                        "w2": ROW} for _ in range(depth)],
            "ln_f": (REP, REP), "head": COL}


def _shard(params, n: int, index: int):
    def cut(spec, a):
        if spec == COL:
            return tp.shard_columns(a, None, n, index)
        if spec == ROW:
            return tp.shard_rows(a, None, n, index)
        return a

    specs = _tp_specs(len(params["blocks"]))
    return {"embed": cut(REP, params["embed"]),
            "blocks": [{k: (tuple(cut(s, a) for s, a in zip(sp[k], p[k]))
                            if isinstance(p[k], tuple) else cut(sp[k], p[k]))
                        for k in p}
                       for sp, p in zip(specs["blocks"], params["blocks"])],
            "ln_f": params["ln_f"], "head": cut(COL, params["head"])}


def shard_tp_lm(params, axis):
    """This rank's shard of a full tree for ``axis`` of the current
    communicator (JAX :89, the process world): qkv, w1 and the head
    column-sharded, wo and w2 row-sharded by this rank's index along
    ``axis``, the embedding and norms whole.  Returns ``(shard, specs)``,
    the placement of each leaf beside it."""
    n, i = collectives.axis_size(axis), collectives.axis_index(axis)
    return _tree.map(torch.Tensor.contiguous, _shard(params, n, i)), \
        _tp_specs(len(params["blocks"]))


def _groups(n: int, axis) -> torch.Tensor:
    """The ranks of each group of ``axis`` on the current communicator's
    stack of ``n`` ranks: [groups, members], members in axis order."""
    return collectives._axis_view(
        torch.arange(n)[:, None],
        collectives._world_axes("tp_generate", axis))[..., 0]


def axis_indices(n: int, axis) -> torch.Tensor:
    """Each rank's index along ``axis`` on the current communicator's
    stack of ``n`` ranks: a [n] tensor."""
    v = _groups(n, axis)
    idx = torch.empty(n, dtype=torch.long)
    idx[v.reshape(-1)] = torch.arange(v.shape[1]).repeat(v.shape[0])
    return idx


def shard_tp_lm_rank_major(params, n: int, axis):
    """Every rank's shard of a full tree, stacked [n, ...] in rank order
    (the rank-major form of :func:`shard_tp_lm`; a replicated leaf is one
    copy a rank, as the process world holds it).  Returns ``(stacks,
    specs)``."""
    idx = axis_indices(int(n), axis).tolist()
    m = collectives.axis_size(axis, n=int(n))
    shards = [_shard(params, m, i) for i in idx]
    leaves = [_tree.flatten(s)[0] for s in shards]
    td = _tree.flatten(shards[0])[1]
    return _tree.unflatten(td, [torch.stack(ls) for ls in zip(*leaves)]), \
        _tp_specs(len(params["blocks"]))


class _Form:
    """One decode's form: the process world (``n`` None: this rank's
    tensors, a leading stack dim of 1 added inside) or rank-major stacks
    of ``n``.  ``backend`` routes the g allreduces."""

    def __init__(self, axis, n: Optional[int], backend: Optional[str]):
        self.axis, self.n, self.backend = axis, n, backend
        self.size = collectives.axis_size(axis, n=n)
        if n is not None:
            g0 = _groups(n, axis)[0].tolist()  # the first group's ranks
            # A slice where the group is a run of ranks; else an index
            # tensor, made at the first call (before any graph capture:
            # a host list would copy to the card inside it).
            run = g0 == list(range(g0[0], g0[0] + len(g0)))
            self._group0 = slice(g0[0], g0[0] + len(g0)) if run else g0

    def stacks(self, params):
        """The parameter stacks [R, ...] the decode runs on."""
        if self.n is not None:
            return params
        return _tree.map(lambda a: a[None], params)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel sum over the axis (``tensor``'s g) of x [R,
        ..., D], summed feature-major ([R, D, rows]).  A ring folds each
        element in the order of the ring chunk that holds it, and a chunk
        spans a fixed share of the flat buffer: feature-major, an element's
        chunk is a function of its feature alone whenever the buffer needs
        no padding (rows * D a multiple of the ranks' tiles, as every pool
        of an even slot count gives), so a slot's sums do not depend on how
        many slots or tokens the forward carries."""
        shape = x.shape
        xt = x.reshape(shape[0], -1, shape[-1]).transpose(1, 2).contiguous()
        if self.n is None:
            s = tp.g_allreduce(xt[0], self.axis, self.backend)[None]
        else:
            s = tp.g_allreduce_rank_major(xt, self.axis, self.backend)
        return s.transpose(1, 2).reshape(shape)

    def logits(self, x_last: torch.Tensor, head: torch.Tensor
               ) -> torch.Tensor:
        """[R, B, D] -> the whole [B, V]: this rank's (the first group's)
        vocabulary slices re-joined in axis order, JAX's tiled
        ``lax.all_gather`` (the stock route: no ring kernel)."""
        ll = _bmm(x_last, head)
        if self.n is None:
            st = collectives.allgather_in_axis(ll[0].contiguous(), self.axis,
                                               backend="xla")
        else:
            if isinstance(self._group0, list):
                self._group0 = torch.tensor(self._group0, device=ll.device)
            st = ll[self._group0]
        return st.permute(1, 0, 2).reshape(st.shape[1], -1)


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of every rank: x [R, ..., din], w [R, din, dout]."""
    R = w.shape[0]
    y = torch.bmm(x.reshape(R, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _per_rank(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A rank's parameter [R, d] broadcast against x [R, ..., d]."""
    return p.reshape(p.shape[0], *([1] * (x.dim() - 2)), p.shape[-1])


def _ln(h, scale, bias):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-6) * _per_rank(scale, h) \
        + _per_rank(bias, h)


def _heads(form, num_heads: int, width: int):
    n = form.size
    if num_heads % n:
        raise ValueError(f"num_heads {num_heads} must divide by the "
                         f"model-axis size {n}")
    hl = num_heads // n
    return hl, width // hl


def _qkv(form, h, p, num_heads: int, pos: torch.Tensor):
    """This rank's heads of h [R, B, T, D], rotated by ``pos`` ([T], or
    [B, T] per row): q, k, v [R * B, T, hl, dh] (JAX ``_qkv_local``)."""
    R, B, T, _ = h.shape
    hl, dh = _heads(form, num_heads, p["wq"].shape[-1])
    q, k, v = (_bmm(h, p[w]).reshape(R * B, T, hl, dh)
               for w in ("wq", "wk", "wv"))
    if pos.dim() == 2:
        pos = pos.repeat(R, 1)
    return apply_rope(q, pos), apply_rope(k, pos), v, dh


def _attend(form, x, p, probs_v):
    """The attention output's row product and sum, then the MLP (one
    allreduce each; JAX's ``row_parallel_dense`` and ``tp_mlp`` with
    ``jax.nn.gelu``'s tanh form)."""
    ctx = probs_v.reshape(*x.shape[:-1], -1)
    x = x + form.g(_bmm(ctx, p["wo"]))
    h = _ln(x, *p["ln2"])
    return x + form.g(_bmm(F.gelu(_bmm(h, p["w1"]),
                                     approximate="tanh"), p["w2"]))


def _block_prefill(form, x, p, num_heads: int, t_max: int):
    """Causal attention over the whole prompt (dense scores; JAX :136):
    the block's output and its head-local k, v padded to ``t_max``, [R, B,
    t_max, hl, dh]."""
    R, B, T, _ = x.shape
    h = _ln(x, *p["ln1"])
    q, k, v, dh = _qkv(form, h, p, num_heads,
                       torch.arange(T, device=x.device))
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs, v)
    out = _attend(form, x, p, ctx)
    pad = (0, 0, 0, 0, 0, t_max - T)
    return out, (F.pad(k, pad).view(R, B, t_max, *k.shape[2:]),
                 F.pad(v, pad).view(R, B, t_max, *v.shape[2:]))


def _block_decode(form, x, p, ck, cv, pos_rows, num_heads: int):
    """Each row's T tokens at its own depth (JAX ``_block_decode_rows``
    :183): x [R, S, T, D] writes its head-local k, v at ``pos_rows[s]`` on
    (in place, into ck, cv [R, S, t_max, hl, dh]) and attends its causal
    prefix of the cache; a retired slot's stale rows mask out."""
    R, S, T, _ = x.shape
    t_max = ck.shape[2]
    pos_rows = clamp_slot_positions(pos_rows, t_max, T)
    q_pos = pos_rows[:, None] + torch.arange(T, device=x.device)  # [S, T]
    h = _ln(x, *p["ln1"])
    q, k1, v1, dh = _qkv(form, h, p, num_heads, q_pos)
    rows = torch.arange(S, device=x.device)[:, None]
    ck[:, rows, q_pos] = k1.view(R, S, T, *k1.shape[2:])
    cv[:, rows, q_pos] = v1.view(R, S, T, *v1.shape[2:])
    kf, vf = ck.view(R * S, t_max, *ck.shape[3:]), \
        cv.view(R * S, t_max, *cv.shape[3:])
    s = torch.einsum("bthd,bshd->bhts", q, kf) / math.sqrt(dh)
    valid = torch.arange(t_max, device=x.device) <= q_pos[:, :, None]
    s = s.masked_fill(~valid.repeat(R, 1, 1)[:, None],
                      torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), dim=-1).to(x.dtype)
    return _attend(form, x, p, torch.einsum("bhts,bshd->bthd", probs, vf))


class _Stack:
    """A sharded tree on its form, with its head count: what every decoder
    below runs on."""

    def __init__(self, params, form: _Form, num_heads: int):
        self.form, self.num_heads = form, int(num_heads)
        self.p = form.stacks(params)
        self.depth = len(self.p["blocks"])
        self.hl, self.dh = _heads(form, self.num_heads,
                                  self.p["blocks"][0]["wq"].shape[-1])

    @property
    def device(self) -> torch.device:
        return self.p["head"].device

    def embed(self, tok: torch.Tensor) -> torch.Tensor:
        """Every rank's embedding rows of ``tok``: [R, *tok.shape, D]."""
        return self.p["embed"][:, tok.long()]

    def prefill(self, prompt: torch.Tensor, t_max: int,
                cache: Optional[KVCache] = None):
        """Every block's prefill of ``prompt`` [B, T]: (the last block's
        output [R, B, T, D], the cache of ``t_max`` positions: ``cache``,
        written in place, when given)."""
        x = self.embed(prompt)
        ks, vs = [], []
        for p in self.p["blocks"]:
            x, (k, v) = _block_prefill(self.form, x, p, self.num_heads,
                                       t_max)
            ks.append(k)
            vs.append(v)
        if cache is None:
            return x, KVCache(ks, vs, lead=1)
        for dst, src in zip(cache.k + cache.v, ks + vs):
            dst.copy_(src)
        return x, cache

    def decode(self, cache: KVCache, tokens: torch.Tensor,
               pos_rows: torch.Tensor) -> torch.Tensor:
        """One forward of ``tokens`` [S, T], row s from depth
        ``pos_rows[s]``, writing into ``cache``: [R, S, T, D]."""
        x = self.embed(tokens)
        for p, ck, cv in zip(self.p["blocks"], cache.k, cache.v):
            x = _block_decode(self.form, x, p, ck, cv, pos_rows,
                              self.num_heads)
        return x

    def logits(self, x_last: torch.Tensor) -> torch.Tensor:
        """[R, B, D] -> [B, V]: the final norm, the head, the re-join."""
        return self.form.logits(_ln(x_last, *self.p["ln_f"]),
                                self.p["head"])

    def zero_cache(self, rows: int, t_max: int) -> KVCache:
        """A zero head-local cache [R, rows, t_max, hl, dh] a layer."""
        shape = (self.p["head"].shape[0], int(rows), int(t_max), self.hl,
                 self.dh)
        dt = self.p["embed"].dtype
        return KVCache([torch.zeros(shape, dtype=dt, device=self.device)
                        for _ in range(self.depth)],
                       [torch.zeros(shape, dtype=dt, device=self.device)
                        for _ in range(self.depth)], lead=1)


def _tokens(device, prompt) -> torch.Tensor:
    """A token array as a tensor on ``device`` (no host sync)."""
    if torch.is_tensor(prompt):
        return prompt.to(device)
    return to_device(np.asarray(prompt), device)


def _generate(st: _Stack, prompt, steps: int, *, temperature: float,
              top_k, top_p, eos_id, seed) -> torch.Tensor:
    """JAX ``_tp_generate_body`` (:229): the prefill fills the caches in
    one causal pass, then one token a step (rank-major on the card, one
    CUDA graph replay); EOS rows freeze to ``eos_id``; row b draws token i
    from (its seed, i)."""
    prompt = _tokens(st.device, prompt)
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be [batch, time], got "
                         f"{tuple(prompt.shape)}")
    if steps <= 0:
        return prompt
    _check_sampling(top_k, top_p)
    B, Tp = prompt.shape
    seeds = _row_seeds(seed, B, prompt.device)

    def sample(logits, idx):
        return _sample(logits, _sample_keys(seeds, idx), temperature, top_k,
                       top_p).to(prompt.dtype)

    cache = st.zero_cache(B, Tp + steps)

    def step(tok, pos):
        """Token ``pos - Tp + 1`` of every row from its input ``tok``."""
        x = st.decode(cache, tok[:, None], pos)
        return sample(st.logits(x[:, :, 0]), pos - (Tp - 1))

    pos = torch.full_like(seeds, Tp)
    if steps > 1 and st.form.n is not None:
        # Rank-major on the card: one CUDA graph a step, captured before
        # the prefill writes the cache (the capture's warm-up writes it).
        from ..ops import ring

        step = graphed(step, prompt[:, 0], pos,
                       counters=(ring.LAUNCHES, ring.VECTOR_LAUNCHES))
    x, _ = st.prefill(prompt, Tp + steps, cache)
    tok = sample(st.logits(x[:, :, -1]), pos - Tp)
    out = [prompt, tok[:, None]]
    done = tok == eos_id if eos_id is not None else None
    for i in range(1, steps):
        tok = step(tok, pos + (i - 1)).clone()
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _beam(st: _Stack, prompt, steps: int, *, beams: int, eos_id,
          length_penalty: float) -> torch.Tensor:
    """JAX ``_tp_beam_body`` (:281): prefill on B rows, the head-local
    caches tiled to B * K beam rows, the dense beam's bookkeeping; the
    parent gather is a local gather of every rank's cache rows."""
    prompt = _tokens(st.device, prompt)
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be [batch, time], got "
                         f"{tuple(prompt.shape)}")
    if steps <= 0:
        return prompt
    if beams < 1:
        raise ValueError(f"beams must be >= 1, got {beams}")
    V = st.p["embed"].shape[1]
    if beams > V:
        raise ValueError(f"beams {beams} exceeds vocab {V}")
    B, Tp = prompt.shape
    K = int(beams)
    x, cache = st.prefill(prompt, Tp + steps)
    lp0 = torch.log_softmax(st.logits(x[:, :, -1]).float(), dim=-1)
    lp, top_tok = _top_k(lp0, K)
    top_tok = top_tok.to(prompt.dtype)
    if steps == 1:
        return torch.cat([prompt, top_tok[:, :1]], dim=1)
    cache = cache.index_rows(torch.arange(B, device=prompt.device)
                             .repeat_interleave(K))
    fin = (top_tok == eos_id if eos_id is not None
           else torch.zeros_like(top_tok, dtype=torch.bool))
    ln = torch.ones_like(top_tok, dtype=torch.long)
    tok, toks, parents = top_tok, [], []
    base = torch.arange(B, device=prompt.device)[:, None] * K
    pos = torch.full((B * K,), Tp, dtype=torch.long, device=prompt.device)
    for i in range(steps - 1):
        x = st.decode(cache, tok.reshape(B * K, 1), pos + i)
        step_lp = torch.log_softmax(st.logits(x[:, :, 0]).float(),
                                    dim=-1).reshape(B, K, -1)
        lp, tok, fin, ln, parent = _beam_expand(lp, fin, ln, step_lp,
                                                eos_id)
        tok = tok.to(prompt.dtype)
        cache = cache.index_rows((base + parent).reshape(-1))
        toks.append(tok)
        parents.append(parent)
    return _beam_backtrack(prompt, top_tok, toks, parents, lp, ln,
                           length_penalty)


def _slot_prefill(st: _Stack, prompt: torch.Tensor, t_max: int,
                  true_len: Optional[int] = None, sampling=None):
    """JAX ``_tp_slot_prefill_body`` (:411): one request's [1, Tp] prompt
    (maybe right-padded to a bucket) on a fresh cache of ``t_max``
    positions, the token sampled at the true last position.  Returns
    ``(cache, first [1])``."""
    if true_len is None:
        true_len = prompt.shape[1]
    if sampling is None:
        sampling = greedy_sampling(prompt.shape[0], prompt.device)
    x, cache = st.prefill(prompt, t_max)
    t = clamp_slot_positions(int(true_len) - 1, x.shape[2])
    return cache, _sample_rows(st.logits(x[:, :, t]), *sampling)


def _slot_decode(st: _Stack, cache: KVCache, tokens: torch.Tensor,
                 positions: torch.Tensor, sampling=None):
    """JAX ``_tp_slot_step_body`` (:430): one pooled forward of ``tokens``
    [S, T] (T 1 for the continuous-batching step, K + 1 for the
    speculative verify) at per-slot depths ``positions`` [S]; position j
    of row s samples with (seed_s, idx_s + j).  Returns ``(cache, samples
    [S, T])``."""
    S, T = tokens.shape
    if sampling is None:
        sampling = greedy_sampling(S, tokens.device)
    seeds, idxs, temps, top_ks, top_ps = sampling
    x = st.decode(cache, tokens, positions)
    logits = st.logits(x.reshape(x.shape[0], S * T, -1))
    j = torch.arange(T, device=tokens.device)
    flat = _sample_rows(
        logits, seeds.repeat_interleave(T), (idxs[:, None] + j).reshape(-1),
        temps.repeat_interleave(T), top_ks.repeat_interleave(T),
        top_ps.repeat_interleave(T))
    return cache, flat.reshape(S, T)


# ---------------------------------------------------------------------------
# The entry points, in the process world and rank-major
# ---------------------------------------------------------------------------


def _process_world(params, axis, num_heads, backend, sharded) -> _Stack:
    placed = sharded[0] if sharded is not None else \
        shard_tp_lm(params, axis)[0]
    return _Stack(placed, _Form(axis, None, backend), num_heads)


def _rank_major(params, n, axis, num_heads, backend, sharded) -> _Stack:
    if sharded is not None:
        placed = sharded[0]
        n = placed["head"].shape[0]
    else:
        if n is None:
            raise ValueError("tp rank-major: pass n (the stack's ranks) or "
                             "sharded=shard_tp_lm_rank_major(...)")
        placed = shard_tp_lm_rank_major(params, n, axis)[0]
    return _Stack(placed, _Form(axis, int(n), backend), num_heads)


@torch.no_grad()
def tp_generate(params, prompt, steps: int, *, axis, num_heads: int,
                temperature: float = 0.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None, eos_id: Optional[int] = None,
                seed: Union[int, Sequence[int]] = 0,
                backend: Optional[str] = None,
                sharded=None) -> torch.Tensor:
    """Tensor-parallel generation over ``axis`` of the current
    communicator, this rank's shard (JAX :545).  ``params`` is the full
    tree (sharded here), or pass ``sharded=shard_tp_lm(...)`` to reuse a
    placement.  Returns the [B, Tp + steps] tokens on every rank: greedy
    at ``temperature=0``, else Gumbel-max sampling with the filters, row b
    drawing token i from (seed + b, i) as :func:`.generate.generate`
    does; ``eos_id`` freezes a row.  ``backend`` routes the sublayers'
    allreduces (None: the Config's)."""
    st = _process_world(params, axis, num_heads, backend, sharded)
    return _generate(st, prompt, steps, temperature=temperature,
                     top_k=top_k, top_p=top_p, eos_id=eos_id, seed=seed)


@torch.no_grad()
def tp_generate_rank_major(params, prompt, steps: int, *, axis,
                           num_heads: int, n: Optional[int] = None,
                           temperature: float = 0.0,
                           top_k: Optional[int] = None,
                           top_p: Optional[float] = None,
                           eos_id: Optional[int] = None,
                           seed: Union[int, Sequence[int]] = 0,
                           backend: Optional[str] = None,
                           sharded=None) -> torch.Tensor:
    """:func:`tp_generate` for the ``n`` ranks of the current
    communicator on one device (their shards stacked by
    :func:`shard_tp_lm_rank_major`; ``backend="pallas"`` sums on the ring
    kernels).  Returns [B, Tp + steps]."""
    st = _rank_major(params, n, axis, num_heads, backend, sharded)
    return _generate(st, prompt, steps, temperature=temperature,
                     top_k=top_k, top_p=top_p, eos_id=eos_id, seed=seed)


@torch.no_grad()
def tp_beam_search(params, prompt, steps: int, *, axis, num_heads: int,
                   beams: int, eos_id: Optional[int] = None,
                   length_penalty: float = 0.0,
                   backend: Optional[str] = None,
                   sharded=None) -> torch.Tensor:
    """Beam search on the tensor-parallel stack (JAX :346), the semantics
    of :func:`.generate.beam_search`, weights and caches sharded over
    ``axis``."""
    st = _process_world(params, axis, num_heads, backend, sharded)
    return _beam(st, prompt, steps, beams=beams, eos_id=eos_id,
                 length_penalty=length_penalty)


@torch.no_grad()
def tp_beam_search_rank_major(params, prompt, steps: int, *, axis,
                              num_heads: int, beams: int,
                              n: Optional[int] = None,
                              eos_id: Optional[int] = None,
                              length_penalty: float = 0.0,
                              backend: Optional[str] = None,
                              sharded=None) -> torch.Tensor:
    """:func:`tp_beam_search` for ``n`` ranks on one device."""
    st = _rank_major(params, n, axis, num_heads, backend, sharded)
    return _beam(st, prompt, steps, beams=beams, eos_id=eos_id,
                 length_penalty=length_penalty)


@torch.no_grad()
def tp_slot_prefill(placed, prompt, *, axis, num_heads: int, t_max: int,
                    true_len: Optional[int] = None, sampling=None,
                    backend: Optional[str] = None):
    """Prefill one request on a fresh head-local cache of ``t_max``
    positions (JAX :487); ``placed`` this rank's shard
    (:func:`shard_tp_lm`).  Returns ``(cache, first [1])``, the cache
    ready for ``generate.slot_write`` into a pool."""
    st = _Stack(placed, _Form(axis, None, backend), num_heads)
    return _slot_prefill(st, _tokens(st.device, prompt), t_max, true_len,
                         sampling)


@torch.no_grad()
def tp_slot_prefill_rank_major(stacks, prompt, *, axis, num_heads: int,
                               t_max: int, true_len: Optional[int] = None,
                               sampling=None,
                               backend: Optional[str] = None):
    """:func:`tp_slot_prefill` on rank-major ``stacks``."""
    st = _Stack(stacks, _Form(axis, stacks["head"].shape[0], backend),
                num_heads)
    return _slot_prefill(st, _tokens(st.device, prompt), t_max, true_len,
                         sampling)


@torch.no_grad()
def tp_slot_decode(placed, cache: KVCache, tokens, positions, *, axis,
                   num_heads: int, sampling=None,
                   backend: Optional[str] = None):
    """One pooled decode or verify forward (JAX :505): ``tokens`` [S, T],
    ``positions`` [S] per-slot depths.  Returns ``(cache, samples [S,
    T])``."""
    st = _Stack(placed, _Form(axis, None, backend), num_heads)
    return _slot_decode(st, cache, _tokens(st.device, tokens),
                        torch.as_tensor(positions, device=st.device),
                        sampling)


@torch.no_grad()
def tp_slot_decode_rank_major(stacks, cache: KVCache, tokens, positions, *,
                              axis, num_heads: int, sampling=None,
                              backend: Optional[str] = None):
    """:func:`tp_slot_decode` on rank-major ``stacks``."""
    st = _Stack(stacks, _Form(axis, stacks["head"].shape[0], backend),
                num_heads)
    return _slot_decode(st, cache, _tokens(st.device, tokens),
                        torch.as_tensor(positions, device=st.device),
                        sampling)


def clear_serving_caches() -> None:
    """JAX :519 drops the serving modules' compiled executables.  The port
    compiles nothing per shape (its decoders run eagerly; a serving
    engine's CUDA graph lives and dies with the engine), so there is
    nothing to drop: kept for the JAX package's API."""
