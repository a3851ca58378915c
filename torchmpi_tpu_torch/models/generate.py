"""Autoregressive generation over the KV cache, and the slot primitives of
the continuous-batching server.

The PyTorch counterpart of the single-device half of
``torchmpi_tpu/models/generate.py``: the sampling filters (``_filter_logits``
:42, ``_filter_logits_rows`` :101), :func:`generate` (:433, greedy,
temperature, top-k, top-p, ``eos_id``), :func:`beam_search` (:349),
:func:`clamp_slot_positions` (:546) and the slot primitives
(:func:`slot_prefill` :596, :func:`slot_decode_step` :624,
:func:`slot_verify_step` :661, :func:`slot_write` :699,
:func:`slot_cache_slice` :737, :func:`slot_cache_write` :758,
:func:`slot_extend` :782).  A prefill is one forward over the prompt onto
a fresh cache (``TransformerLM.init_cache``); each later token is one
forward of one token a row, which writes into the cache in place.  The
loops run on the host and never read the device: the caller's read of
the result is the only host sync.

Sampling (ROADMAP queue C note 2).  JAX keys token i of a row on
``fold_in(PRNGKey(seed), i)``, which torch cannot reproduce.  Here a row
draws token i by the Gumbel-max rule from a counter-based stream: a
32-bit integer hash of (seed, i, vocabulary index), computed on the device
with integer tensor ops, gives one uniform per logit, and the token is the
argmax of ``logits / temperature - log(-log(u))``.  A batch samples in a
few launches, with no host sync and no ``torch.Generator``, and a row's
stream depends on (seed, token index) alone: never on the slot, the batch
or the arrival order, which is what keeps a re-routed session
token-exact.  Greedy rows take the argmax of the unfiltered logits.
Greedy decoding matches JAX token for token; sampled decoding matches its
distribution, and bitwise only serving against serving.

Ties: ``lax.top_k`` gives the lower index first; the beams take the top k
of a stable descending sort, which does the same.  The mesh-parallel
decoders (``generate_parallel``, ``beam_search_parallel``, MoE and
Ulysses decode) are ROADMAP queue A, item 9 (b).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _check_sampling(top_k, top_p):
    """Entry-boundary validation: out-of-range knobs would otherwise
    silently degenerate (top_p=0 masks every logit, top_k=0 indexes the
    minimum logit)."""
    if top_k is not None and int(top_k) < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _filter_logits(logits: torch.Tensor, temperature: float,
                   top_k: Optional[int], top_p: Optional[float]
                   ) -> torch.Tensor:
    """Restrict the sampling support of [R, V] logits: ``top_k`` keeps the
    k highest, ``top_p`` the smallest set whose probability mass (at
    ``temperature``, over the top-k support) reaches p; k first, then p.
    One sort serves both; the nucleus cut is a logit threshold."""
    if top_k is None and top_p is None:
        return logits
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    ninf = float("-inf")
    if top_k is not None:
        k = min(int(top_k), V)
        kth = sorted_desc[:, k - 1:k]
        logits = logits.masked_fill(logits < kth, ninf)
        sorted_desc = sorted_desc.masked_fill(
            torch.arange(V, device=logits.device) >= k, ninf)
    if top_p is not None:
        sp = torch.softmax(sorted_desc / max(float(temperature), 1e-6),
                           dim=-1)
        keep = (torch.cumsum(sp, dim=-1) - sp) < top_p
        # The first sorted entry always survives, so the threshold is
        # finite and at least one token remains.
        thresh = torch.where(keep, sorted_desc, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, ninf)
    return logits


def _filter_logits_rows(logits: torch.Tensor, temps: torch.Tensor,
                        top_ks: torch.Tensor, top_ps: torch.Tensor
                        ) -> torch.Tensor:
    """Per-row :func:`_filter_logits`: each row carries its own
    (temperature, top_k, top_p) as [R] tensors, so one pass serves a slot
    pool mixing greedy and sampled requests.  ``top_k <= 0`` means k = V
    and ``top_p >= 2.0`` keeps every entry: a row with both sentinels is
    bitwise the unfiltered row."""
    V = logits.shape[-1]
    ninf = float("-inf")
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_ks <= 0, V, torch.clamp(top_ks, 1, V))
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None].long())
    logits = logits.masked_fill(logits < kth, ninf)
    sorted_desc = sorted_desc.masked_fill(
        torch.arange(V, device=logits.device) >= k[:, None], ninf)
    sp = torch.softmax(sorted_desc / torch.clamp(temps, min=1e-6)[:, None],
                       dim=-1)
    keep = (torch.cumsum(sp, dim=-1) - sp) < top_ps[:, None]
    thresh = torch.where(keep, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, ninf)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32), in 16-bit halves
    so that no product leaves int64's range."""
    lo = (x & 0xFFFF) * m
    hi = ((x >> 16) * (m & 0xFFFF)) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply rounds) on int64
    tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _sample_keys(seeds: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """Per-row 32-bit stream keys of (seed, token index): the counterpart
    of JAX's ``fold_in(PRNGKey(seed), idx)`` (:88).  A key depends on the
    two numbers alone, never on the row's slot, batch or replica."""
    s = seeds.long() & _M32
    return _mix32(_mix32(s) ^ _mul32(idxs.long() & _M32, 0x9E3779B9))


def _gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """[R, V] float32 Gumbel noise, ``-log(-log(u))``, of each row's key:
    u from a hash of (key, vocabulary index), 24 bits, in (0, 1)."""
    j = torch.arange(V, device=keys.device)
    h = _mix32(_mix32(keys[:, None] ^ _mul32(j, 0x85EBCA6B)) ^ 0x5BD1E995)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sample(logits: torch.Tensor, keys: torch.Tensor, temperature: float,
            top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """Filtered greedy or Gumbel-max sampling of [R, V] logits with static
    knobs (:func:`generate`); JAX :74."""
    logits = _filter_logits(logits.float(), temperature, top_k, top_p)
    if temperature > 0.0:
        return torch.argmax(logits / max(float(temperature), 1e-6)
                            + _gumbel(keys, logits.shape[-1]), dim=-1)
    return torch.argmax(logits, dim=-1)


def _sample_rows(logits: torch.Tensor, seeds: torch.Tensor,
                 idxs: torch.Tensor, temps: torch.Tensor,
                 top_ks: torch.Tensor, top_ps: torch.Tensor
                 ) -> torch.Tensor:
    """Per-row filtered sampling of [R, V] logits with [R] knob tensors
    (JAX :131): greedy rows (temp <= 0) take the argmax, sampled rows a
    Gumbel-max draw at their own temperature from (seed, idx).  Every
    token the server emits goes through here."""
    logits = _filter_logits_rows(logits.float(), temps, top_ks, top_ps)
    noise = _gumbel(_sample_keys(seeds, idxs), logits.shape[-1])
    drawn = torch.argmax(
        logits / torch.clamp(temps, min=1e-6)[:, None] + noise, dim=-1)
    return torch.where(temps > 0.0, drawn, torch.argmax(logits, dim=-1))


def _check_prompt(model, prompt: torch.Tensor, steps: int) -> None:
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be [batch, time], got "
                         f"{tuple(prompt.shape)}")
    total = prompt.shape[1] + steps
    if total > model.max_len:
        raise ValueError(
            f"prompt + steps = {total} exceeds model.max_len "
            f"{model.max_len}")


def _check_model(model) -> None:
    from .transformer import check_decode

    check_decode(model.attn_impl, model.seq_axis, model.moe_axis)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` with no host sync: on the
    card through pinned memory and a non-blocking copy (the caching host
    allocator keeps the pinned block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Graphed:
    """``fn`` at fixed input shapes replayed from one CUDA graph: a call
    copies its tensors into the captured inputs, replays, and returns the
    captured outputs (overwritten by the next call).  Capturing runs
    ``fn`` twice on ``example`` first (cuBLAS's and the allocator's
    warm-up): a decode step writes into its cache there, so capture before
    the cache holds anything live."""

    def __init__(self, fn, *example):
        self.inputs = [t.clone() for t in example]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return self.outputs


def graphed(fn, *example):
    """``fn`` replayed from a CUDA graph when its inputs are on the card
    (:class:`_Graphed`: a fixed-shape decode step launches as one graph
    instead of ~900 kernels from the host); ``fn`` itself on the CPU."""
    if example[0].device.type != "cuda":
        return fn
    return _Graphed(fn, *example)


def _as_tokens(model, prompt) -> torch.Tensor:
    dev = model.head.device
    if torch.is_tensor(prompt):
        if prompt.device == dev:
            return prompt
        prompt = prompt.cpu().numpy()
    return to_device(np.asarray(prompt), dev)


def _row_seeds(seed: Union[int, Sequence[int]], B: int,
               device) -> torch.Tensor:
    if isinstance(seed, (int, np.integer)):
        seeds = [(int(seed) + b) & _M32 for b in range(B)]
    else:
        seeds = [int(s) & _M32 for s in seed]
        if len(seeds) != B:
            raise ValueError(f"{len(seeds)} seeds for {B} rows")
    return to_device(np.asarray(seeds, np.int64), device)


@torch.no_grad()
def generate(model, prompt, steps: int, *, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_id: Optional[int] = None,
             seed: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """Generate ``steps`` tokens after ``prompt`` ([B, T_prompt] ints)
    with a local or flash :class:`TransformerLM` (JAX :433).

    One forward prefills the prompt into a fresh cache, then each token is
    one forward of one token a row at its own position (on the card, one
    CUDA graph replay).  ``temperature=0`` is greedy;
    otherwise Gumbel-max sampling at that temperature, optionally within
    the ``top_k`` highest logits and / or the ``top_p`` nucleus.  Row b
    draws token i from (its seed, i): ``seed`` is a list of one seed a
    row, or an int s, which gives row b the seed s + b (the stream a
    serving request of that seed and prompt gets).  With ``eos_id``, rows
    that emit it stop: every later position is ``eos_id``.  Returns the
    full [B, T_prompt + steps] sequence on the model's device."""
    prompt = _as_tokens(model, prompt)
    _check_prompt(model, prompt, steps)
    _check_sampling(top_k, top_p)
    _check_model(model)
    B, Tp = prompt.shape
    if steps <= 0:
        return prompt
    seeds = _row_seeds(seed, B, prompt.device)
    cache = model.init_cache(B)

    def sample(logits, idx):
        return _sample(logits, _sample_keys(seeds, idx), temperature, top_k,
                       top_p).to(prompt.dtype)

    def step(tok, pos):
        """Token ``pos - Tp + 1`` of every row from its input ``tok``."""
        logits = model(tok[:, None], pos, cache=cache)[:, 0]
        return sample(logits, pos - (Tp - 1))

    pos = torch.full_like(seeds, Tp)
    if steps > 1:  # captured before the prefill writes the cache
        step = graphed(step, prompt[:, 0], pos)
    xs, head = model(prompt, 0, return_prehead=True, cache=cache)
    tok = sample(xs[:, -1] @ head, pos - Tp)
    out = [prompt, tok[:, None]]
    done = tok == eos_id if eos_id is not None else None
    for i in range(1, steps):
        tok = step(tok, pos + (i - 1)).clone()
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last dim: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_expand(lp, fin, ln, step_lp, eos_id: Optional[int]):
    """One beam expansion (JAX :222): ``lp`` / ``fin`` / ``ln`` [B, K]
    cumulative log-prob, finished flag and generated length; ``step_lp``
    [B, K, V].  A finished beam's one continuation is eos at +0, so its
    score survives unchanged.  Returns ``(new_lp, new_tok, new_fin,
    new_ln, parent)``."""
    B, K, V = step_lp.shape
    if eos_id is not None:
        pad_row = torch.full((V,), float("-inf"), device=step_lp.device)
        pad_row[eos_id] = 0.0
        step_lp = torch.where(fin[:, :, None], pad_row, step_lp)
    total = lp[:, :, None] + step_lp
    new_lp, flat = _top_k(total.reshape(B, K * V), K)
    parent, new_tok = flat // V, flat % V
    par_fin = torch.gather(fin, 1, parent)
    new_ln = torch.gather(ln, 1, parent) + (~par_fin).long()
    new_fin = par_fin
    if eos_id is not None:
        new_fin = par_fin | (new_tok == eos_id)
    return new_lp, new_tok, new_fin, new_ln, parent


def _beam_backtrack(prompt, top_tok, toks: List[torch.Tensor],
                    parents: List[torch.Tensor], final_lp, final_len,
                    length_penalty: float) -> torch.Tensor:
    """The best hypothesis through the (token, parent) trellis, ranked by
    the (optionally length-normalized) score (JAX :251)."""
    score = final_lp
    if length_penalty:
        score = final_lp / torch.clamp(final_len.float(),
                                       min=1.0) ** length_penalty
    beam = torch.argmax(score, dim=-1)[:, None]
    path = []
    for tok_t, par_t in zip(reversed(toks), reversed(parents)):
        path.append(torch.gather(tok_t, 1, beam))
        beam = torch.gather(par_t, 1, beam)
    first = torch.gather(top_tok, 1, beam)
    return torch.cat([prompt, first] + path[::-1], dim=1)


def _check_beams(model, beams: int) -> None:
    if beams < 1:
        raise ValueError(f"beams must be >= 1, got {beams}")
    if beams > model.vocab:
        raise ValueError(f"beams {beams} exceeds vocab {model.vocab}")


@torch.no_grad()
def beam_search(model, prompt, steps: int, *, beams: int,
                eos_id: Optional[int] = None,
                length_penalty: float = 0.0) -> torch.Tensor:
    """Beam search over the KV cache (JAX :349): per batch row, the
    highest-scoring continuation among ``beams`` hypotheses expanded each
    step.  Prefill once on B rows, tile the cache to B * beams rows, and
    gather the rows by parent after each step.  With ``eos_id`` a beam
    that emits it finishes (frozen score, eos-padded suffix);
    ``length_penalty`` alpha ranks the final hypotheses by ``logprob /
    len**alpha``.  ``beams=1`` is greedy :func:`generate`."""
    prompt = _as_tokens(model, prompt)
    _check_prompt(model, prompt, steps)
    _check_beams(model, beams)
    _check_model(model)
    B, Tp = prompt.shape
    K = int(beams)
    if steps <= 0:
        return prompt
    cache = model.init_cache(B)
    xs, head = model(prompt, 0, return_prehead=True, cache=cache)
    lp0 = torch.log_softmax((xs[:, -1] @ head).float(), dim=-1)
    V = lp0.shape[-1]
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
    for i in range(steps - 1):
        logits = model(tok.reshape(B * K, 1), Tp + i, cache=cache)
        step_lp = torch.log_softmax(logits[:, 0].float(),
                                    dim=-1).reshape(B, K, V)
        lp, tok, fin, ln, parent = _beam_expand(lp, fin, ln, step_lp,
                                                eos_id)
        tok = tok.to(prompt.dtype)
        cache = cache.index_rows((base + parent).reshape(-1))
        toks.append(tok)
        parents.append(parent)
    return _beam_backtrack(prompt, top_tok, toks, parents, lp, ln,
                           length_penalty)


# ---------------------------------------------------------------------------
# Slot primitives of the continuous-batching server (serving/).  A pool
# cache's rows are the slots.  ``sampling`` is the tuple (seeds, idxs,
# temps, top_ks, top_ps) of [R] tensors routed through _sample_rows;
# None is greedy (the sentinels temp 0, top_k 0, top_p 2.0).  Each
# primitive returns the cache it wrote (in place) and the sampled tokens
# on the device.
# ---------------------------------------------------------------------------


def clamp_slot_positions(positions, limit: int, width: int = 1):
    """The cache-index clamp (JAX :546): bound ``positions`` (an int, or a
    tensor of positions) to ``[0, limit - width]``, so that a
    width-``width`` write at each stays inside a ``limit``-deep cache.
    JAX's ``dynamic_update_slice`` clamps its start so; torch indexing
    would raise or write past the end (ROADMAP queue C note 1).  For the
    valid positions correct callers pass it is the identity."""
    hi = max(0, int(limit) - int(width))
    if torch.is_tensor(positions):
        return torch.clamp(positions, 0, hi)
    return min(max(int(positions), 0), hi)


def greedy_sampling(n: int, device) -> Tuple[torch.Tensor, ...]:
    """The sampling tuple of ``n`` greedy rows (filter no-ops)."""
    z = torch.zeros((n,), dtype=torch.long, device=device)
    return (z, z, torch.zeros((n,), device=device), z,
            torch.full((n,), 2.0, device=device))


def _last_logits(xs, head, true_len):
    t = clamp_slot_positions(int(true_len) - 1, xs.shape[1])
    return xs[:, t] @ head


@torch.no_grad()
def slot_prefill(model, prompt: torch.Tensor, *, max_len: Optional[int] = None,
                 true_len: Optional[int] = None, sampling=None):
    """Prefill one request (a [1, Tp] prompt, possibly right-padded to a
    length bucket) on a fresh cache of ``max_len`` positions (default the
    model's); returns ``(cache, first_token [1])``.  The token comes from
    the logits at the true last position ``true_len - 1``: causality keeps
    them independent of the padding, so padded and unpadded prefills emit
    the same token."""
    if true_len is None:
        true_len = prompt.shape[1]
    if sampling is None:
        sampling = greedy_sampling(prompt.shape[0], prompt.device)
    cache = model.init_cache(prompt.shape[0], max_len)
    xs, head = model(prompt, 0, return_prehead=True, cache=cache)
    return cache, _sample_rows(_last_logits(xs, head, true_len), *sampling)


@torch.no_grad()
def slot_decode_step(model, cache, tokens: torch.Tensor,
                     positions: torch.Tensor, sampling=None):
    """One decode step over the whole pool: ``tokens`` [S] each slot's
    pending token, ``positions`` [S] its write position (inactive slots
    pass any valid filler).  Returns ``(cache, next_tokens [S])``."""
    if sampling is None:
        sampling = greedy_sampling(tokens.shape[0], tokens.device)
    logits = model(tokens[:, None], positions, cache=cache)
    return cache, _sample_rows(logits[:, 0], *sampling)


@torch.no_grad()
def slot_verify_step(model, cache, tokens: torch.Tensor,
                     positions: torch.Tensor, sampling=None):
    """The speculative verify forward: ``tokens`` [S, K+1] each slot's
    pending token and its K drafts, ``positions`` [S].  One forward writes
    all K+1 entries at per-row depths and returns the sample at every
    position ([S, K+1]); position j of row s draws with (seed_s, idx_s +
    j), the key the sequential decode would use for that token, so
    accepting while the drafts match emits the sequential stream bit for
    bit."""
    S, T = tokens.shape
    if sampling is None:
        sampling = greedy_sampling(S, tokens.device)
    seeds, idxs, temps, top_ks, top_ps = sampling
    logits = model(tokens, positions, cache=cache)
    j = torch.arange(T, device=tokens.device)
    flat = _sample_rows(
        logits.reshape(S * T, -1), seeds.repeat_interleave(T),
        (idxs[:, None] + j).reshape(-1), temps.repeat_interleave(T),
        top_ks.repeat_interleave(T), top_ps.repeat_interleave(T))
    return cache, flat.reshape(S, T)


@torch.no_grad()
def slot_write(pool_cache, one_cache, slot: int):
    """Copy a one-row cache into row ``slot`` of the pool cache."""
    slot = clamp_slot_positions(slot, pool_cache.rows)
    for p, o in zip(pool_cache.k + pool_cache.v, one_cache.k + one_cache.v):
        p[slot].copy_(o[0])
    return pool_cache


@torch.no_grad()
def slot_cache_slice(row_cache, start: int, width: int):
    """A copy of ``width`` positions from ``start`` of a one-row cache:
    the fragment a prefix-cache node stores."""
    start = clamp_slot_positions(start, row_cache.max_len, width)
    from .transformer import KVCache

    return KVCache([t[:, start:start + width].clone() for t in row_cache.k],
                   [t[:, start:start + width].clone() for t in row_cache.v])


@torch.no_grad()
def slot_cache_write(row_cache, frag, start: int):
    """Write a :func:`slot_cache_slice` fragment into a one-row cache at
    position ``start`` (a prefix-cache hit's row assembly)."""
    width = frag.max_len
    start = clamp_slot_positions(start, row_cache.max_len, width)
    for r, f in zip(row_cache.k + row_cache.v, frag.k + frag.v):
        r[:, start:start + width].copy_(f)
    return row_cache


@torch.no_grad()
def slot_extend(model, row_cache, suffix: torch.Tensor, *,
                pos_offset: torch.Tensor, true_len: Optional[int] = None,
                sampling=None):
    """Prefill only a prompt's unshared suffix ([1, Ts], right-padded like
    :func:`slot_prefill`; ``true_len`` the suffix's true length) over a
    one-row cache assembled from prefix-cache fragments; ``pos_offset`` [1]
    is the assembled depth.  The per-row offset takes the cache-masked
    attention, so queries see the fragments and the suffix and nothing
    deeper, as a full prefill's causal mask does.  Returns ``(cache,
    first_token [1])``."""
    if true_len is None:
        true_len = suffix.shape[1]
    if sampling is None:
        sampling = greedy_sampling(suffix.shape[0], suffix.device)
    xs, head = model(suffix, pos_offset, return_prehead=True,
                     cache=row_cache)
    return row_cache, _sample_rows(_last_logits(xs, head, true_len),
                                   *sampling)
