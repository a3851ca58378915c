"""One replica's continuous-batching decode engine (the JAX package's
``serving/engine.py``: ``RequestRejected`` :66, ``Session`` :85,
``ReplicaEngine`` :106).

A :class:`ReplicaEngine` owns one slot-pooled KV cache (a
``TransformerLM.init_cache`` of ``slots`` rows, ``slot_tokens`` positions
each) on its model's device, plus the per-slot session bookkeeping, and
exposes the two iteration-level operations the scheduler composes:

- :meth:`admit`: allocate a slot, prefill the request's prompt onto a
  fresh cache, copy it into the pool row, emit the first token (the TTFT
  event).  With ``prefill_bucket`` set the prompt is right-padded to a
  pow-2 length bucket; the emitted token is the unpadded one (the logits
  are taken at the true last position).  ``stats["prefill_compiles"]``
  counts the distinct padded lengths, JAX's compile count (the port runs
  eagerly and compiles nothing).  With the prefix cache on, a hit
  assembles the matched fragments and prefills only the suffix.
- :meth:`step`: one ``[S, 1]`` decode step advancing every in-flight
  slot at its own cache depth (``models.generate.slot_decode_step``; on
  the card one CUDA graph, captured with the engine);
  sequences that emit EOS or reach their budget retire at once and free
  their slot.  With ``spec_k`` > 0 the step drafts K tokens a slot
  (:mod:`.spec`), verifies them in one ``[S, K+1]`` forward
  (``slot_verify_step``) and accepts while the drafts match: the stream
  is bitwise the plain one.

Sampling is per request (temperature / top-k / top-p / seed, resolved
against the Config default at admission) and reproducible from (seed,
prompt): token i of a request draws from (seed, i) whatever its slot,
neighbours or re-routes (ROADMAP queue C note 2).

Host and device: every forward's inputs (tokens, positions, sampling
knobs) go to the card through pinned memory without a host sync, and
each admission and each step reads its new tokens back exactly once
(JAX's ``np.asarray``).  ``stats`` counts forwards and ``units`` work
units (prefill and pooled forward 1 each, draft forwards at the
proposer's ``unit_weight``): the scheduler's ``unit_seconds`` clock.
The engine keeps no time.  With ``Config.obs`` on it counts its
``tm_serving_*`` events (JAX :74-82, :289, :441, :585): a new prefill
length, prefix-cache hits, misses, saved tokens and bytes, insertions and
evictions, speculative drafts and acceptances; it reaches the obs layer
through ``sys.modules`` only (:func:`_obs`).
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..models.generate import graphed, slot_cache_slice, \
    slot_cache_write, slot_decode_step, slot_extend, slot_prefill, \
    slot_verify_step, slot_write, to_device
from ..models.transformer import check_decode
from .prefix_cache import PrefixCache
from .slots import SlotPool


class RequestRejected(ValueError):
    """Raised by :meth:`ReplicaEngine.admit` for a request that can
    never be served (its ``prompt + max_new`` exceeds the slot block, or
    its sampling knobs are invalid).  A type of its own so the scheduler
    rejects exactly this case and keeps serving."""


_OBS = __name__.rsplit(".", 2)[0] + ".obs"


def _obs():
    """The obs module when telemetry is active, else None: a
    ``sys.modules`` lookup, so serving never imports the telemetry it
    reports to (JAX :74-82)."""
    mod = sys.modules.get(_OBS)
    try:
        if mod is not None and mod.active():
            return mod
    except Exception:  # noqa: BLE001 — telemetry never fails a tick
        pass
    return None


@dataclasses.dataclass
class Session:
    """One in-flight request on one slot."""

    request: Any            # scheduler.Request
    slot: int
    last_tok: int           # pending token (input of the next step)
    pos_next: int           # absolute cache index the next step writes
    emitted: List[int] = dataclasses.field(default_factory=list)
    #: Resolved (temperature, top_k, top_p, seed); greedy rows carry
    #: the filter no-op sentinels (0.0, 0, 2.0).
    sampling: Tuple[float, int, float, int] = (0.0, 0, 2.0, 0)
    #: Tokens emitted by the last step that advanced this session (1
    #: for admit / plain step, up to K+1 for a speculative step).
    last_emit: int = 1
    #: Prefix-cache nodes this session pinned at admission, released at
    #: retirement.
    prefix_chain: List[Any] = dataclasses.field(default_factory=list)


def _on(model, device) -> Any:
    """``model``, or a copy of it on ``device`` (a replica pinned to
    another card)."""
    if device is None:
        return model
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev == model.head.device:
        return model
    return copy.deepcopy(model).to(dev)


class ReplicaEngine:
    """Slot-pooled decode engine for one model replica.

    ``model`` is a local or flash ``TransformerLM`` holding its weights;
    the engine runs on its device (``device`` pins the replica to another
    card, on a copy of the model).  ``slots`` / ``slot_tokens`` /
    ``sample`` / ``prefill_bucket`` / ``spec_k`` / ``prefix_cache``
    default from the active Config (``serving_slots`` ...).  ``draft`` is
    a :mod:`.spec` proposer template; ``spec_k`` > 0 with no draft binds
    an :class:`~.spec.NgramDraft`."""

    def __init__(self, model, *, name: str = "replica0",
                 slots: Optional[int] = None,
                 slot_tokens: Optional[int] = None,
                 device=None, sample: Optional[float] = None,
                 prefill_bucket: Optional[int] = None,
                 spec_k: Optional[int] = None, draft=None,
                 prefix_cache: Optional[int] = None,
                 prefix_block: int = 8):
        cfg = runtime.effective_config()
        slots = int(slots if slots is not None else cfg.serving_slots)
        st = int(slot_tokens if slot_tokens is not None
                 else (cfg.serving_slot_tokens or 0))
        if st == 0:
            st = int(model.max_len)
        if model.pos_emb == "learned" and st != model.max_len:
            raise ValueError(
                f"serving_slot_tokens={st} != model.max_len="
                f"{model.max_len}: a learned position table is sized by "
                f"max_len, so slot blocks can only be shrunk for "
                f"pos_emb='rope' models")
        if model.moe_axis is not None or model.seq_axis is not None:
            raise ValueError(
                "ReplicaEngine serves dense single-device models; use "
                "serving.TPReplicaEngine (or Server.sharded) for a "
                "mesh-parallel replica")
        check_decode(model.attn_impl)
        self.model = _on(model, device)
        self.device = self.model.head.device
        self.vocab = int(model.vocab)
        self.param_count = sum(p.numel() for p in self.model.parameters())
        self._init_serving(cfg, name, slots, st, sample=sample,
                           prefill_bucket=prefill_bucket,
                           prefix_cache=prefix_cache,
                           prefix_block=prefix_block)
        self._cache = self.model.init_cache(slots, st)
        self._capture_step()
        self._bind_draft(spec_k, cfg, draft)

    def _init_serving(self, cfg, name: str, slots: int, st: int, *,
                      sample, prefill_bucket, prefix_cache,
                      prefix_block: int) -> None:
        """The backend-independent state: the slot pool, the prefix
        cache, the sessions, the sampling and bucketing defaults, the
        counters."""
        self.name = name
        cap = int(prefix_cache if prefix_cache is not None
                  else cfg.serving_prefix_cache)
        self.pool = SlotPool(slots, st, prefix_blocks=cap)
        self._prefix = (PrefixCache(self.pool,
                                    block_tokens=min(int(prefix_block), st))
                        if cap > 0 else None)
        self.dead = False
        self._sessions: Dict[int, Session] = {}
        self._sample_default = float(
            sample if sample is not None else cfg.serving_sample)
        self._bucket = int(prefill_bucket if prefill_bucket is not None
                           else cfg.serving_prefill_buckets)
        #: Padded prompt lengths this engine has prefilled.
        self._prefill_lens: set = set()
        self.stats = {"prefills": 0, "steps": 0, "prefill_compiles": 0,
                      "spec_steps": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "prefill_tokens": 0,
                      "prefix_hits": 0, "prefix_misses": 0}
        self.units = 0.0

    def _capture_step(self, counters=(), graph: bool = True) -> None:
        """The pooled decode step at its fixed shapes, captured (``graph``)
        while the pool holds nothing (the capture's warm-up writes into
        it); ``counters`` as ``models.generate.graphed`` takes them."""
        if not graph:
            self._step = self._decode
            return
        zeros = np.zeros((self.pool.n_slots,), np.int64)
        (t, p), samp = self._stage([zeros, zeros],
                                   self._sampling_arrays({}))
        self._step = graphed(self._decode, t, p, *samp, counters=counters)

    def _bind_draft(self, spec_k, cfg, draft) -> None:
        self._spec_k = int(spec_k if spec_k is not None
                           else cfg.serving_spec_k)
        if self._spec_k > 0:
            if draft is None:
                from .spec import NgramDraft

                draft = NgramDraft()
            self._draft = draft.bind(self)
        else:
            self._draft = None

    # -- introspection -----------------------------------------------------

    @property
    def active(self) -> int:
        return len(self._sessions)

    def sessions(self) -> List[Session]:
        return list(self._sessions.values())

    def has_capacity(self) -> bool:
        return not self.dead and self.pool.free_count > 0

    # -- sampling / bucketing resolution -----------------------------------

    def _resolve_sampling(self, request) -> Tuple[float, int, float, int]:
        """Per-request knobs against the Config default, validated.
        Greedy requests are forced to the filter no-op sentinels (temp
        0.0, top_k 0, top_p 2.0), so their stream is the unfiltered
        argmax whatever stray k / p they carry."""
        t = getattr(request, "temperature", None)
        t = self._sample_default if t is None else float(t)
        seed = int(getattr(request, "seed", 0) or 0)
        if t <= 0.0:
            return (0.0, 0, 2.0, seed)
        k = getattr(request, "top_k", None)
        k = 0 if k is None else int(k)
        p = getattr(request, "top_p", None)
        p = 2.0 if p is None else float(p)
        if k < 0:
            raise RequestRejected(
                f"request {request.rid!r}: top_k must be >= 0 "
                f"(0 = off), got {k}")
        if p != 2.0 and not 0.0 < p <= 1.0:
            raise RequestRejected(
                f"request {request.rid!r}: top_p must be in (0, 1], "
                f"got {p}")
        return (t, k, p, seed)

    def _pad_prompt(self, prompt: np.ndarray,
                    cap: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """Right-pad to the pow-2 bucket (>= ``prefill_bucket``, capped
        at ``cap``, default the slot block; a prefix hit's suffix caps at
        the room left above the assembled depth).  Returns ``(padded,
        true_len)``."""
        true_len = prompt.shape[1]
        if self._bucket <= 0:
            return prompt, true_len
        bucket = max(self._bucket, 1 << max(0, true_len - 1).bit_length())
        bucket = min(bucket,
                     self.pool.slot_tokens if cap is None else cap)
        if bucket <= true_len:
            return prompt, true_len
        padded = np.zeros((1, bucket), prompt.dtype)
        padded[:, :true_len] = prompt
        return padded, true_len

    def _record_prefix(self, mod, chain, n_new: int, n_evicted: int) -> None:
        """One admission's prefix-cache telemetry (JAX :441-461)."""
        if chain:
            depth = self._prefix.block_tokens * len(chain)
            mod.record_serving("prefix_hits", replica=self.name)
            mod.record_serving("prefix_tokens_saved", depth,
                               replica=self.name)
            mod.record_serving("prefix_bytes_saved",
                               sum(n.nbytes for n in chain),
                               replica=self.name)
        else:
            mod.record_serving("prefix_misses", replica=self.name)
        if n_new:
            mod.record_serving("prefix_inserted", n_new, replica=self.name)
        if n_evicted:
            mod.record_serving("prefix_evicted", n_evicted,
                               replica=self.name)

    def _count_prefill_compile(self, key) -> None:
        """A padded length this engine has not prefilled before: one new
        specialization in JAX's terms (``key`` the padded length, or
        ``("ext", length)`` for a prefix hit's suffix forward)."""
        if key not in self._prefill_lens:
            self._prefill_lens.add(key)
            self.stats["prefill_compiles"] += 1
            mod = _obs()
            if mod is not None:
                mod.record_serving("prefill_compiles", replica=self.name)

    def _sampling_arrays(self, sessions: Dict[int, Session]):
        """[S] host arrays (seeds, idxs, temps, top_ks, top_ps) for the
        pooled forwards.  ``idxs`` is each session's global emitted-token
        index (pre-reroute tokens included): sampling is a function of
        (seed, token index) alone."""
        S = self.pool.n_slots
        seeds = np.zeros((S,), np.int64)
        idxs = np.zeros((S,), np.int64)
        temps = np.zeros((S,), np.float32)
        tks = np.zeros((S,), np.int64)
        tps = np.full((S,), 2.0, np.float32)
        for slot, sess in sessions.items():
            t, k, p, seed = sess.sampling
            seeds[slot] = seed & 0xFFFFFFFF
            idxs[slot] = len(getattr(sess.request, "tokens", []) or []) \
                + len(sess.emitted)
            temps[slot] = t
            tks[slot] = k
            tps[slot] = p
        return seeds, idxs, temps, tks, tps

    def _stage(self, ints: List[np.ndarray], sampling):
        """The host inputs of one forward on the device in two copies with
        no host sync: ``ints`` (token and position arrays, each [S, ...]
        of S rows) and the sampling arrays.  Returns the int tensors and
        the sampling tuple."""
        seeds, idxs, temps, tks, tps = sampling
        flat = [a.reshape(a.shape[0], -1).astype(np.int64) for a in ints]
        widths = [a.shape[1] for a in flat]
        i_dev = to_device(np.concatenate(
            flat + [np.stack([seeds, idxs, tks], axis=1)], axis=1),
            self.device)
        f_dev = to_device(np.stack([temps, tps]), self.device)
        out, col = [], 0
        for a, w in zip(ints, widths):
            out.append(i_dev[:, col:col + w].reshape(a.shape))
            col += w
        samp = (i_dev[:, col], i_dev[:, col + 1], f_dev[0],
                i_dev[:, col + 2], f_dev[1])
        return out, samp

    # -- backend hooks -----------------------------------------------------

    def _backend_prefill(self, prompt: np.ndarray, true_len: int,
                         sampling):
        # Module-global lookup on purpose: tests replace
        # ``engine.slot_prefill`` to inject prefill failures.
        (tok,), samp = self._stage([prompt], sampling)
        return slot_prefill(self.model, tok, max_len=self.pool.slot_tokens,
                            true_len=true_len, sampling=samp)

    def _row_template(self):
        """A zero one-row cache of the slot block (a prefix hit's row)."""
        return self.model.init_cache(1, self.pool.slot_tokens)

    def _decode(self, toks, pos, *sampling):
        return slot_decode_step(self.model, self._cache, toks, pos,
                                sampling=sampling)[1]

    def _backend_step(self, toks: np.ndarray, pos: np.ndarray, sampling):
        (t, p), samp = self._stage([toks, pos], sampling)
        return self._step(t, p, *samp).cpu().numpy()

    def _backend_verify(self, toks: np.ndarray, pos: np.ndarray,
                        sampling):
        (t, p), samp = self._stage([toks, pos], sampling)
        self._cache, out = slot_verify_step(self.model, self._cache, t, p,
                                            sampling=samp)
        return out.cpu().numpy()

    def _backend_extend(self, row_cache, suffix: np.ndarray, depth: int,
                        true_len: int, sampling):
        (tok, pos), samp = self._stage(
            [suffix, np.asarray([depth], np.int64)], sampling)
        return slot_extend(self.model, row_cache, tok, pos_offset=pos,
                           true_len=true_len, sampling=samp)

    # -- iteration-level operations ----------------------------------------

    def admit(self, request) -> Optional[Tuple[Session, bool]]:
        """Prefill ``request`` into a free slot; returns ``(session,
        finished)``, ``finished`` when the first token already ends the
        request (EOS, or max_new == 1; its slot is freed again before
        returning).  None when the pool is full (the caller retries next
        tick).  Raises on a request that can never fit a slot block."""
        if self.dead:
            raise RuntimeError(f"{self.name} is dead")
        sampling = self._resolve_sampling(request)
        base = np.asarray(request.prompt, np.int64).reshape(-1)
        prev = np.asarray(getattr(request, "tokens", []) or [], np.int64)
        # A re-routed session re-prefills from its emitted prefix: its
        # continuation is what the dead replica would have produced.
        prompt = np.concatenate([base, prev]).reshape(1, -1)
        total = base.size + int(request.max_new)
        if not self.pool.fits(total):
            raise RequestRejected(
                f"request {request.rid!r}: prompt+max_new = {total} "
                f"exceeds the {self.pool.slot_tokens}-token slot block")
        slot = self.pool.alloc()
        if slot is None:
            return None
        try:
            self.stats["prefills"] += 1
            self.units += 1.0
            t, k, p, seed = sampling
            samp = (np.asarray([seed & 0xFFFFFFFF], np.int64),
                    np.asarray([prev.size], np.int64),
                    np.asarray([t], np.float32), np.asarray([k], np.int64),
                    np.asarray([p], np.float32))
            chain = (self._prefix.match(prompt[0])
                     if self._prefix is not None else [])
            if chain:
                # Cache hit: assemble the matched fragments onto a fresh
                # row and run the forward over only the unshared suffix;
                # the sampling index is untouched, so the tokens are the
                # miss path's.
                B = self._prefix.block_tokens
                depth = B * len(chain)
                row = self._row_template()
                for i, node in enumerate(chain):
                    slot_cache_write(row, node.frag, i * B)
                padded, true_len = self._pad_prompt(
                    prompt[:, depth:], cap=self.pool.slot_tokens - depth)
                self._count_prefill_compile(("ext", padded.shape[1]))
                one_cache, first = self._backend_extend(
                    row, padded, depth, true_len, samp)
                self.stats["prefix_hits"] += 1
            else:
                padded, true_len = self._pad_prompt(prompt)
                self._count_prefill_compile(padded.shape[1])
                one_cache, first = self._backend_prefill(
                    padded, true_len, samp)
                if self._prefix is not None:
                    self.stats["prefix_misses"] += 1
            self.stats["prefill_tokens"] += int(padded.shape[1])
            slot_write(self._cache, one_cache, slot)
            tok = int(first.cpu().numpy()[0])
            full_chain: List[Any] = []
            if self._prefix is not None:
                # Cache every full block of the true prompt from the row
                # just computed, then pin the whole chain for this
                # session's lifetime.
                B = self._prefix.block_tokens
                full_chain, n_new, n_evicted = self._prefix.insert(
                    prompt[0], prompt.shape[1],
                    lambda i: slot_cache_slice(one_cache, i * B, B))
                self._prefix.pin(full_chain)
                mod = _obs()
                if mod is not None:
                    self._record_prefix(mod, chain, n_new, n_evicted)
        except BaseException:
            # A failed prefill must not leak the block.  (Prefix pins are
            # taken last, so there is never a pinned chain to unwind.)
            self.pool.free(slot)
            raise
        sess = Session(request=request, slot=slot, last_tok=tok,
                       pos_next=prompt.shape[1], emitted=[tok],
                       sampling=sampling, last_emit=1,
                       prefix_chain=full_chain)
        if self._finished(sess):
            self.pool.free(slot)
            self._retire_prefix(sess)
            return sess, True
        self._sessions[slot] = sess
        if self._draft is not None:
            self.units += self._draft.admit(slot, sess)
        return sess, False

    def step(self) -> Tuple[List[Session], List[Session]]:
        """One decode step over every in-flight slot; returns
        ``(advanced, finished)``.  Finished sessions are already retired.
        Speculative when a draft is bound."""
        if self.dead:
            raise RuntimeError(f"{self.name} is dead")
        if not self._sessions:
            return [], []
        if self._draft is not None:
            return self._spec_step()
        self.stats["steps"] += 1
        self.units += 1.0
        S = self.pool.n_slots
        toks = np.zeros((S,), np.int64)
        pos = np.zeros((S,), np.int64)
        for slot, sess in self._sessions.items():
            toks[slot] = sess.last_tok
            pos[slot] = sess.pos_next
        nxt = self._backend_step(toks, pos,
                                 self._sampling_arrays(self._sessions))
        advanced, finished = [], []
        for slot in list(self._sessions):
            sess = self._sessions[slot]
            sess.last_tok = int(nxt[slot])
            sess.pos_next += 1
            sess.emitted.append(sess.last_tok)
            sess.last_emit = 1
            advanced.append(sess)
            if self._finished(sess):
                del self._sessions[slot]
                self.pool.free(slot)
                self._retire_prefix(sess)
                finished.append(sess)
        return advanced, finished

    def _spec_step(self) -> Tuple[List[Session], List[Session]]:
        """Draft K, verify in one [S, K+1] forward, accept while the
        drafts match what the target samples: the emitted stream is
        bitwise the non-speculative one."""
        sessions = dict(self._sessions)
        # A row near the end of its slot block has room for fewer than
        # K+1 writes: clamp K to the tightest room (>= 0).
        room = min(self.pool.slot_tokens - s.pos_next
                   for s in sessions.values())
        K = min(self._spec_k, max(0, room - 1))
        # Sampling arrays before drafting: idxs index the first token
        # this step emits.
        samp = self._sampling_arrays(sessions)
        drafts, draft_units = self._draft.propose(sessions, K)
        S = self.pool.n_slots
        toks = np.zeros((S, K + 1), np.int64)
        pos = np.zeros((S,), np.int64)
        for slot, sess in sessions.items():
            d = list(drafts.get(slot, []))[:K]
            toks[slot, 0] = sess.last_tok
            if d:
                toks[slot, 1:1 + len(d)] = d
            pos[slot] = sess.pos_next
        self.stats["steps"] += 1
        self.stats["spec_steps"] += 1
        self.units += 1.0 + float(draft_units)
        out = self._backend_verify(toks, pos, samp)
        advanced, finished = [], []
        tick_drafted = tick_accepted = 0
        for slot, sess in sessions.items():
            d = list(drafts.get(slot, []))[:K]
            row = out[slot]
            m = 0
            for j in range(len(d) + 1):
                t = int(row[j])
                sess.last_tok = t
                sess.emitted.append(t)
                m += 1
                if self._finished(sess):
                    break
                if j < len(d) and t != d[j]:
                    # Mismatch: t is the corrected token; the later
                    # samples conditioned on the wrong draft.
                    break
            sess.pos_next += m
            sess.last_emit = m
            tick_drafted += len(d)
            tick_accepted += sum(1 for j in range(min(m, len(d)))
                                 if int(row[j]) == d[j])
            advanced.append(sess)
            if self._finished(sess):
                del self._sessions[slot]
                self.pool.free(slot)
                self._retire_prefix(sess)
                self._draft.free(slot)
                finished.append(sess)
            else:
                self._draft.observe(slot, sess)
        self.stats["spec_drafted"] += tick_drafted
        self.stats["spec_accepted"] += tick_accepted
        mod = _obs()
        if mod is not None:
            if tick_drafted:
                mod.record_serving("spec_drafted", tick_drafted,
                                   replica=self.name)
            if tick_accepted:
                mod.record_serving("spec_accepted", tick_accepted,
                                   replica=self.name)
        return advanced, finished

    def drain(self) -> List[Session]:
        """Mark this replica dead and hand its in-flight sessions back
        for re-routing (the scheduler re-prefills each from its emitted
        prefix elsewhere).  Draft state is discarded with the replica."""
        self.dead = True
        out = list(self._sessions.values())
        for sess in out:
            self.pool.free(sess.slot)
            self._retire_prefix(sess)
        self._sessions.clear()
        if self._draft is not None:
            self._draft.drain()
        return out

    # -- internals ---------------------------------------------------------

    def _retire_prefix(self, sess: Session) -> None:
        """Release the session's prefix-block pins."""
        if sess.prefix_chain:
            self._prefix.release(sess.prefix_chain)
            sess.prefix_chain = []

    @staticmethod
    def _finished(sess: Session) -> bool:
        req = sess.request
        if req.eos_id is not None and sess.last_tok == int(req.eos_id):
            return True
        done_before = len(req.tokens) if hasattr(req, "tokens") else 0
        return done_before + len(sess.emitted) >= int(req.max_new)
