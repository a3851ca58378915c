"""Draft proposers for speculative decoding over the slot pool (the JAX
package's ``serving/spec.py``: ``NgramDraft`` :52, ``ModelDraft`` :110
and their per-engine states).

Speculative decoding splits one engine step into drafting K tokens
cheaply and verifying all K+1 in one target forward
(``models.generate.slot_verify_step``): the target samples at every fed
position and the engine keeps samples exactly while the drafts match, so
the emitted stream is bitwise the non-speculative one at the same (seed,
prompt), only cheaper per token when drafts land.  This module owns the
proposers:

- :class:`NgramDraft`: prompt-lookup drafting, the K tokens that followed
  the longest recent n-gram suffix match in the request's own history.
  Free (unit weight 0).
- :class:`ModelDraft`: a small dense LM drafting greedily over its own
  slot-pooled cache, catching up on tokens the target accepted behind its
  back; ``unit_weight`` work units a draft forward (default the
  draft / target parameter ratio).

Both are templates: the engine calls :meth:`bind` once for a per-engine
state with the slot-keyed lifecycle ``admit`` / ``propose`` / ``observe``
/ ``free`` / ``drain``.  ``drain`` discards all per-slot state: a drained
replica's sessions re-route and the draft restarts cold.  Proposal
quality moves speed only, never output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _full_seq(sess) -> List[int]:
    """The session's full token history as the engine fed it: base
    prompt + pre-reroute tokens + this replica's emitted (the last
    entry is the pending token — sampled, not yet in the cache)."""
    req = sess.request
    base = list(np.asarray(req.prompt, np.int32).reshape(-1))
    return base + list(getattr(req, "tokens", []) or []) + sess.emitted


class NgramDraft:
    """Prompt-lookup drafting (template — :meth:`bind` per engine)."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"ngram order must be >= 1, got {n}")
        self.n = int(n)

    def bind(self, engine) -> "_NgramState":
        return _NgramState(self.n)


class _NgramState:
    """Per-engine ngram proposer.  Stateless between ticks (history
    lives on the sessions), so the slot lifecycle hooks are no-ops —
    which is itself the drain story: there is nothing to discard."""

    unit_weight = 0.0

    def __init__(self, n: int):
        self.n = n

    def admit(self, slot: int, sess) -> float:
        return 0.0

    def propose(self, sessions: Dict[int, object], k: int
                ) -> Tuple[Dict[int, List[int]], float]:
        drafts: Dict[int, List[int]] = {}
        for slot, sess in sessions.items():
            hist = _full_seq(sess)
            d: List[int] = []
            # Longest suffix (order n down to 1) with an EARLIER
            # occurrence; propose the tokens that followed it.  The
            # rightmost match tracks the most recent local pattern.
            for g in range(min(self.n, len(hist) - 1), 0, -1):
                suffix = hist[-g:]
                for i in range(len(hist) - g - 1, -1, -1):
                    if hist[i:i + g] == suffix:
                        d = hist[i + g:i + g + k]
                        break
                if d:
                    break
            drafts[slot] = d
        return drafts, 0.0

    def observe(self, slot: int, sess) -> None:
        pass

    def free(self, slot: int) -> None:
        pass

    def drain(self) -> None:
        pass

    def active_slots(self) -> List[int]:
        return []


class ModelDraft:
    """Small-LM drafting (template: :meth:`bind` per engine).

    ``model`` is a dense local or flash ``TransformerLM`` holding its
    weights, over the same vocabulary as the target.  ``unit_weight``
    prices one draft forward on the work-unit clock; None takes the
    parameter-count ratio draft / target at bind time."""

    def __init__(self, model, *, unit_weight: Optional[float] = None):
        self.model = model
        self.unit_weight = unit_weight

    def bind(self, engine) -> "_ModelDraftState":
        return _ModelDraftState(self, engine)


class _ModelDraftState:
    """Per-engine draft-LM state: its own slot-pooled cache, aligned
    slot-for-slot with the target's pool, plus a per-slot ``d_filled``
    pointer: how many positions of the slot's true sequence the draft
    cache has consumed.  Each step feeds exactly K pooled greedy decode
    steps: first the catch-up queue (true tokens the target emitted
    since the last step), then the draft's own greedy continuations,
    which are the proposals."""

    def __init__(self, draft: ModelDraft, engine):
        from .engine import _on

        st = engine.pool.slot_tokens
        model = draft.model
        if int(model.vocab) != int(engine.vocab):
            raise ValueError(
                f"draft vocab {model.vocab} != target vocab "
                f"{engine.vocab}: speculative tokens must share one id "
                f"space")
        if model.pos_emb == "learned" and st != model.max_len:
            raise ValueError(
                f"draft max_len {model.max_len} != slot block {st}: a "
                f"learned-position draft cannot shrink its block (use "
                f"pos_emb='rope')")
        self.model = _on(model, engine.device)
        self.device = engine.device
        self.st = st
        w = draft.unit_weight
        if w is None:
            n_draft = sum(p.numel() for p in self.model.parameters())
            w = n_draft / max(1, engine.param_count)
        self.unit_weight = float(w)
        S = engine.pool.n_slots
        self._cache = self.model.init_cache(S, st)
        self._n_slots = S
        #: slot -> positions of the slot's true sequence already in the
        #: draft cache (kv written for seq[0 .. d_filled-1]).
        self._filled: Dict[int, int] = {}
        #: slot -> tokens fed beyond the catch-up point last tick, to
        #: advance ``_filled`` by the verified-correct prefix.
        self._fed: Dict[int, List[int]] = {}

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, slot: int, sess) -> float:
        """Prefill the fed prompt (base + pre-reroute tokens) on the
        draft and write it into the draft pool row.  Returns the work
        units spent (one draft prefill)."""
        from ..models.generate import slot_prefill, slot_write, to_device

        req = sess.request
        base = np.asarray(req.prompt, np.int64).reshape(-1)
        prev = np.asarray(getattr(req, "tokens", []) or [], np.int64)
        prompt = np.concatenate([base, prev]).reshape(1, -1)
        one, _ = slot_prefill(self.model, to_device(prompt, self.device),
                              max_len=self.st)
        slot_write(self._cache, one, slot)
        self._filled[slot] = prompt.shape[1]
        self._fed[slot] = []
        return self.unit_weight

    def propose(self, sessions: Dict[int, object], k: int
                ) -> Tuple[Dict[int, List[int]], float]:
        from ..models.generate import slot_decode_step, to_device

        S = self._n_slots
        queues: Dict[int, List[int]] = {}
        for slot, sess in sessions.items():
            if slot not in self._filled:  # admitted before spec was on
                self.admit(slot, sess)
            full = _full_seq(sess)
            queues[slot] = full[self._filled[slot]:]
            self._fed[slot] = []
        drafts: Dict[int, List[int]] = {slot: [] for slot in sessions}
        for step in range(k):
            toks = np.zeros((S,), np.int64)
            pos = np.zeros((S,), np.int64)
            for slot in sessions:
                q = queues[slot]
                toks[slot] = q[step] if step < len(q) else \
                    drafts[slot][step - len(q)]
                pos[slot] = self._filled[slot] + step
            dev = to_device(np.stack([toks, pos]), self.device)
            _, nxt = slot_decode_step(self.model, self._cache, dev[0],
                                      dev[1])
            nxt = nxt.cpu().numpy()
            for slot in sessions:
                q = queues[slot]
                if step >= len(q):
                    self._fed[slot].append(int(toks[slot]))
                # The output becomes a PROPOSAL once the known queue is
                # consumed (the last known feed's output is draft #1).
                if step >= len(q) - 1:
                    drafts[slot].append(int(nxt[slot]))
        out = {}
        for slot, sess in sessions.items():
            q = queues[slot]
            # Catch-up longer than K: nothing proposable this tick (the
            # next ticks keep catching up); the engine degrades to a
            # verified plain step.
            out[slot] = drafts[slot][:max(0, k - max(0, len(q) - 1))]
            # Known-queue feeds are true sequence by construction.
            self._filled[slot] += min(len(q), k)
        return out, float(k) * self.unit_weight

    def observe(self, slot: int, sess) -> None:
        """After verify: advance ``d_filled`` over the speculative
        feeds that turned out to be the true sequence; everything after
        the first wrong feed stays unconsumed (its cache rows are
        re-fed — overwritten — on later ticks)."""
        full = _full_seq(sess)
        df = self._filled.get(slot)
        if df is None:
            return
        for tok in self._fed.get(slot, []):
            if df < len(full) and tok == full[df]:
                df += 1
            else:
                break
        self._filled[slot] = df
        self._fed[slot] = []

    def free(self, slot: int) -> None:
        self._filled.pop(slot, None)
        self._fed.pop(slot, None)

    def drain(self) -> None:
        """Replica death: discard ALL speculative state (cache rows are
        garbage once the target's sessions re-route — the per-row depth
        mask makes stale rows invisible after the next admit)."""
        self._filled.clear()
        self._fed.clear()

    def active_slots(self) -> List[int]:
        return sorted(self._filled)
