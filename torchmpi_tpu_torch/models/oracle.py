"""The dense oracle of the tensor-, pipeline-parallel and serving decoders.

The PyTorch counterpart of ``torchmpi_tpu/models/oracle.py``: single-device,
cache-free greedy decode of the :func:`.tp_generate.init_tp_lm` layout, the
whole forward recomputed every step, so that a KV-cache fault cannot hide
on both sides.  The math stays independent of the decoders it checks: its
own layer norm, no cache, a host-side loop.

- :func:`dense_forward` (JAX :28): the last position's logits [B, V]
  (:func:`dense_logits`: every position's);
- :func:`dense_greedy` (:53): greedy decode, ``eos_id`` freezing a row;
- :func:`seq_logprob` (:67): the summed log-probabilities of the generated
  positions, the beam search's brute-force oracle;
- :func:`setup` (:86): a seeded tree and prompt.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .tp_generate import init_tp_lm
from .transformer import apply_rope


def _ln(h, scale, bias):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) / torch.sqrt(var + 1e-6) * scale + bias


@torch.no_grad()
def dense_forward(params, toks, num_heads: int) -> torch.Tensor:
    """Full-sequence forward on the unsharded tree: returns the last
    position's logits [B, V]."""
    x = _trunk(params, toks, num_heads)
    return _ln(x[:, -1], *params["ln_f"]) @ params["head"]


@torch.no_grad()
def dense_logits(params, toks, num_heads: int) -> torch.Tensor:
    """The logits of every position [B, T, V] (the teacher-forced form of
    :func:`dense_forward`, one forward for a whole stream)."""
    x = _trunk(params, toks, num_heads)
    return _ln(x, *params["ln_f"]) @ params["head"]


def _trunk(params, toks, num_heads: int) -> torch.Tensor:
    toks = (toks if torch.is_tensor(toks) else torch.tensor(np.asarray(
        toks))).to(params["embed"].device).long()
    x = params["embed"][toks]
    B, T, _ = x.shape
    pos = torch.arange(T, device=x.device)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for p in params["blocks"]:
        h = _ln(x, *p["ln1"])
        width = p["wq"].shape[-1]
        dh = width // num_heads
        q = apply_rope((h @ p["wq"]).reshape(B, T, num_heads, dh), pos)
        k = apply_rope((h @ p["wk"]).reshape(B, T, num_heads, dh), pos)
        v = (h @ p["wv"]).reshape(B, T, num_heads, dh)
        s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        s = s.masked_fill(~causal, torch.finfo(s.dtype).min)
        probs = torch.softmax(s.float(), dim=-1)
        # JAX rounds probs to x's dtype, then promotes against v's.
        ctx = torch.einsum("bhts,bshd->bthd", probs.to(x.dtype).to(v.dtype),
                           v).reshape(B, T, width)
        x = x + ctx @ p["wo"]
        h2 = _ln(x, *p["ln2"])
        x = x + F.gelu(h2 @ p["w1"], approximate="tanh") @ p["w2"]
    return x


def dense_greedy(params, prompt, steps: int, num_heads: int,
                 eos_id=None) -> np.ndarray:
    """Greedy decode of ``steps`` tokens after ``prompt`` ([B, T] ints),
    each step a full forward; with ``eos_id`` a row that emits it stays
    there.  Returns [B, T + steps] (numpy, the prompt's dtype)."""
    prompt = np.asarray(prompt)
    toks = prompt
    done = np.zeros(toks.shape[0], bool)
    for _ in range(steps):
        logits = dense_forward(params, toks, num_heads)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(prompt.dtype)
        if eos_id is not None:
            nxt = np.where(done, eos_id, nxt).astype(prompt.dtype)
            done = done | (nxt == eos_id)
        toks = np.concatenate([toks, nxt[:, None]], axis=1)
    return toks


def seq_logprob(params, toks, num_heads: int, prompt_len: int) -> np.ndarray:
    """Sum of log p(tok_i | prefix) over the generated positions, each at
    its model probability (eos repeats included): compare only with beams
    run without ``eos_id``."""
    toks = np.asarray(toks)
    B, total = toks.shape
    lp = np.zeros(B)
    for i in range(prompt_len, total):
        logits = dense_forward(params, toks[:, :i], num_heads)
        logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
        lp += logp[np.arange(B), toks[:, i]]
    return lp


def setup(seed: int = 0, vocab: int = 64, embed: int = 32, depth: int = 2,
          num_heads: int = 8, B: int = 2, Tp: int = 4, device="cuda"):
    """A tree from ``init_tp_lm`` (its generator seeded with ``seed``) and
    a [B, Tp] int32 prompt from ``RandomState(seed + 1)``."""
    from .layers import check_device

    device = check_device(device)
    g = torch.Generator(device).manual_seed(seed)
    params = init_tp_lm(g, vocab=vocab, embed=embed, depth=depth,
                        num_heads=num_heads, device=device)
    prompt = np.random.RandomState(seed + 1).randint(
        0, vocab, size=(B, Tp)).astype(np.int32)
    return params, prompt
