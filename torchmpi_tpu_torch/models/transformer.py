"""Decoder-only Transformer LM with local or flash attention.

The PyTorch counterpart of ``torchmpi_tpu/models/transformer.py``:
``apply_rope`` (:39), ``SPAttention`` (:65), ``Block`` (:369) with the dense
MLP, and ``TransformerLM`` (:407) with learned or RoPE positions.  The
numerics follow the flax modules the JAX package builds on:

- Dense layers hold float32 parameters; with ``dtype=torch.bfloat16`` both
  the input and the weight are cast to bf16 before the product (flax's
  ``promote_dtype``), and so is the bias.
- q, k and v are cast to float32 before attention, and the attention output
  back to ``dtype`` (:108-117, :302): the flash kernels take float32.
- LayerNorm computes in float32 with epsilon 1e-6 and the one-pass variance
  E[x^2] - E[x]^2 (flax's ``use_fast_variance``).
- GELU is the tanh approximation (flax ``nn.gelu``'s default).
- RoPE rotates the two halves of the head dim, angles in float32.

Parameter names follow the flax tree through ``weights.from_flax_params``.
Every module builds its parameters on ``device``: the card by default,
the CPU only when the caller passes ``device="cpu"``; without a visible
card the default raises.  Autoregressive decode, the sequence-parallel
attentions (ring, ulysses) and the MoE MLP are later slices of the port
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash import _gqa_group, flash_attention_grad
from ..parallel.sequence import reference_attention
from .layers import Dense, check_device

_LATER_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")


def apply_rope(x: torch.Tensor, pos: torch.Tensor, *,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding: rotate the halves of ``x``'s head dim
    ([B, T, H, D], D even) by angles ``pos[t] * base**(-2i/D)``.  ``pos`` is
    [T] (shared across the batch) or [B, T] (one position per row)."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"rope requires an even head_dim, got {D}")
    half = D // 2
    # Built on pos's device: a host-made table would cost one blocking
    # copy to the card per call.
    inv = torch.pow(base, -torch.arange(half, dtype=torch.float32,
                                        device=pos.device) / half)
    ang = pos.to(torch.float32)[..., None] * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics in float32,
    epsilon 1e-6, variance as E[x^2] - E[x]^2 clipped at 0."""

    def __init__(self, dim: int, *, eps: float = 1e-6, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class SPAttention(nn.Module):
    """Causal self-attention, ``attn_impl`` "local" (the dense oracle) or
    "flash" (the hand-written kernels), with optional sliding ``window``,
    grouped-query ``num_kv_heads`` and ``rope``."""

    def __init__(self, embed: int, num_heads: int, head_dim: int, *,
                 attn_impl: str = "local",
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 device="cuda"):
        super().__init__()
        if attn_impl in _LATER_IMPLS:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: sequence-parallel attention is a "
                "later slice of the port (ROADMAP queue A, item 8)")
        if attn_impl not in ("local", "flash"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = (num_kv_heads if num_kv_heads is not None
                             else num_heads)
        self.attn_impl, self.dtype = attn_impl, dtype
        self.window, self.rope = window, rope
        H, Hkv, D = num_heads, self.num_kv_heads, head_dim
        kw = dict(dtype=dtype, device=device)
        if Hkv != H:
            _gqa_group(H, Hkv)  # validates divisibility
            self.q = Dense(embed, H * D, **kw)
            self.kv = Dense(embed, 2 * Hkv * D, **kw)
        else:
            self.qkv = Dense(embed, 3 * H * D, **kw)
        self.out = Dense(H * D, embed, **kw)

    def forward(self, x: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        B, T, _ = x.shape
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        if Hkv != H:
            q = self.q(x).view(B, T, H, D).float()
            kv = self.kv(x).view(B, T, 2, Hkv, D)
            k, v = kv[:, :, 0].float(), kv[:, :, 1].float()
        else:
            qkv = self.qkv(x).view(B, T, 3, H, D)
            q, k, v = (qkv[:, :, i].float() for i in range(3))
        if self.rope:
            rpos = pos_offset + torch.arange(T, device=x.device)
            q = apply_rope(q, rpos)
            k = apply_rope(k, rpos)
        if self.attn_impl == "local":
            o = reference_attention(q, k, v, causal=True, window=self.window)
        else:
            o = flash_attention_grad(q, k, v, causal=True,
                                     window=self.window)
        return self.out(o.to(self.dtype).reshape(B, T, H * D))


class Block(nn.Module):
    """Pre-LN transformer block: attention, then the dense GELU MLP."""

    def __init__(self, embed: int, num_heads: int, head_dim: int, *,
                 mlp_ratio: int = 4, attn_impl: str = "local",
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 device="cuda"):
        super().__init__()
        self.ln1 = LayerNorm(embed, device=device)
        self.attn = SPAttention(embed, num_heads, head_dim,
                                attn_impl=attn_impl, dtype=dtype,
                                window=window, num_kv_heads=num_kv_heads,
                                rope=rope, device=device)
        self.ln2 = LayerNorm(embed, device=device)
        self.mlp_in = Dense(embed, embed * mlp_ratio, dtype=dtype,
                            device=device)
        self.mlp_out = Dense(embed * mlp_ratio, embed, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), pos_offset)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """Causal LM: embedding, ``depth`` blocks, final LayerNorm, and a
    bias-free float32 ``head`` [embed, vocab] (``x @ head``).

    Parameters are float32 on ``device`` (default the card) and drawn from
    ``generator`` (a seeded ``torch.Generator`` on that device) or, with
    none given, from a generator seeded with 0: fan-in-scaled normals for
    weights, zeros for biases, ones for LayerNorm scales."""

    def __init__(self, vocab: int = 256, embed: int = 128, depth: int = 2,
                 num_heads: int = 8, head_dim: int = 16, max_len: int = 4096,
                 attn_impl: str = "local",
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 pos_emb: str = "learned", *, decode: bool = False,
                 seq_axis=None, moe_axis=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decode:
            raise NotImplementedError(
                "decode=True: KV-cache decoding is a later slice of the "
                "port (ROADMAP queue A, item 9)")
        if seq_axis is not None or moe_axis is not None:
            raise NotImplementedError(
                "seq_axis / moe_axis: sequence- and expert-parallel layers "
                "are later slices of the port (ROADMAP queue A, item 8)")
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {pos_emb!r}")
        device = check_device(device)
        self.vocab, self.embed_dim, self.dtype = vocab, embed, dtype
        self.pos_emb = pos_emb
        self.embed = nn.Embedding(vocab, embed, device=device)
        if pos_emb == "learned":
            self.pos_embed = nn.Embedding(max_len, embed, device=device)
        self.blocks = nn.ModuleList(
            Block(embed, num_heads, head_dim, attn_impl=attn_impl,
                  dtype=dtype, window=window, num_kv_heads=num_kv_heads,
                  rope=pos_emb == "rope", device=device)
            for _ in range(depth))
        self.ln_f = LayerNorm(embed, device=device)
        self.head = nn.Parameter(torch.empty(embed, vocab, device=device))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        g = generator
        if g is None:
            g = torch.Generator(self.head.device).manual_seed(0)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Dense):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=g)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=g)
        self.head.normal_(0.0, 1.0 / math.sqrt(self.embed_dim), generator=g)

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0,
                return_prehead: bool = False):
        B, T = tokens.shape
        x = self.embed(tokens).to(self.dtype)
        if self.pos_emb == "learned":
            pos = pos_offset + torch.arange(T, device=tokens.device)
            x = x + self.pos_embed(pos).to(self.dtype)[None]
        for blk in self.blocks:
            x = blk(x, pos_offset)
        x = self.ln_f(x)
        if return_prehead:
            return x, self.head
        return x @ self.head
