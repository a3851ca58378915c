"""Decoder-only Transformer LM with local, flash or sequence-parallel
attention.

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

Sequence parallelism (``attn_impl`` "ring", "ring_flash", "ulysses",
"ulysses_flash" with ``seq_axis``; JAX :278-301): the sequence is sharded
over the ranks of ``seq_axis``.  In the process world each rank runs
``model(tokens_shard, pos_offset=axis_index * T_local)``.  Rank-major,
:meth:`TransformerLM.forward_rank_major` takes all ranks' shards at once
(``[n, B, T_local]``, or ``[n_dcn, n_ici, B, T_local]`` with the sequence
over ici and the batch over dcn): every position-wise layer runs once on
the ranks folded into the batch, rank r's positions starting at ``r *
T_local``, and only attention unfolds them into the ``[n, B, T_local, H,
D]`` stacks of ``parallel/sequence.py``'s rank-major forms.  The
sequence-parallel impls refuse grouped-query attention, as JAX's do.

Parameter names follow the flax tree through ``weights.from_flax_params``.
Every module builds its parameters on ``device``: the card by default,
the CPU only when the caller passes ``device="cpu"``; without a visible
card the default raises.  Autoregressive decode and the MoE MLP are later
slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash import _gqa_group, flash_attention_grad
from ..parallel import sequence as seqlib
from .layers import Dense, check_device

SP_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")


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
    """Causal self-attention, ``attn_impl`` "local" (the dense oracle),
    "flash" (the hand-written kernels), or sequence-parallel over
    ``seq_axis`` ("ring", "ring_flash", "ulysses", "ulysses_flash"), with
    optional sliding ``window``, grouped-query ``num_kv_heads`` (local and
    flash only) and ``rope``."""

    def __init__(self, embed: int, num_heads: int, head_dim: int, *,
                 attn_impl: str = "local", seq_axis=None,
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 device="cuda"):
        super().__init__()
        if attn_impl not in ("local", "flash") + SP_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = (num_kv_heads if num_kv_heads is not None
                             else num_heads)
        self.attn_impl, self.seq_axis, self.dtype = attn_impl, seq_axis, dtype
        self.window, self.rope = window, rope
        H, Hkv, D = num_heads, self.num_kv_heads, head_dim
        kw = dict(dtype=dtype, device=device)
        if Hkv != H:
            _gqa_group(H, Hkv)  # validates divisibility
            if attn_impl not in ("local", "flash"):
                raise ValueError(
                    f"num_kv_heads= supports attn_impl='local'/'flash' "
                    f"(got {attn_impl!r})")
            self.q = Dense(embed, H * D, **kw)
            self.kv = Dense(embed, 2 * Hkv * D, **kw)
        else:
            self.qkv = Dense(embed, 3 * H * D, **kw)
        self.out = Dense(H * D, embed, **kw)

    def forward(self, x: torch.Tensor, pos_offset=0,
                seq_grid=None) -> torch.Tensor:
        """``x`` [B, T, E]; ``pos_offset`` the global position of x[:, 0]
        (an int, or a [B, 1] tensor of each row's).  ``seq_grid`` (n_dcn,
        n_ici): ``x`` holds the rank-major ranks folded into the batch in
        (dcn, ici, batch) order, and the sequence-parallel impls attend
        over the ici ranks (:meth:`TransformerLM.forward_rank_major`)."""
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
        o = self._attend(q, k, v, seq_grid)
        return self.out(o.to(self.dtype).reshape(B, T, H * D))

    def _attend(self, q, k, v, seq_grid):
        impl, kw = self.attn_impl, dict(causal=True, window=self.window)
        if impl == "local":
            return seqlib.reference_attention(q, k, v, **kw)
        if impl == "flash":
            return flash_attention_grad(q, k, v, **kw)
        kw["block_impl"] = "flash" if impl.endswith("_flash") else "dense"
        ring = impl.startswith("ring")
        if seq_grid is None:
            fn = seqlib.ring_attention if ring else seqlib.ulysses_attention
            return fn(q, k, v, self.seq_axis, **kw)
        # Rank-major: [(dcn, ici, b), T, H, D] -> the ici stacks [n_ici,
        # (dcn, b), T, H, D], and back.
        n_dcn, n_ici = seq_grid
        rows, T = q.shape[:2]
        b = rows // (n_dcn * n_ici)

        def stack(t):
            t = t.reshape(n_dcn, n_ici, b, T, *t.shape[2:]).transpose(0, 1)
            return t.reshape(n_ici, n_dcn * b, T, *t.shape[4:])

        fn = (seqlib.ring_attention_rank_major if ring
              else seqlib.ulysses_attention_rank_major)
        o = fn(stack(q), stack(k), stack(v), **kw)
        o = o.reshape(n_ici, n_dcn, b, *o.shape[2:]).transpose(0, 1)
        return o.reshape(rows, *o.shape[3:])


class Block(nn.Module):
    """Pre-LN transformer block: attention, then the dense GELU MLP."""

    def __init__(self, embed: int, num_heads: int, head_dim: int, *,
                 mlp_ratio: int = 4, attn_impl: str = "local", seq_axis=None,
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 device="cuda"):
        super().__init__()
        self.ln1 = LayerNorm(embed, device=device)
        self.attn = SPAttention(embed, num_heads, head_dim,
                                attn_impl=attn_impl, seq_axis=seq_axis,
                                dtype=dtype,
                                window=window, num_kv_heads=num_kv_heads,
                                rope=rope, device=device)
        self.ln2 = LayerNorm(embed, device=device)
        self.mlp_in = Dense(embed, embed * mlp_ratio, dtype=dtype,
                            device=device)
        self.mlp_out = Dense(embed * mlp_ratio, embed, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor, pos_offset=0,
                seq_grid=None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), pos_offset, seq_grid)
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
        if moe_axis is not None:
            raise NotImplementedError(
                "moe_axis: the expert-parallel MLP is a later slice of the "
                "port (ROADMAP queue A, item 8 (b))")
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {pos_emb!r}")
        device = check_device(device)
        self.vocab, self.embed_dim, self.dtype = vocab, embed, dtype
        self.pos_emb, self.attn_impl = pos_emb, attn_impl
        self.seq_axis = seq_axis
        self.embed = nn.Embedding(vocab, embed, device=device)
        if pos_emb == "learned":
            self.pos_embed = nn.Embedding(max_len, embed, device=device)
        self.blocks = nn.ModuleList(
            Block(embed, num_heads, head_dim, attn_impl=attn_impl,
                  seq_axis=seq_axis, dtype=dtype, window=window,
                  num_kv_heads=num_kv_heads,
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
        """Logits [B, T, vocab] of ``tokens`` [B, T] (or, with
        ``return_prehead``, the final LayerNorm's output and the head).
        With ``seq_axis``, ``tokens`` is this rank's shard and
        ``pos_offset`` its global start."""
        x = self._trunk(tokens, pos_offset, None)
        if return_prehead:
            return x, self.head
        return x @ self.head

    def forward_rank_major(self, tokens: torch.Tensor,
                           return_prehead: bool = False):
        """The forward of every rank at once: ``tokens`` ``[n, B, T]`` (n
        sequence ranks) or ``[n_dcn, n_ici, B, T]`` (the sequence over ici,
        the batch over dcn); rank r of the sequence holds global positions
        ``r * T`` on.  Returns the logits ``[..., B, T, vocab]`` (or the
        pre-head outputs and the head), each rank's as
        ``forward(tokens[r], pos_offset=r * T)`` computes it in the process
        world.  The ranks are folded into the batch for every
        position-wise layer: one launch a layer for all of them."""
        if tokens.dim() == 3:
            n_dcn, n_ici = 1, tokens.shape[0]
        elif tokens.dim() == 4:
            n_dcn, n_ici = tokens.shape[:2]
            if self.attn_impl in SP_IMPLS and self.seq_axis != "ici":
                raise ValueError(
                    f"a [n_dcn, n_ici, B, T] stack shards the sequence over "
                    f"ici; the model's seq_axis is {self.seq_axis!r}")
        else:
            raise ValueError(f"expected tokens [n, B, T] or [n_dcn, n_ici, "
                             f"B, T], got {tuple(tokens.shape)}")
        lead, (B, T) = tokens.shape[:-2], tokens.shape[-2:]
        start = torch.arange(n_ici, device=tokens.device) * T
        offsets = start.view(1, n_ici, 1).expand(n_dcn, n_ici, B)
        x = self._trunk(tokens.reshape(-1, T), offsets.reshape(-1, 1),
                        (n_dcn, n_ici))
        x = x.view(*lead, B, T, x.shape[-1])
        if return_prehead:
            return x, self.head
        return x @ self.head

    def _trunk(self, tokens: torch.Tensor, pos_offset, seq_grid):
        """Embeddings, blocks and the final LayerNorm of ``tokens`` [rows,
        T]; ``pos_offset`` an int or a [rows, 1] tensor."""
        T = tokens.shape[1]
        x = self.embed(tokens).to(self.dtype)
        if self.pos_emb == "learned":
            pos = pos_offset + torch.arange(T, device=tokens.device)
            x = x + self.pos_embed(pos).to(self.dtype)
        for blk in self.blocks:
            x = blk(x, pos_offset, seq_grid)
        return self.ln_f(x)
