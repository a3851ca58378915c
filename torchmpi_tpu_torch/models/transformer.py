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

Expert parallelism (``moe_axis``; JAX :306-366): the MLP becomes
:class:`MoEMLP`, the top-k all-to-all layer of ``parallel/expert.py`` over
``moe_axis`` with ``moe_experts_per_device`` experts a rank.  Its
parameters are global (``gate`` [E, n_experts], ``w1`` [n_experts, E, H],
``w2`` [n_experts, H, E], float32, in flax's layout) and each rank takes
its slice, as JAX's note says; n_experts is ``moe_experts_per_device``
times ``moe_axis_size``, the size of ``moe_axis`` (by default the process
world's; a model for rank-major use names it).  The experts compute in
float32 whatever ``dtype`` is, on the block's float32 LayerNorm output,
and only their output is cast to ``dtype``.  In the process world each
rank runs ``model(tokens)`` on its own rows; rank-major,
:meth:`TransformerLM.forward_rank_major` runs every rank at once and only
the MoE layer unfolds the ranks (over the grid of the stack).  Where the
JAX model sows one load-balance loss per MoE layer into ``"losses"``, each
:class:`MoEMLP` keeps its last forward's (``aux``: a 0-d tensor in the
process world, ``[n]`` rank-major), and :meth:`TransformerLM.moe_aux_losses`
returns them in block order; training code scales their sum (typically
1e-2) into the loss.

Parameter names follow the flax tree through ``weights.from_flax_params``.
Every module builds its parameters on ``device``: the card by default,
the CPU only when the caller passes ``device="cpu"``; without a visible
card the default raises.  Autoregressive decode is a later slice of the
port and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import collectives, runtime
from ..ops.flash import _gqa_group, flash_attention_grad
from ..parallel import expert as eplib
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


def _experts(params, tokens: torch.Tensor) -> torch.Tensor:
    """JAX's expert ``tanh(tokens @ a) @ b`` (:350-352), for a batch of
    experts: tokens [e, rows, E], a [e, E, H], b [e, H, E]."""
    a, b = params
    return torch.tanh(tokens @ a) @ b


class MoEMLP(nn.Module):
    """The expert-parallel MLP (JAX :306-366): tokens routed over
    ``expert_axis`` by the all-to-all layer of ``parallel/expert.py``.

    The weights are global and each rank slices its ``experts_per_device``
    from ``axis_index(expert_axis) * experts_per_device``: compute and
    communication are expert-parallel, parameter memory is not sharded.
    ``axis_size`` is the size of ``expert_axis`` the weights are made for
    (None: the process world's, which needs the runtime)."""

    def __init__(self, embed: int, experts_per_device: int, *,
                 mlp_ratio: int = 4, expert_axis=None,
                 axis_size: Optional[int] = None,
                 capacity_factor: float = 2.0, k: int = 1,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = check_device(device)
        if axis_size is None:
            if not runtime.is_initialized():
                raise ValueError(
                    "moe_axis_size: the size of the expert axis is the "
                    "process world's unless given; start the runtime or "
                    "pass it (rank-major use)")
            axis_size = collectives.axis_size(expert_axis)
        self.experts_per_device, self.expert_axis = (experts_per_device,
                                                     expert_axis)
        self.axis_size, self.capacity_factor, self.k = (axis_size,
                                                        capacity_factor, k)
        self.dtype = dtype
        self.n_experts = n = experts_per_device * axis_size
        H = embed * mlp_ratio
        self.gate = nn.Parameter(torch.empty(embed, n, device=device))
        self.w1 = nn.Parameter(torch.empty(n, embed, H, device=device))
        self.w2 = nn.Parameter(torch.empty(n, H, embed, device=device))
        self.aux: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, seq_grid=None) -> torch.Tensor:
        """``x`` [B, T, E] (float32: the block's LayerNorm output); with
        ``seq_grid`` (n_dcn, n_ici) the rank-major ranks folded into the
        batch in (dcn, ici, batch) order."""
        B, T, E = x.shape
        n = (collectives.axis_size(self.expert_axis) if seq_grid is None
             else eplib.grid_axis_size(self.expert_axis, *seq_grid))
        if n != self.axis_size:
            raise ValueError(
                f"the MoE weights are made for {self.axis_size} ranks of "
                f"{self.expert_axis!r}; this call spans {n}")
        kw = dict(capacity_factor=self.capacity_factor, k=self.k,
                  return_aux=True)
        if seq_grid is None:
            e = self.experts_per_device
            start = collectives.axis_index(self.expert_axis) * e
            out, aux = eplib.moe_layer(
                x.reshape(B * T, E), self.gate, _experts,
                (self.w1[start:start + e], self.w2[start:start + e]),
                self.expert_axis, **kw)
        else:
            n_dcn, n_ici = seq_grid
            rows = B // (n_dcn * n_ici) * T
            out, aux = eplib.moe_layer_rank_major(
                x.reshape(n_dcn, n_ici, rows, E), self.gate, _experts,
                (self.w1, self.w2), self.expert_axis, **kw)
            aux = aux.reshape(-1)
        self.aux = aux
        return out.reshape(B, T, E).to(self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: attention, then the dense GELU MLP, or
    with ``moe_axis`` the expert-parallel :class:`MoEMLP`."""

    def __init__(self, embed: int, num_heads: int, head_dim: int, *,
                 mlp_ratio: int = 4, attn_impl: str = "local", seq_axis=None,
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 moe_axis=None, moe_experts_per_device: int = 1,
                 moe_capacity_factor: float = 2.0, moe_k: int = 1,
                 moe_axis_size: Optional[int] = None, device="cuda"):
        super().__init__()
        self.ln1 = LayerNorm(embed, device=device)
        self.attn = SPAttention(embed, num_heads, head_dim,
                                attn_impl=attn_impl, seq_axis=seq_axis,
                                dtype=dtype,
                                window=window, num_kv_heads=num_kv_heads,
                                rope=rope, device=device)
        self.ln2 = LayerNorm(embed, device=device)
        if moe_axis is not None:
            self.moe = MoEMLP(embed, moe_experts_per_device,
                              mlp_ratio=mlp_ratio, expert_axis=moe_axis,
                              axis_size=moe_axis_size,
                              capacity_factor=moe_capacity_factor, k=moe_k,
                              dtype=dtype, device=device)
        else:
            self.mlp_in = Dense(embed, embed * mlp_ratio, dtype=dtype,
                                device=device)
            self.mlp_out = Dense(embed * mlp_ratio, embed, dtype=dtype,
                                 device=device)

    def forward(self, x: torch.Tensor, pos_offset=0,
                seq_grid=None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), pos_offset, seq_grid)
        if hasattr(self, "moe"):
            return x + self.moe(self.ln2(x), seq_grid)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """Causal LM: embedding, ``depth`` blocks, final LayerNorm, and a
    bias-free float32 ``head`` [embed, vocab] (``x @ head``).

    Parameters are float32 on ``device`` (default the card) and drawn from
    ``generator`` (a seeded ``torch.Generator`` on that device) or, with
    none given, from a generator seeded with 0: fan-in-scaled normals for
    weights, zeros for biases, ones for LayerNorm scales.  The expert
    kernels take flax's fan-in of a 3-D kernel, which counts the expert
    dim: E * n_experts for ``w1``, H * n_experts for ``w2`` (E for
    ``gate``)."""

    def __init__(self, vocab: int = 256, embed: int = 128, depth: int = 2,
                 num_heads: int = 8, head_dim: int = 16, max_len: int = 4096,
                 attn_impl: str = "local",
                 dtype: torch.dtype = torch.float32,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 pos_emb: str = "learned", *, decode: bool = False,
                 seq_axis=None, moe_axis=None,
                 moe_experts_per_device: int = 1,
                 moe_capacity_factor: float = 2.0, moe_k: int = 1,
                 moe_axis_size: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decode:
            raise NotImplementedError(
                "decode=True: KV-cache decoding is a later slice of the "
                "port (ROADMAP queue A, item 9)")
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
                  rope=pos_emb == "rope", moe_axis=moe_axis,
                  moe_experts_per_device=moe_experts_per_device,
                  moe_capacity_factor=moe_capacity_factor, moe_k=moe_k,
                  moe_axis_size=moe_axis_size, device=device)
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
            elif isinstance(m, MoEMLP):
                n, E, H = m.w1.shape
                m.gate.normal_(0.0, 1.0 / math.sqrt(E), generator=g)
                m.w1.normal_(0.0, 1.0 / math.sqrt(E * n), generator=g)
                m.w2.normal_(0.0, 1.0 / math.sqrt(H * n), generator=g)
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

    def moe_aux_losses(self) -> List[torch.Tensor]:
        """The load-balance loss of each MoE layer's last forward, in block
        order (JAX's sown ``"losses"``): a 0-d tensor each in the process
        world, ``[n]`` (one a rank) after :meth:`forward_rank_major`."""
        return [blk.moe.aux for blk in self.blocks if hasattr(blk, "moe")]

    def forward_rank_major(self, tokens: torch.Tensor,
                           return_prehead: bool = False):
        """The forward of every rank at once: ``tokens`` ``[n, B, T]`` (the
        grid 1 x n) or ``[n_dcn, n_ici, B, T]``.  With a sequence-parallel
        ``attn_impl`` the sequence is over ici and the batch over dcn: rank
        r of the sequence holds global positions ``r * T`` on, each rank's
        output as ``forward(tokens[r], pos_offset=r * T)`` computes it in
        the process world.  Otherwise every rank holds its own rows from
        position 0 (expert and data parallelism).  Returns the logits
        ``[..., B, T, vocab]`` (or the pre-head outputs and the head).  The
        ranks are folded into the batch for every position-wise layer: one
        launch a layer for all of them; only sequence-parallel attention
        and the MoE layer unfold them."""
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
        offsets = 0
        if self.attn_impl in SP_IMPLS:
            start = torch.arange(n_ici, device=tokens.device) * T
            offsets = start.view(1, n_ici, 1).expand(n_dcn, n_ici,
                                                     B).reshape(-1, 1)
        x = self._trunk(tokens.reshape(-1, T), offsets, (n_dcn, n_ici))
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
