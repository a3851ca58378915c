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

Decode (JAX :122-279): :meth:`TransformerLM.init_cache` builds the KV
cache, a :class:`KVCache` held by the caller (flax's ``"cache"``
collection): per layer k and v, float32 ``[rows, max_len, Hkv, D]`` (the
GQA cache keeps only the kv heads), and ``idx``, the next write position
of the scalar-offset path.  ``model(tokens, pos_offset, cache=cache)``
reads the cache and writes into it in place:

- an int ``pos_offset`` (the prefills, ``beam_search``'s steps) writes
  at ``cache.idx`` and advances it; a block of T > 1 tokens there is the
  fresh-cache prefill, causal attention within the block (JAX :212-227);
- a 1-D ``pos_offset`` [rows] gives every row its own position
  (``generate``'s steps, the continuous-batching slot step; with T > 1
  the speculative verify rows, JAX :220-224): each row writes at its own
  depth and attends through the per-row causal mask, so a reused row is
  bitwise a fresh one.

RoPE rotates q and k at their absolute cache positions before the write
(JAX :193-200), the sliding window bands the cache mask (:246-252), and
every write goes through ``generate.clamp_slot_positions``, the clamped
start of JAX's ``dynamic_update_slice`` (ROADMAP queue C note 1).  Decode
attends through einsums against the cache, never the flash kernels
(``"flash"`` is an alias of ``"local"`` there, as in JAX).  A model built
with ``decode=True`` requires the cache.  Ring impls have no decode path;
Ulysses and MoE decode are ROADMAP queue A, item 9 (b).

Parameter names follow the flax tree through ``weights.from_flax_params``.
Every module builds its parameters on ``device``: the card by default,
the CPU only when the caller passes ``device="cpu"``; without a visible
card the default raises.
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
from .generate import clamp_slot_positions
from .layers import Dense, check_device

SP_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")


def check_decode(attn_impl: str, seq_axis=None, moe_axis=None) -> None:
    """JAX's refusals of a decode the port cannot run: ring impls (their
    sequence-sharded cache cannot serve one new token a step), Ulysses
    decode under ``seq_axis`` and MoE decode (the mesh-parallel decoders
    of ROADMAP queue A, item 9 (b))."""
    if moe_axis is not None:
        raise ValueError(
            "generate() supports dense MLPs only: moe_axis routing needs "
            "a mesh axis; expert-parallel decode (generate_parallel) is "
            "ROADMAP queue A, item 9 (b)")
    if attn_impl.startswith("ulysses") and seq_axis is not None:
        raise ValueError(
            "ulysses decode needs the mesh axis in scope; the "
            "head-sharded-cache decode (generate_parallel) is ROADMAP "
            "queue A, item 9 (b)")
    if attn_impl not in ("local", "flash"):
        raise ValueError(
            f"decode=True supports attn_impl='local'/'flash' (or "
            f"'ulysses' under generate_parallel), got {attn_impl!r}")


class KVCache:
    """The decode cache of a :class:`TransformerLM` (JAX's ``"cache"``
    collection): ``k[i]`` and ``v[i]`` float32 ``[rows, max_len, Hkv, D]``
    for layer i, and ``idx``, the next write position of the
    scalar-offset path (a host int; JAX's per-layer ``idx``, equal in
    every layer).  The forward writes into the tensors in place."""

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor],
                 idx: int = 0):
        self.k, self.v, self.idx = list(k), list(v), int(idx)

    @property
    def rows(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.k + self.v)

    def index_rows(self, rows: torch.Tensor) -> "KVCache":
        """A new cache of the rows ``rows`` (a [n] index tensor): the
        beam search's tiling and parent gather."""
        return KVCache([t[rows] for t in self.k], [t[rows] for t in self.v],
                       self.idx)


class _DecodeStep:
    """What every layer of one decode forward shares, each made once: the
    clamped write start (``start``: an int, or ``None`` per row), each
    query's absolute position ``q_pos`` ([T], or [rows, T] per row),
    whether the block is the fresh-cache prefill, the RoPE tables of
    ``q_pos`` and the cache mask."""

    def __init__(self, q_pos: torch.Tensor, start: Optional[int],
                 window: Optional[int]):
        self.q_pos, self.start, self.window = q_pos, start, window
        self.prefill = start is not None and q_pos.shape[-1] > 1
        self._rope, self._mask = None, None
        if start is None:
            self.rows = torch.arange(q_pos.shape[0],
                                     device=q_pos.device)[:, None]

    def rope(self, D: int):
        if self._rope is None:
            self._rope = rope_tables(self.q_pos, D)
        return self._rope

    def mask(self, max_len: int) -> torch.Tensor:
        """Causal (and banded) mask over the cache: [1, T, max_len], or
        [rows, T, max_len] per row."""
        if self._mask is None:
            kv_pos = torch.arange(max_len, device=self.q_pos.device)
            q = self.q_pos[..., None]
            mask = kv_pos <= q
            if self.window is not None:
                mask &= kv_pos > q - self.window
            self._mask = mask if self.start is None else mask[None]
        return self._mask


def rope_tables(pos: torch.Tensor, D: int, *, base: float = 10000.0):
    """cos and sin of :func:`apply_rope`'s angles for positions ``pos``
    ([T] or [B, T]) and head dim ``D``: each [..., T, 1, D / 2]."""
    if D % 2:
        raise ValueError(f"rope requires an even head_dim, got {D}")
    half = D // 2
    # Built on pos's device: a host-made table would cost one blocking
    # copy to the card per call.
    inv = torch.pow(base, -torch.arange(half, dtype=torch.float32,
                                        device=pos.device) / half)
    ang = pos.to(torch.float32)[..., None] * inv
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, *,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding: rotate the halves of ``x``'s head dim
    ([B, T, H, D], D even) by angles ``pos[t] * base**(-2i/D)``.  ``pos`` is
    [T] (shared across the batch) or [B, T] (one position per row)."""
    return _rotate(x, *rope_tables(pos, x.shape[-1], base=base))


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
                seq_grid=None, kv=None) -> torch.Tensor:
        """``x`` [B, T, E]; ``pos_offset`` the global position of x[:, 0]
        (an int, or a [B, 1] tensor of each row's).  ``seq_grid`` (n_dcn,
        n_ici): ``x`` holds the rank-major ranks folded into the batch in
        (dcn, ici, batch) order, and the sequence-parallel impls attend
        over the ici ranks (:meth:`TransformerLM.forward_rank_major`).
        ``kv`` (this layer's cache k, v and the forward's
        :class:`_DecodeStep`): the decode step of JAX :150-275."""
        B, T, _ = x.shape
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        if Hkv != H:
            q = self.q(x).view(B, T, H, D).float()
            kvp = self.kv(x).view(B, T, 2, Hkv, D)
            k, v = kvp[:, :, 0].float(), kvp[:, :, 1].float()
        else:
            qkv = self.qkv(x).view(B, T, 3, H, D)
            q, k, v = (qkv[:, :, i].float() for i in range(3))
        if kv is not None:
            o = self._decode(q, k, v, *kv)
        else:
            if self.rope:
                rpos = pos_offset + torch.arange(T, device=x.device)
                q = apply_rope(q, rpos)
                k = apply_rope(k, rpos)
            o = self._attend(q, k, v, seq_grid)
        return self.out(o.to(self.dtype).reshape(B, T, H * D))

    def _decode(self, q, k, v, ck, cv, step: _DecodeStep):
        """Write k and v into the cache at their positions, then attend:
        the fresh-cache prefill within its block, else q against the
        whole cache through the causal mask (JAX :185-275)."""
        B, T, H, D = q.shape
        if self.rope:
            # Rotate at absolute cache positions, then cache: old entries
            # never need re-rotation.
            q = _rotate(q, *step.rope(D))
            k = _rotate(k, *step.rope(D))
        if step.start is None:
            ck[step.rows, step.q_pos] = k
            cv[step.rows, step.q_pos] = v
        else:
            ck[:, step.start:step.start + T] = k
            cv[:, step.start:step.start + T] = v
        if step.prefill:
            return seqlib.reference_attention(q, k, v, causal=True,
                                              window=self.window)
        mask = step.mask(ck.shape[1])
        hc = ck.shape[2]
        if hc != H:
            # GQA: group the einsum rather than repeat the cache.
            qg = q.reshape(B, T, hc, H // hc, D)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck) / (D ** 0.5)
            s.masked_fill_(~mask[:, None, None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bhgqk,bkhd->bqhgd", p, cv).reshape(
                B, T, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", q, ck) / (D ** 0.5)
        s.masked_fill_(~mask[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, cv)

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
                seq_grid=None, kv=None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), pos_offset, seq_grid, kv)
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
    ``gate``).

    ``decode=True`` makes the forward's ``cache`` required (see the
    module's note on decode); any local or flash model decodes when given
    a cache."""

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
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {pos_emb!r}")
        if decode:
            check_decode(attn_impl, seq_axis, moe_axis)
        device = check_device(device)
        self.vocab, self.embed_dim, self.dtype = vocab, embed, dtype
        self.pos_emb, self.attn_impl = pos_emb, attn_impl
        self.seq_axis, self.moe_axis = seq_axis, moe_axis
        self.decode, self.max_len, self.window = decode, max_len, window
        self.num_kv_heads = (num_kv_heads if num_kv_heads is not None
                             else num_heads)
        self.head_dim = head_dim
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

    def init_cache(self, rows: int, max_len: Optional[int] = None
                   ) -> KVCache:
        """A zero decode cache of ``rows`` rows, ``max_len`` positions each
        (default the model's), on the model's device."""
        L = int(max_len if max_len is not None else self.max_len)
        if L <= 0:
            raise ValueError("decode=True needs max_len > 0")
        shape = (int(rows), L, self.num_kv_heads, self.head_dim)
        dev = self.head.device
        return KVCache(
            [torch.zeros(shape, device=dev) for _ in self.blocks],
            [torch.zeros(shape, device=dev) for _ in self.blocks])

    def forward(self, tokens: torch.Tensor, pos_offset=0,
                return_prehead: bool = False,
                cache: Optional[KVCache] = None):
        """Logits [B, T, vocab] of ``tokens`` [B, T] (or, with
        ``return_prehead``, the final LayerNorm's output and the head).
        With ``seq_axis``, ``tokens`` is this rank's shard and
        ``pos_offset`` its global start.  With ``cache``, a decode step
        (see the module's note): ``pos_offset`` an int, or a [B] tensor
        of each row's position."""
        if cache is not None:
            x = self._decode_trunk(tokens, pos_offset, cache)
        elif self.decode:
            raise ValueError(
                "decode=True: the forward reads and writes a KV cache; "
                "pass cache=model.init_cache(rows)")
        else:
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

    def _decode_trunk(self, tokens: torch.Tensor, pos_offset,
                      cache: KVCache) -> torch.Tensor:
        """The decode forward's embeddings, blocks (each reading and
        writing its layer of ``cache``) and final LayerNorm."""
        check_decode(self.attn_impl, self.seq_axis, self.moe_axis)
        B, T = tokens.shape
        if B != cache.rows or len(cache.k) != len(self.blocks):
            raise ValueError(
                f"cache of {cache.rows} rows x {len(cache.k)} layers for "
                f"tokens of {B} rows through {len(self.blocks)} blocks")
        L, dev = cache.max_len, tokens.device
        t = torch.arange(T, device=dev)
        per_row = torch.is_tensor(pos_offset) and pos_offset.dim() == 1
        if per_row:
            starts = clamp_slot_positions(pos_offset, L, T)
            step = _DecodeStep(starts[:, None] + t, None, self.window)
        else:
            start = clamp_slot_positions(cache.idx, L, T)
            step = _DecodeStep(start + t, start, self.window)
        x = self.embed(tokens).to(self.dtype)
        if self.pos_emb == "learned":
            pos = (pos_offset[:, None] + t if per_row
                   else pos_offset + t)
            x = x + self.pos_embed(pos).to(self.dtype)
        for blk, ck, cv in zip(self.blocks, cache.k, cache.v):
            x = blk(x, kv=(ck, cv, step))
        if not per_row:
            cache.idx = start + T
        return self.ln_f(x)

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
