"""Expert parallelism: the top-k all-to-all Mixture-of-Experts layer.

The PyTorch counterpart of ``torchmpi_tpu/parallel/expert.py``.  Every rank
of an expert group holds ``e_local`` experts (the expert dim is sharded
over the group's ranks); a gate projection routes each token to its top-k
experts, the tokens are packed into fixed-capacity per-expert buffers
(:func:`topk_dispatch`; overflow routes drop, the capacity-factor trade),
exchanged with one all-to-all, processed by the owning ranks' experts, and
returned by the inverse all-to-all; each token's k routes are gathered,
weighted by the gate and summed.  k = 1 scales by the raw top-1
probability (Switch); k >= 2 by the top-k probabilities renormalized over
the selected experts (GShard).  :func:`load_balance_loss` is the Switch
auxiliary loss.

Conventions carried over from the JAX module, so that the two agree bit
for bit on the same probabilities:

- Top-k ties go to the lower expert index, as ``lax.top_k`` breaks them: a
  stable descending sort, its first k (``torch.topk`` promises no order).
- Slots fill route-rank-major (GShard priority): every token's first
  choice claims a slot before any token's second choice, by an int32
  cumulative count over the routes in that order.
- ``valid = slot < capacity``; an overflow route is clamped to slot
  ``capacity - 1`` and adds zeros there, never overwriting the occupant.
  So every collision of the scatter-add (and of the combine's backward)
  adds a zero, and the card's atomics give the same bits on every call.
- ``capacity = max(1, int(capacity_factor * T * k / E))`` in Python float.
- The gate's logits and softmax are computed once and shared with the
  auxiliary loss.

Two forms, as ``parallel/sequence.py`` has them:

- :func:`moe_layer`, over an axis of the process world (``axis_name`` as
  the in-axis verbs take it: "ici", "dcn", or both / None for the world):
  this rank's tokens ``[T, D]`` and its own ``e_local`` experts; the
  exchange is ``collectives.alltoall_in_axis_grad``, whose backward is the
  inverse all-to-all.
- :func:`moe_layer_rank_major`, the port's stand-in for ``shard_map``: the
  tokens of every rank on one device, ``[n, T, D]`` (one expert group of n
  ranks) or ``[n_dcn, n_ici, T, D]`` with the groups over ``axis_name``
  (the ranks of the other axis hold the same experts: data-parallel
  replicas), and all ``E`` experts' parameters.  The gate, the dispatch
  and the combine run once for all ranks; the exchange is
  ``collectives.alltoall_rank_major`` with the other axis folded into a
  middle dim; then each global expert's queues from every rank are
  gathered, so that ``expert_fn`` runs once over all ``E`` experts (one
  batched product a matrix) and no rank's copy of the weights is made.

``expert_fn(params, tokens)`` applies a batch of experts at once: each
leaf of ``params`` has the expert dim leading, ``tokens`` is ``[e, rows,
D]``, and it returns ``[e, rows, D]`` (the port's form of the JAX layer's
``vmap`` over a one-expert function).  Nothing here reads a tensor on the
host: shapes are static and no step waits for the card.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .. import _tree, collectives


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last dim: values and indices, descending, ties
    broken by the lower index."""
    p, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return p[..., :k], e[..., :k]


def _lead_base(lead, stride: int, device) -> torch.Tensor:
    """The flat offset ``i * stride`` of each leading index, shaped ``[*lead,
    1, 1]``."""
    return (torch.arange(math.prod(lead), device=device) * stride).view(
        *lead, 1, 1)


def topk_dispatch(x: torch.Tensor, gate_logits: torch.Tensor,
                  n_experts_global: int, capacity: int, k: int, *,
                  renormalize: bool = True,
                  probs: Optional[torch.Tensor] = None):
    """Pack tokens into per-expert capacity slots along their top-k routes
    (JAX :30-70).

    x ``[..., T, D]``; gate_logits ``[..., T, E]`` (``probs``, the softmax,
    when given instead).  Leading dims are independent ranks.  Returns
    (buffers ``[..., E, capacity, D]``, combine weights ``[..., T, k]``,
    experts ``[..., T, k]``, slots ``[..., T, k]`` int32, valid ``[..., T,
    k]``)."""
    T, D = x.shape[-2:]
    lead = x.shape[:-2]
    E, C = n_experts_global, capacity
    if probs is None:
        probs = torch.softmax(gate_logits, dim=-1)
    topk_p, topk_e = _top_k(probs, k)
    combine_w = (topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
                 if renormalize else topk_p)
    # All rank-0 routes first, then the rank-1 routes, ...: the running
    # per-expert count gives every primary route its slot first.
    routes = topk_e.transpose(-1, -2).reshape(*lead, k * T)
    onehot = (routes[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)
    pos = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - 1
    slot_flat = pos.gather(-1, routes[..., None])[..., 0]
    slot_of = slot_flat.view(*lead, k, T).transpose(-1, -2)
    valid = slot_of < C
    safe_slot = torch.where(valid, slot_of, C - 1)
    src = torch.where(valid[..., None], x[..., :, None, :], 0.0)
    idx = _lead_base(lead, E * C, x.device) + topk_e * C + safe_slot
    buffers = x.new_zeros(math.prod(lead) * E * C, D).index_add(
        0, idx.reshape(-1), src.reshape(-1, D))
    return (buffers.view(*lead, E, C, D), combine_w, topk_e, slot_of, valid)


def _combine(returned: torch.Tensor, combine_w, expert_of, slot_of,
             valid) -> torch.Tensor:
    """Each token's k processed rows from ``returned`` ``[..., E, C, D]``,
    masked, weighted and summed (JAX :145-147): ``[..., T, D]``."""
    lead = returned.shape[:-3]
    E, C, D = returned.shape[-3:]
    idx = (_lead_base(lead, E * C, returned.device) + expert_of * C
           + torch.where(valid, slot_of, 0))
    rows = returned.reshape(-1, D).index_select(0, idx.reshape(-1)).view(
        *idx.shape, D)
    rows = torch.where(valid[..., None], rows, 0.0)
    return (rows * combine_w[..., None]).sum(dim=-2)


def load_balance_loss(gate_logits: torch.Tensor, expert_of: torch.Tensor,
                      n_experts: int, *,
                      probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Switch auxiliary load-balancing loss of one rank's tokens, ``E *
    sum_e f_e P_e`` (JAX :73-89): ``f_e`` the share of routes sent to expert
    e, ``P_e`` the mean router probability.  1.0 under uniform routing,
    about E when routing collapses.  ``expert_of`` ``[..., T]`` or ``[...,
    T, k]``; leading dims give one loss each.  Scale (typically 1e-2) and
    add to the task loss."""
    if probs is None:
        probs = torch.softmax(gate_logits, dim=-1)
    P = probs.mean(dim=-2)
    if expert_of.dim() == probs.dim() - 1:
        expert_of = expert_of[..., None]
    routes = expert_of.reshape(*expert_of.shape[:-2], -1)
    f = (routes[..., None] == torch.arange(n_experts,
                                           device=routes.device)).to(
        P.dtype).mean(dim=-2)
    return n_experts * (f * P).sum(dim=-1)


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"moe_layer needs k >= 1 experts per token, "
                         f"got {k}")


def _capacity(capacity_factor: float, T: int, k: int, E: int) -> int:
    return max(1, int(capacity_factor * T * k / E))


def _n_experts(expert_params) -> int:
    leaves, _ = _tree.flatten(expert_params)
    return leaves[0].shape[0]


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor, expert_fn: Callable,
              expert_params, axis_name=None, *,
              capacity_factor: float = 2.0, k: int = 1,
              return_aux: bool = False):
    """Top-k expert-parallel MoE over ``axis_name`` of the process world
    (JAX :92-151).

    x ``[T, D]`` this rank's tokens; gate_w ``[D, E]`` (E = the axis size
    times ``e_local``), the same on every rank; ``expert_params`` this
    rank's ``e_local`` experts (leaves ``[e_local, ...]``).  Returns
    ``[T, D]``, and with ``return_aux`` also this rank's
    :func:`load_balance_loss`.  ``capacity_factor * T * k / E`` slots per
    expert and source rank."""
    _check_k(k)
    n = collectives.axis_size(axis_name)
    T, D = x.shape
    e_local = _n_experts(expert_params)
    E = n * e_local
    C = _capacity(capacity_factor, T, k, E)
    gate_logits = x @ gate_w
    probs = torch.softmax(gate_logits, dim=-1)
    buffers, gate, expert_of, slot_of, valid = topk_dispatch(
        x, gate_logits, E, C, k, renormalize=k > 1, probs=probs)
    # dispatched[s * e_local + j]: source s's buffer for local expert j.
    dispatched = collectives.alltoall_in_axis_grad(
        buffers, axis_name, split_axis=0, concat_axis=0)
    queues = dispatched.view(n, e_local, C, D).transpose(0, 1).reshape(
        e_local, n * C, D)
    processed = expert_fn(expert_params, queues)
    packed = processed.view(e_local, n, C, D).transpose(0, 1).reshape(
        E, C, D)
    returned = collectives.alltoall_in_axis_grad(
        packed, axis_name, split_axis=0, concat_axis=0)
    out = _combine(returned, gate, expert_of, slot_of, valid)
    if return_aux:
        return out, load_balance_loss(gate_logits, expert_of, E, probs=probs)
    return out


def grid_axis_size(axis_name, n_dcn: int, n_ici: int) -> int:
    """The ranks ``axis_name`` ("dcn", "ici", both or None) spans on the
    grid (n_dcn, n_ici) of a two-level rank-major stack."""
    axis = collectives._world_axes("moe_layer_rank_major", axis_name)
    return n_dcn * n_ici if axis is None else n_dcn if axis == "dcn" \
        else n_ici


def _experts_rank_major(buffers: torch.Tensor, expert_fn: Callable,
                        expert_params, axis: Optional[str], e_local: int
                        ) -> torch.Tensor:
    """The exchange and the experts of the rank-major layer: buffers
    ``[n_dcn, n_ici, E, C, D]`` -> the processed rows in the same layout,
    each at its source rank."""
    n_dcn, n_ici, E, C, D = buffers.shape
    # [G, M, E, C, D]: the expert group's ranks, and the other axis folded
    # into a middle dim.
    if axis is None:
        stack = buffers.reshape(n_dcn * n_ici, 1, E, C, D)
    elif axis == "ici":
        stack = buffers.transpose(0, 1)
    else:
        stack = buffers
    G, M = stack.shape[:2]
    # recv[i][m, s * e_local + j]: source s's buffer for rank i's expert j.
    recv = collectives.alltoall_rank_major(stack, split_axis=1,
                                           concat_axis=1)
    # Global expert i * e_local + j: its queues from every rank.
    queues = recv.view(G, M, G, e_local, C, D).permute(0, 3, 1, 2, 4, 5) \
        .reshape(E, M * G * C, D)
    processed = expert_fn(expert_params, queues)
    back = processed.view(G, e_local, M, G, C, D).permute(0, 2, 3, 1, 4, 5) \
        .reshape(G, M, E, C, D)
    returned = collectives.alltoall_rank_major(back, split_axis=1,
                                               concat_axis=1)
    if axis is None:
        return returned.view(n_dcn, n_ici, E, C, D)
    if axis == "ici":
        return returned.transpose(0, 1)
    return returned


def moe_layer_rank_major(x: torch.Tensor, gate_w: torch.Tensor,
                         expert_fn: Callable, expert_params, axis_name=None,
                         *, capacity_factor: float = 2.0, k: int = 1,
                         return_aux: bool = False):
    """:func:`moe_layer` for every rank at once on one device.

    x ``[n, T, D]`` (the grid 1 x n) or ``[n_dcn, n_ici, T, D]``; the
    expert groups span ``axis_name`` of that grid ("ici": each dcn row's
    ranks, "dcn", or both / None: every rank), each of its G ranks holding
    ``E / G`` experts.  ``expert_params``: all E experts (leaves ``[E,
    ...]``, global expert ``i * E / G + j`` on rank i of its group).
    Returns the outputs shaped as ``x``, and with ``return_aux`` each
    rank's :func:`load_balance_loss` (``x``'s leading dims), each rank's as
    the process-world form computes it."""
    _check_k(k)
    if x.dim() not in (3, 4):
        raise ValueError(f"expected x [n, T, D] or [n_dcn, n_ici, T, D], "
                         f"got {tuple(x.shape)}")
    lead = x.shape[:-2]
    x4 = x if x.dim() == 4 else x[None]
    n_dcn, n_ici, T, D = x4.shape
    axis = collectives._world_axes("moe_layer_rank_major", axis_name)
    G = grid_axis_size(axis_name, n_dcn, n_ici)
    E = _n_experts(expert_params)
    if E % G:
        raise ValueError(f"{E} experts do not split over the {G} ranks of "
                         f"{axis_name!r}")
    C = _capacity(capacity_factor, T, k, E)
    gate_logits = x4 @ gate_w
    probs = torch.softmax(gate_logits, dim=-1)
    buffers, gate, expert_of, slot_of, valid = topk_dispatch(
        x4, gate_logits, E, C, k, renormalize=k > 1, probs=probs)
    returned = _experts_rank_major(buffers, expert_fn, expert_params, axis,
                                   E // G)
    out = _combine(returned, gate, expert_of, slot_of, valid).view(*lead, T,
                                                                   D)
    if return_aux:
        aux = load_balance_loss(gate_logits, expert_of, E, probs=probs)
        return out, aux.view(lead)
    return out
