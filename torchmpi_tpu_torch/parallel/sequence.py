"""Dense attention oracle and the causal / sliding-window mask.

The PyTorch counterpart of the parts of ``torchmpi_tpu/parallel/sequence.py``
that the single-device path uses: ``causal_window_mask`` (:76) and
``reference_attention`` (:309).  The sequence-parallel strategies (ring,
ulysses) wait for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """[Tq, Tk] bool: causal over global positions, optionally restricted
    to the sliding band ``q - k < window``."""
    keep = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        keep &= q_pos[:, None] - k_pos[None, :] < window
    return keep


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Single-device full attention (the oracle of the flash kernels).

    q ``[B, T, H, D]``; k, v ``[B, T, H_kv, D]`` where ``H_kv`` divides
    ``H`` (GQA): each kv head serves ``H // H_kv`` consecutive q heads, the
    ``jnp.repeat`` layout.  Masked scores are -inf and go through softmax
    as they do in the JAX oracle."""
    from ..ops.flash import _check_window, _gqa_group

    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if window is not None:
        _check_window(window, causal)
    if k.shape[2] != H:
        g = _gqa_group(H, k.shape[2])
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(~causal_window_mask(pos, pos, window)[None, None],
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
