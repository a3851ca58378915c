"""Optimizers as pure ``(init, update)`` pairs over tensors.

The PyTorch counterpart of the two optax transformations that the JAX
package's ZeRO layer is tested and measured with: ``optax.sgd`` (with
momentum, ``tests/test_zero.py``) and ``optax.adam``
(``benchmarks/memory_bench.py`` :58).  ZeRO applies them to flat parameter
shards, so they take any tensors and work elementwise; a rank-major stack
of shards [n, shard] is one tensor like any other.

    tx = optim.adam(1e-3)
    state = tx.init(p)
    updates, state = tx.update(g, state, p)
    p = optim.apply_updates(p, updates)

The arithmetic follows optax's order of operations step for step
(``update_moment``, the bias correction ``1 - decay ** count`` taken in
float32, ``mu_hat / (sqrt(nu_hat) + eps)`` with optax's default
``eps_root = 0``, then the scale by ``-lr``), so the two agree to a few
float32 ulps.  Adam's step count is a host integer: reading it never waits
for the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``, as in optax."""

    init: Callable
    update: Callable


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class TraceState(NamedTuple):
    trace: Optional[torch.Tensor]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it for a float32
    moment (``tree_bias_correction``)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(lr, b1, b2, eps)``."""

    def init(params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params),
                         torch.zeros_like(params))

    def update(grads: torch.Tensor, state: AdamState, params=None):
        del params
        mu = grads * (1 - b1)
        mu += b1 * state.mu
        nu = (grads * grads) * (1 - b2)
        nu += b2 * state.nu
        count = state.count + 1
        den = nu / _bias_correction(b2, count)
        den.sqrt_()
        den += eps
        updates = mu / _bias_correction(b1, count)
        updates /= den
        updates *= -lr
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def sgd(lr: float, momentum: Optional[float] = None
        ) -> GradientTransformation:
    """``optax.sgd(lr, momentum)``: with a momentum, the trace
    ``g + momentum * trace``; then the scale by ``-lr``."""

    def init(params: torch.Tensor) -> TraceState:
        return TraceState(None if momentum is None
                          else torch.zeros_like(params))

    def update(grads: torch.Tensor, state: TraceState, params=None):
        del params
        if momentum is None:
            return grads * -lr, state
        trace = grads + momentum * state.trace
        return trace * -lr, TraceState(trace)

    return GradientTransformation(init, update)


def apply_updates(params: torch.Tensor, updates: torch.Tensor):
    """``optax.apply_updates``: ``params + updates`` in the params' dtype."""
    return (params + updates).to(params.dtype)
