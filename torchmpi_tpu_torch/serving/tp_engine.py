"""A serving replica that is a tensor-parallel slice of ranks.

The PyTorch counterpart of ``torchmpi_tpu/serving/tp_engine.py``:
:class:`TPReplicaEngine` runs the dense :class:`~.engine.ReplicaEngine`'s
slot-pool protocol (the same pool, sessions, sampling, bucketing,
speculation and prefix cache, driven by the same scheduler) with the
forwards of :mod:`..models.tp_generate`: weights column / row sharded over
the replica's ``axis``, the pool cache head-sharded the same way, one
allreduce a sublayer a token (the ring kernels under ``backend="pallas"``)
and the LM head's vocabulary re-joined by the stock all-gather.

A replica's ranks are a communicator of their own (``communicator``, the
key it was pushed under; ``Server.sharded`` pushes one a replica): every
forward runs with it pushed.  In a world of one process its ranks are a
rank-major stack on the device (the parameters and the pool stacked [tp,
...]); across processes this process holds its rank's shard and every
process of the replica runs the same engine on the same requests.

The planner records one decision-only ``serving`` plan row a replica at
construction, keyed on the replica's communicator
(:func:`~..planner.plan_serving_replica`).

Rank-major on the card the fixed-shape ``[S, 1]`` step replays one CUDA
graph, the ring kernels captured in it; each replay adds the launches its
capture recorded to ``ops.ring.LAUNCHES`` (``models.generate.graphed``).
Across processes the step runs eagerly.  Every
forward's inputs go through pinned memory and its tokens come back in one
read, as in the dense engine.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import numpy as np

from .. import _tree, runtime
from ..models.tp_generate import _Form, _Stack, _slot_decode, \
    _slot_prefill, shard_tp_lm, shard_tp_lm_rank_major
from .engine import ReplicaEngine


class TPReplicaEngine(ReplicaEngine):
    """Slot-pooled decode engine whose replica is a TP slice of ranks.

    ``params`` is a full :func:`~..models.tp_generate.init_tp_lm` tree
    (sharded here over ``axis`` of the ``communicator`` pushed under that
    key; None: the current communicator).  ``slot_tokens`` must resolve to
    a positive block size (the argument or ``serving_slot_tokens``: the TP
    stack has no ``max_len`` to default to).  ``backend`` routes the
    sublayers' allreduces (None: the Config's)."""

    def __init__(self, params, *, axis: str = "model", num_heads: int,
                 name: str = "tp0", communicator: Optional[str] = None,
                 slots: Optional[int] = None,
                 slot_tokens: Optional[int] = None,
                 sample: Optional[float] = None,
                 prefill_bucket: Optional[int] = None,
                 spec_k: Optional[int] = None, draft=None,
                 prefix_cache: Optional[int] = None,
                 prefix_block: int = 8, backend: Optional[str] = None):
        from .. import planner
        from ..ops import ring

        cfg = runtime.effective_config()
        slots = int(slots if slots is not None else cfg.serving_slots)
        st = int(slot_tokens if slot_tokens is not None
                 else (cfg.serving_slot_tokens or 0))
        if st <= 0:
            raise ValueError(
                "TPReplicaEngine needs an explicit slot block size "
                "(slot_tokens= or serving_slot_tokens > 0): the TP "
                "stack has no max_len to default to")
        self.axis, self.num_heads = axis, int(num_heads)
        self._comm = communicator
        self.depth = len(params["blocks"])
        self.vocab = int(params["embed"].shape[0])
        self.param_count = sum(int(np.prod(p.shape))
                               for p in _tree.leaves(params))
        with self._scope():
            comm = runtime.current_communicator()
            n = None
            if runtime.size() == 1:
                n = comm.fixed_size()
                if n is None:
                    raise ValueError(
                        f"TPReplicaEngine: in a world of one process the "
                        f"replica's ranks are a rank-major stack; push a "
                        f"communicator of fixed size (shape={{{axis!r}: "
                        f"tp}}) and pass its key")
            if n is None:
                placed = shard_tp_lm(params, axis)[0]
            else:
                placed = shard_tp_lm_rank_major(params, n, axis)[0]
            self._stack = _Stack(placed, _Form(axis, n, backend),
                                     num_heads)
            planner.plan_serving_replica(name, comm, (axis,), n=n)
        self.params = placed
        self.model = None  # no dense module: the forwards are tp_generate's
        self.device = self._stack.device
        self._init_serving(cfg, name, slots, st, sample=sample,
                           prefill_bucket=prefill_bucket,
                           prefix_cache=prefix_cache,
                           prefix_block=prefix_block)
        self._cache = self._stack.zero_cache(slots, st)
        with self._scope():
            # Rank-major only: across processes the step runs eagerly.
            self._capture_step(counters=(ring.LAUNCHES,
                                         ring.VECTOR_LAUNCHES),
                               graph=n is not None)
        self._bind_draft(spec_k, cfg, draft)

    def _scope(self):
        """The replica's communicator pushed (its cached entry)."""
        if self._comm is None:
            return nullcontext()
        return runtime.communicator(self._comm)

    # -- backend hooks ------------------------------------------------------

    def _backend_prefill(self, prompt, true_len, sampling):
        (tok,), samp = self._stage([prompt], sampling)
        with self._scope():
            return _slot_prefill(self._stack, tok, self.pool.slot_tokens,
                                     true_len, samp)

    def _decode(self, toks, pos, *sampling):
        with self._scope():
            return _slot_decode(self._stack, self._cache, toks[:, None],
                                    pos, sampling)[1][:, 0]

    def _backend_verify(self, toks, pos, sampling):
        (t, p), samp = self._stage([toks, pos], sampling)
        with self._scope():
            _, out = _slot_decode(self._stack, self._cache, t, p, samp)
        return out.cpu().numpy()

    def _row_template(self):
        return self._stack.zero_cache(1, self.pool.slot_tokens)

    def _backend_extend(self, row_cache, suffix, depth, true_len, sampling):
        # The extend forward is the slot decode on a one-row cache: the
        # [1, Ts] suffix at the assembled depth takes the cache-masked
        # attention the speculative verify takes.  It keys position j on
        # (seed, idx + j), so idx shifts by -(true_len - 1): the true last
        # suffix position samples with the request's own token index.
        seeds, idxs, temps, tks, tps = sampling
        shifted = (seeds, idxs - (true_len - 1), temps, tks, tps)
        (tok, pos), samp = self._stage(
            [suffix, np.asarray([depth], np.int64)], shifted)
        with self._scope():
            _, out = _slot_decode(self._stack, row_cache, tok, pos, samp)
        return row_cache, out[:, true_len - 1]
