"""Continuous-batching serving: a Poisson request trace through the
admission queue, the slot pools and the health-routed replicas
(``torchmpi_tpu_torch.serving``).

The counterpart of the JAX package's ``examples/continuous_serving.py``:
``--replicas`` replicas of one RoPE ``TransformerLM`` (vocab 64, embed 32,
depth 2, 4 heads of 8, seeded weights) with ``--slots`` slot blocks of 64
tokens each serve ``--requests`` requests of 4-32 new tokens, arriving as
a Poisson stream on the work-unit clock, with iteration-level batching.
Every request's tokens are then checked against the offline
``models.generate`` of its prompt alone, token for token (JAX's
assertion), and the per-request numbers printed.  On one card the
replicas share it.

Run: ``python -m torchmpi_tpu_torch.examples.continuous_serving``
(``--device cpu`` on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from torchmpi_tpu_torch import serving
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import TransformerLM, generate


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 0, "batch_size": 8},
        requests=dict(type=int, default=24),
        replicas=dict(type=int, default=2),
        slots=dict(type=int, default=4))
    with common.runtime(args) as dev:
        vocab, tp = 64, 6
        model = TransformerLM(vocab=vocab, embed=32, depth=2, num_heads=4,
                              head_dim=8, max_len=64, pos_emb="rope",
                              device=dev,
                              generator=torch.Generator(dev).manual_seed(
                                  args.seed))
        rng = np.random.RandomState(args.seed + 1)
        prompts = rng.randint(0, vocab, size=(args.requests, tp))
        lens = [int(rng.choice([4, 8, 16, 32]))
                for _ in range(args.requests)]
        arrivals = np.cumsum(rng.exponential(2.0, size=args.requests))
        reqs = [serving.Request(f"r{i}", prompts[i], max_new=lens[i],
                                arrival_s=float(arrivals[i]))
                for i in range(args.requests)]
        server = serving.Server(model, replicas=args.replicas,
                                slots=args.slots, slot_tokens=64)
        done = server.run_trace(reqs, unit_seconds=1.0)
        assert len(done) == args.requests
        for i, req in enumerate(reqs):
            off = generate(model, prompts[i:i + 1], lens[i])[0, tp:].tolist()
            assert req.tokens == off, (
                f"request {req.rid} diverged from offline generate:\n"
                f"{req.tokens}\nvs\n{off}")
    st = server.last_stats
    by_rep = {}
    for r in reqs:
        by_rep[r.replica] = by_rep.get(r.replica, 0) + 1
    ttft = sorted(r.ttft_s for r in reqs)
    print(f"continuous serving OK: {args.requests} requests ({sum(lens)} "
          f"tokens) over {args.replicas} replicas x {args.slots} slot "
          f"blocks; sessions per replica {by_rep}; {st['ticks']} ticks, "
          f"work-unit TTFT p50/p95 = {ttft[len(ttft) // 2]:.0f}/"
          f"{ttft[int(len(ttft) * .95)]:.0f}; every request token-exact vs "
          f"offline generate")
    return {"tokens": sum(lens), "ticks": st["ticks"], "replicas": by_rep}


if __name__ == "__main__":
    main()
