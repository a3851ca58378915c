"""Serve one checkpoint tree three ways, dense, tensor-parallel and
pipeline-parallel, and assert they emit the same tokens.

The counterpart of the JAX package's ``examples/parallel_serving.py``: one
``init_tp_lm`` tree (vocab ``--vocab``, embed 32, depth the rank count, 8
heads) decodes

- dense on one device (``models.oracle``: the whole forward again each
  token);
- tensor-parallel over the ranks (``models.tp_generate``: the head-local
  cache, the LM head's vocabulary re-joined each token);
- pipeline-parallel over as many stages (``models.pp_generate``: the
  round-robin micro-groups, one wraparound hop a tick).

Greedy decoding agrees token for token across all three, EOS freezes a
row the same way on TP and PP, TP beam search with one beam is greedy, and
a 3-beam search returns the greedy run's shape (JAX's assertions; any
mismatch raises).

Run as N ranks rank-major on one device (``--backend pallas`` sums TP's
sublayers on the ring kernels):
  ``python -m torchmpi_tpu_torch.examples.parallel_serving --devices 8``
(``--device cpu`` on the CPU), or one rank a process:
  ``torchrun --nproc-per-node 4 -m \
  torchmpi_tpu_torch.examples.parallel_serving``
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models.oracle import dense_greedy
from torchmpi_tpu_torch.models.pp_generate import pp_generate, \
    pp_generate_rank_major
from torchmpi_tpu_torch.models.tp_generate import init_tp_lm, \
    tp_beam_search, tp_beam_search_rank_major, tp_generate, \
    tp_generate_rank_major

HEADS = 8


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 0, "batch_size": 8},
        vocab=dict(type=int, default=64),
        gen_steps=dict(type=int, default=8))
    with common.runtime(args) as dev:
        rank_major = bool(args.devices)
        n = args.devices or mpi.size()
        V, B, steps = args.vocab, args.batch_size, args.gen_steps
        backend = args.backend
        with mpi.communicator("serving", shape={"model": n}):
            # One tree, its depth the stage count.
            params = init_tp_lm(torch.Generator(dev).manual_seed(args.seed),
                                vocab=V, embed=32, depth=n, num_heads=HEADS,
                                device=dev)
            prompt = np.random.RandomState(args.seed + 1).randint(
                0, V, size=(B, 4)).astype(np.int32)
            kw = dict(axis="model", num_heads=HEADS)
            if rank_major:
                tp = partial(tp_generate_rank_major, n=n, backend=backend)
                pp = partial(pp_generate_rank_major, n=n)
                beam = partial(tp_beam_search_rank_major, n=n,
                               backend=backend)
            else:
                tp = partial(tp_generate, backend=backend)
                pp, beam = pp_generate, partial(tp_beam_search,
                                                backend=backend)

            toks = dense_greedy(params, prompt, steps, num_heads=HEADS)
            tp_toks = tp(params, prompt, steps, **kw).cpu().numpy()
            pp_toks = pp(params, prompt, steps, **kw).cpu().numpy()
            assert (tp_toks == toks).all(), (
                f"TP decode diverged from dense:\n{tp_toks}\nvs\n{toks}")
            assert (pp_toks == toks).all(), (
                f"PP decode diverged from dense:\n{pp_toks}\nvs\n{toks}")

            # EOS: freeze on a token the dense decode emits.
            eos = int(toks[0, prompt.shape[1]])
            tp_eos = tp(params, prompt, steps, eos_id=eos, **kw).cpu().numpy()
            pp_eos = pp(params, prompt, steps, eos_id=eos, **kw).cpu().numpy()
            assert (tp_eos == pp_eos).all(), "TP vs PP EOS divergence"
            assert (tp_eos[0, prompt.shape[1]:] == eos).all(), (
                "row 0 should freeze at its first emitted token")

            # Beam search on the TP stack: one beam is greedy.
            beam1 = beam(params, prompt, steps, beams=1, **kw).cpu().numpy()
            assert (beam1 == toks).all(), "TP beam(1) diverged from greedy"
            beam3 = beam(params, prompt, steps, beams=3, length_penalty=0.6,
                         **kw).cpu().numpy()
            assert beam3.shape == toks.shape
        print(f"parallel serving OK: dense == TP == PP over {n} ranks"
              + (" rank-major" if rank_major else "")
              + f" ({B}x{prompt.shape[1]} prompt + {steps} tokens; EOS "
              f"freeze consistent; TP beam(1) == greedy)")
    return {"tokens": toks, "eos": eos, "beam3": beam3, "ranks": n}


if __name__ == "__main__":
    main()
