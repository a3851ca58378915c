"""Train an expert-parallel MoE LM, then decode it expert-parallel.

The counterpart of the JAX package's ``examples/moe_generate.py``: a
top-2 MoE ``TransformerLM`` (vocab 32, embed 64, depth 2, 4 heads of 16,
one expert a rank over ici, capacity factor 8.0, so that training and
decoding route alike) trained data-parallel over dcn on the rule ``t_{i+1}
= (3 t_i + 1) mod V`` with Adam (``examples.moe_lm``'s step), then
continued with ``models.generate_parallel`` on the same grid and expert
sharding: each decode step routes its tokens through the all-to-all
expert layer.  Greedy and 3-beam continuations of 2 prompts a dcn row
must follow the rule on more than 80% of their tokens (JAX's bar), on
runs of ``FULL_STEPS`` training steps or more; shorter runs report.

Run as N ranks rank-major on one device (dcn 2 x ici N / 2):
  ``python -m torchmpi_tpu_torch.examples.moe_generate --devices 8 --dcn 2``
(``--device cpu`` on the CPU), or one rank a process:
  ``torchrun --nproc-per-node 4 -m torchmpi_tpu_torch.examples.moe_generate``
"""

from __future__ import annotations

import numpy as np
import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import optim
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.examples.moe_lm import make_batch, \
    make_train_step, shard_batch
from torchmpi_tpu_torch.models import TransformerLM, \
    beam_search_parallel, beam_search_parallel_rank_major, \
    generate_parallel, generate_parallel_rank_major

BAR = 0.8  # rule accuracy of the continuations (JAX :178-179)
FULL_STEPS = 150  # JAX's default training run


def _rule_accuracy(out: np.ndarray, prompts: np.ndarray, steps: int,
                   V: int) -> float:
    correct = total = 0
    for b in range(out.shape[0]):
        t = int(prompts[b, -1])
        for j in range(prompts.shape[1], prompts.shape[1] + steps):
            t = (t * 3 + 1) % V
            correct += int(out[b, j] == t)
            total += 1
    return correct / total


def main(argv=None):
    args = common.parse_args(
        __doc__, argv,
        defaults={"steps": FULL_STEPS, "batch_size": 16, "lr": 3e-3},
        seq_len=dict(type=int, default=16),
        vocab=dict(type=int, default=32),
        gen_steps=dict(type=int, default=8))
    with common.runtime(args) as dev:
        rank_major = bool(args.devices)
        n_dcn, n_ici = (mpi.runtime.grid(args.devices) if rank_major
                        else mpi.runtime.grid())
        V, T = args.vocab, args.seq_len
        assert args.batch_size % n_dcn == 0
        print(f"grid dcn {n_dcn} x ici {n_ici}"
              + (" rank-major" if rank_major else "")
              + ": batch over dcn, experts over ici")
        model = TransformerLM(
            vocab=V, embed=64, depth=2, num_heads=4, head_dim=16, max_len=T,
            moe_axis="ici", moe_experts_per_device=1, moe_k=2,
            moe_capacity_factor=8.0, moe_axis_size=n_ici, device=dev,
            generator=torch.Generator(dev).manual_seed(args.seed))
        tx = optim.adam(args.lr)
        state = [tx.init(prm.detach()) for prm in model.parameters()]
        step = make_train_step(model, tx, rank_major=rank_major,
                               grid_size=n_dcn * n_ici)
        rng = np.random.RandomState(args.seed)
        loss = float("nan")
        for i in range(args.steps):
            tok = shard_batch(make_batch(rng, args.batch_size, T, V),
                              n_dcn, n_ici, dev, rank_major=rank_major)
            state, loss, _ = step(state, tok)
            loss = float(loss)
            if i % 50 == 0:
                print(f"step {i:4d}  loss {loss:.4f}")
        print(f"final train loss {loss:.4f}")

        # Expert-parallel greedy and beam decode on the same grid.
        prompts = make_batch(np.random.RandomState(args.seed + 999),
                             2 * n_dcn, T, V)[:, :4]
        kw = dict(batch_axis="dcn")
        if rank_major:
            n = n_dcn * n_ici
            out = generate_parallel_rank_major(model, prompts,
                                               args.gen_steps, n=n, **kw)
            out_b = beam_search_parallel_rank_major(
                model, prompts, args.gen_steps, n=n, beams=3, **kw)
        else:
            out = generate_parallel(model, prompts, args.gen_steps, **kw)
            out_b = beam_search_parallel(model, prompts, args.gen_steps,
                                         beams=3, **kw)
        out, out_b = out.cpu().numpy(), out_b.cpu().numpy()
        acc = _rule_accuracy(out, prompts, args.gen_steps, V)
        acc_b = _rule_accuracy(out_b, prompts, args.gen_steps, V)
        print(f"EP decode: {len(prompts)} prompts x {args.gen_steps} "
              f"tokens, rule accuracy {acc:.3f}; beam-3 {acc_b:.3f}")
        print(f"sample: prompt {prompts[0].tolist()} -> "
              f"{out[0, 4:].tolist()}")
    if args.steps >= FULL_STEPS:
        assert acc > BAR, "EP-decoded continuations do not follow the rule"
        assert acc_b > BAR, "EP beam continuations do not follow the rule"
    return {"loss": loss, "greedy": acc, "beam": acc_b, "tokens": out}


if __name__ == "__main__":
    main()
