"""Expert-parallel MoE language model.

The counterpart of the JAX package's ``examples/moe_lm.py``: a
TransformerLM whose MLP is a top-k MoE (``--top-k``: 1 = Switch-style
combine, 2+ = GShard renormalized) with one expert a rank, the tokens
dispatched to their experts' ranks by an all-to-all over ici and combined
back, trained data-parallel over dcn.  The batch is split over dcn and
replicated over ici (JAX's ``P(DCN)``): every ici rank of a dcn row holds
the same tokens and dispatches them to every expert.

The task (next token = (token * 3 + 1) mod vocab), the model (embed 64,
depth 2, 4 heads of 16, ``moe_axis="ici"``, one expert a rank), Adam,
the loss (the task's cross-entropy plus 1e-2 times the sum of the layers'
load-balance losses) and the bar (the last loss below 0.7 of the first,
on runs of 60 steps or more; shorter runs report) are the JAX example's.

The gradients are JAX's.  Its step takes ``pmean`` of the loss over every
axis and then syncs the gradients with ``op="sum"``; a psum's transpose is
a psum, so each device's loss gets cotangent 1 and the synced gradient is
the world size times the gradient of the mean loss (ROADMAP queue C note
23).  The process-world step backpropagates each rank's own loss (the
all-to-all's backward crossing the ranks) and sums the gradients over the
world; the rank-major step scales the mean loss's gradient by the grid's
size, which stands in for that sync.  Adam hides the factor.

Run as a world of one (``--device cpu`` on the CPU), or one rank per
process (the experts over the processes of each node):
  ``torchrun --nproc-per-node 4 -m torchmpi_tpu_torch.examples.moe_lm``
8 ranks rank-major on one card (dcn 2 x ici 4 with ``--dcn 2``):
  ``python -m torchmpi_tpu_torch.examples.moe_lm --devices 8 --top-k 2``
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import optim
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import TransformerLM
from torchmpi_tpu_torch.parallel import gradsync

BAR = 0.7  # last < BAR * first (JAX :118)
AUX_SCALE = 1e-2


def make_model(args, dev, T: int, n_ici: int) -> TransformerLM:
    """The JAX example's model for ``n_ici`` expert ranks, seeded from
    ``args.seed``."""
    return TransformerLM(vocab=args.vocab, embed=64, depth=2, num_heads=4,
                         head_dim=16, max_len=T, moe_axis="ici",
                         moe_experts_per_device=1, moe_k=args.top_k,
                         moe_axis_size=n_ici, device=dev,
                         generator=torch.Generator(dev).manual_seed(
                             args.seed))


def make_batch(rng: np.random.RandomState, batch: int, T: int, vocab: int):
    """JAX's ``make_batch`` (:58-63), draw for draw: tokens [batch, T]."""
    toks = [rng.randint(0, vocab, size=(batch, 1))]
    for _ in range(T - 1):
        toks.append((toks[-1] * 3 + 1) % vocab)
    return np.concatenate(toks, axis=1).astype(np.int32)


def _task_losses(logits, tokens):
    """Mean next-token cross-entropy of each rank: logits [..., b, T, V],
    tokens [..., b, T] -> [...]."""
    V = logits.shape[-1]
    ce = F.cross_entropy(logits[..., :-1, :].reshape(-1, V).float(),
                         tokens[..., 1:].reshape(-1), reduction="none")
    return ce.view(*tokens.shape[:-2], -1).mean(dim=-1)


def make_train_step(model, tx, *, rank_major: bool, grid_size: int):
    """``step(state, tokens) -> (state, loss, grads)``: the loss (the mean
    over the ranks), its gradients synced as JAX's are, and one update of
    ``tx`` on each parameter in place.  ``state`` starts as
    ``[tx.init(p) for p in model.parameters()]``."""
    params = list(model.parameters())

    def step(state, tokens):
        if rank_major:
            logits = model.forward_rank_major(tokens)
            aux = sum(model.moe_aux_losses())  # [n], one a rank
            loss = (_task_losses(logits, tokens).reshape(-1)
                    + AUX_SCALE * aux).mean()
            # The lockstep forward of every rank yields the mean loss's
            # own gradient; JAX's pmean-then-sum step yields grid_size
            # times it (ROADMAP queue C note 23).  Scaling here stands in
            # for that sync.
            grads = [g * grid_size
                     for g in torch.autograd.grad(loss, params)]
        else:
            mine = (_task_losses(model(tokens), tokens)
                    + AUX_SCALE * sum(model.moe_aux_losses()))
            # Cotangent 1 on this rank's loss, as JAX's pmean transposes
            # to; the sum over the world is its synced gradient.
            grads = list(torch.autograd.grad(mine, params))
            gradsync.synchronize_gradient_tensors(grads, op="sum")
            loss = mpi.allreduce(mine.detach()) / mpi.size()
        new_state = []
        with torch.no_grad():
            for prm, g, s in zip(params, grads, state):
                u, s = tx.update(g, s, prm)
                prm.copy_(optim.apply_updates(prm, u))
                new_state.append(s)
        return new_state, loss.detach(), grads

    return step


def shard_batch(tokens: np.ndarray, n_dcn: int, n_ici: int, dev, *,
                rank_major: bool) -> torch.Tensor:
    """The global batch as the step takes it, split over dcn and
    replicated over ici: rank-major ``[n_dcn, n_ici, B / n_dcn, T]``; in
    the process world, this process's dcn row's ``[B / n_dcn, T]``."""
    B, T = tokens.shape
    b = B // n_dcn
    if rank_major:
        tok = np.broadcast_to(tokens.reshape(n_dcn, 1, b, T),
                              (n_dcn, n_ici, b, T))
    else:
        d = mpi.runtime.axis_index("dcn")
        tok = tokens[d * b:(d + 1) * b]
    return torch.from_numpy(np.ascontiguousarray(tok)).to(dev).long()


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 60, "batch_size": 16, "lr": 3e-3},
        seq_len=dict(type=int, default=32),
        vocab=dict(type=int, default=64),
        top_k=dict(type=int, default=1,
                   help="experts per token (1=Switch, 2=GShard combine)"))
    with common.runtime(args) as dev:
        rank_major = bool(args.devices)
        n_dcn, n_ici = (mpi.runtime.grid(args.devices) if rank_major
                        else mpi.runtime.grid())
        if args.batch_size % n_dcn:
            raise ValueError(f"batch {args.batch_size} does not split over "
                             f"dcn {n_dcn}")
        T = args.seq_len
        print(f"grid dcn {n_dcn} x ici {n_ici}"
              + (" rank-major" if rank_major else "")
              + f": dp={n_dcn} over dcn, ep={n_ici} experts over ici, "
              f"top-{args.top_k}")
        model = make_model(args, dev, T, n_ici)
        tx = optim.adam(args.lr)
        state = [tx.init(prm.detach()) for prm in model.parameters()]
        step = make_train_step(model, tx, rank_major=rank_major,
                               grid_size=n_dcn * n_ici)
        rng = np.random.RandomState(args.seed)
        make_batch(rng, args.batch_size, T, args.vocab)  # JAX's init batch
        losses = []
        for i in range(args.steps):
            tok = shard_batch(make_batch(rng, args.batch_size, T, args.vocab),
                              n_dcn, n_ici, dev, rank_major=rank_major)
            state, loss, _ = step(state, tok)
            losses.append(float(loss))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        first, last = losses[0], losses[-1]
        print(f"final loss {last:.4f} (from {first:.4f})")
    out = {"losses": losses, "first": first, "last": last,
           "learned": last < BAR * first}
    if args.steps >= common.FULL_RUN_STEPS and not out["learned"]:
        raise AssertionError(f"MoE LM failed to learn: {first:.4f} -> "
                             f"{last:.4f}")
    return out


if __name__ == "__main__":
    main()
