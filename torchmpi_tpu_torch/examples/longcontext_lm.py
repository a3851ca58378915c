"""Long-context causal LM with sequence-parallel attention.

The counterpart of the JAX package's ``examples/longcontext_lm.py``: the
sequence is sharded over the ici ranks (ring attention rotates the key /
value shards around them, or Ulysses swaps sequence shards for head
shards), the batch over the dcn ranks, and the gradients sync over the
world.

Task: needle retrieval.  Each sequence is zeros except one "needle" token
at a random position in its first 7/8ths; every later position must
output the needle's value.  A shard can solve the positions after a needle
that lives on another shard only by attending across the ranks, so
convergence certifies the cross-shard attention (and the causal mask:
positions before the needle are not supervised).

The model (embed 128, depth 2, 8 heads of 16, T 256), the data, Adam and
the bar (the last loss below 0.35 of the first, on runs of 60 steps or
more; shorter runs report) are the JAX example's.  ``--attn ring_flash``
runs each ring step on the residual flash kernel and its backward ring on
the two backward kernels.

The loss is JAX's: the masked cross-entropy summed over every rank's
positions over the count of supervised positions, both sums taken over
the world with a differentiable allreduce whose backward is an allreduce
(JAX's ``psum``, whose transpose is a ``psum``).  The gradients then sync
with ``op="sum"``, so they come out as the world size times the loss's
gradient, as JAX's do (ROADMAP queue C note 22); Adam hides the factor.

Run as a world of one (``--device cpu`` on the CPU), or one rank per
process (the sequence over the processes of each node):
  ``torchrun --nproc-per-node 4 -m torchmpi_tpu_torch.examples.longcontext_lm``
4 ranks rank-major on one card (8 as dcn 2 x ici 4 with ``--devices 8
--dcn 2``):
  ``python -m torchmpi_tpu_torch.examples.longcontext_lm --devices 4
  --attn ring_flash``
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

BAR = 0.35  # last < BAR * first (JAX :133)


class _SumOverWorld(torch.autograd.Function):
    """A sum over every rank of the process world whose backward is the
    same sum (JAX's ``psum`` and its transpose)."""

    @staticmethod
    def forward(ctx, x):
        return mpi.allreduce(x)

    @staticmethod
    def backward(ctx, g):
        return mpi.allreduce(g.contiguous())


def make_model(args, dev, T: int) -> TransformerLM:
    """The JAX example's model, seeded from ``args.seed``."""
    return TransformerLM(vocab=args.vocab, embed=128, depth=2, num_heads=8,
                         head_dim=16, max_len=T, attn_impl=args.attn,
                         seq_axis="ici", device=dev,
                         generator=torch.Generator(dev).manual_seed(
                             args.seed))


def make_batch(rng: np.random.RandomState, batch: int, T: int, vocab: int):
    """JAX's ``make_batch`` (:69-77), draw for draw: tokens [batch, T],
    the needle values and positions [batch]."""
    tokens = np.zeros((batch, T), np.int32)
    key = rng.randint(1, vocab, size=batch).astype(np.int32)
    p = rng.randint(0, (T * 7) // 8, size=batch)
    tokens[np.arange(batch), p] = key
    return tokens, key.astype(np.int32), p.astype(np.int32)


def _masked_sums(logits, key, p, gpos):
    """(sum of the supervised positions' cross-entropy, their count):
    logits [..., B, T, V], key and p [..., B], gpos the global positions
    broadcastable to [..., B, T]."""
    mask = (gpos > p[..., None]).float()
    labels = key[..., None].long().expand(mask.shape)
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                             labels.reshape(-1), reduction="none")
    return (losses.view(mask.shape) * mask).sum(), mask.sum()


def loss_world(model, tokens, key, p):
    """JAX's ``loss_fn`` (:86-97) on this process's shard: tokens
    [B / n_dcn, T / n_ici], key and p [B / n_dcn]."""
    t_local = tokens.shape[1]
    offset = mpi.runtime.axis_index("ici") * t_local
    logits = model(tokens, pos_offset=offset)
    gpos = offset + torch.arange(t_local, device=tokens.device)
    local, cnt = _masked_sums(logits, key, p, gpos)
    return _SumOverWorld.apply(local) / _SumOverWorld.apply(cnt)


def loss_rank_major(model, tokens, key, p):
    """The same loss for every rank at once: tokens [n_dcn, n_ici, B /
    n_dcn, T / n_ici], key and p [n_dcn, B / n_dcn]."""
    n_ici, t_local = tokens.shape[1], tokens.shape[-1]
    logits = model.forward_rank_major(tokens)
    gpos = torch.arange(n_ici * t_local, device=tokens.device).view(
        1, n_ici, 1, t_local)
    local, cnt = _masked_sums(logits, key[:, None], p[:, None], gpos)
    return local / cnt


def make_train_step(model, tx, *, rank_major: bool, grid_size: int):
    """``step(state, tokens, key, p) -> (state, loss, grads)``: the loss,
    its gradients synced as JAX's are (summed over the world), and one
    update of ``tx`` on each parameter in place.  ``state`` starts as
    ``[tx.init(p) for p in model.parameters()]``."""
    params = list(model.parameters())

    def step(state, tokens, key, p):
        if rank_major:
            loss = loss_rank_major(model, tokens, key, p)
            grads = torch.autograd.grad(loss, params)
            # The lockstep forward of every rank yields the loss's own
            # gradient.  JAX's step (and the process-world form) yields
            # grid_size times it: each rank's gradient of psum / psum is
            # the world's share, and the sync sums the ranks' (ROADMAP
            # queue C note 22).  Scaling here stands in for that sync.
            grads = [g * grid_size for g in grads]
        else:
            loss = loss_world(model, tokens, key, p)
            grads = list(torch.autograd.grad(loss, params))
            gradsync.synchronize_gradient_tensors(grads, op="sum")
        new_state = []
        with torch.no_grad():
            for prm, g, s in zip(params, grads, state):
                u, s = tx.update(g, s, prm)
                prm.copy_(optim.apply_updates(prm, u))
                new_state.append(s)
        return new_state, loss.detach(), grads

    return step


def shard_batch(tokens, key, p, n_dcn: int, n_ici: int, dev, *,
                rank_major: bool):
    """The global batch as the step takes it: rank-major, tokens [n_dcn,
    n_ici, B / n_dcn, T / n_ici] and key / p [n_dcn, B / n_dcn]; in the
    process world, this process's block (batch over dcn, sequence over
    ici)."""
    B, T = tokens.shape
    b, t = B // n_dcn, T // n_ici
    if rank_major:
        tok = tokens.reshape(n_dcn, b, n_ici, t).transpose(0, 2, 1, 3)
        key, p = key.reshape(n_dcn, b), p.reshape(n_dcn, b)
    else:
        d, i = mpi.runtime.axis_index("dcn"), mpi.runtime.axis_index("ici")
        tok = tokens[d * b:(d + 1) * b, i * t:(i + 1) * t]
        key, p = key[d * b:(d + 1) * b], p[d * b:(d + 1) * b]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return to(tok).long(), to(key).long(), to(p).long()


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 80, "batch_size": 16, "lr": 3e-3},
        seq_len=dict(type=int, default=256),
        vocab=dict(type=int, default=64),
        attn=dict(type=str, default="ring",
                  choices=["ring", "ring_flash", "ulysses"]))
    with common.runtime(args) as dev:
        rank_major = bool(args.devices)
        n_dcn, n_ici = (mpi.runtime.grid(args.devices) if rank_major
                        else mpi.runtime.grid())
        T = args.seq_len
        if T % n_ici or args.batch_size % n_dcn:
            raise ValueError(f"seq_len {T} / batch {args.batch_size} do not "
                             f"split over ici {n_ici} / dcn {n_dcn}")
        print(f"grid dcn {n_dcn} x ici {n_ici}"
              + (" rank-major" if rank_major else "")
              + f", global seq {T}, {T // n_ici} a rank over ici, batch / "
              f"{n_dcn} over dcn, attention={args.attn}")
        model = make_model(args, dev, T)
        tx = optim.adam(args.lr)
        state = [tx.init(prm.detach()) for prm in model.parameters()]
        step = make_train_step(model, tx, rank_major=rank_major,
                               grid_size=n_dcn * n_ici)
        rng = np.random.RandomState(args.seed)
        losses = []
        for i in range(args.steps):
            batch = make_batch(rng, args.batch_size, T, args.vocab)
            state, loss, _ = step(state, *shard_batch(
                *batch, n_dcn, n_ici, dev, rank_major=rank_major))
            losses.append(float(loss))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        first, last = losses[0], losses[-1]
        print(f"loss {first:.3f} -> {last:.3f} (chance "
              f"~{np.log(args.vocab):.2f})")
    out = {"losses": losses, "first": first, "last": last,
           "learned": last < BAR * first}
    if args.steps >= common.FULL_RUN_STEPS and not out["learned"]:
        raise AssertionError(f"long-context LM did not learn: {first:.3f} "
                             f"-> {last:.3f}")
    return out


if __name__ == "__main__":
    main()
