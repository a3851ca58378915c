"""MNIST LeNet, data-parallel SGD with bucketed or overlapped gradient sync.

The counterpart of the JAX package's ``examples/mnist_async_allreduce.py``
(the reference's ``mnist_allreduce_async.lua``: per-layer async allreduce
hooks fired during the backward, synced before the optimizer step).  Two
forms:

- default: the gradients synced after the backward in ``--buckets``
  (default 4) buckets, one allreduce each (``Config.gradsync_buckets``);
- ``TORCHMPI_TPU_GRADSYNC_OVERLAP=auto``: the backprop-overlapped sync,
  ``mpi.nn.make_overlapped_grad_fn``: a hook on every parameter fires each
  reverse-parameter-order bucket's allreduce from the backward as its
  gradients arrive (with ``--devices N``, the rank-major form: the last
  rank's buckets reduce on a side stream).  The same gradients either
  way.

Run as a world of one (``--device cpu`` on the CPU):
  ``python -m torchmpi_tpu_torch.examples.mnist_async_allreduce``
4 ranks rank-major on one card, overlapped, on the ring kernels:
  ``TORCHMPI_TPU_GRADSYNC_OVERLAP=auto python -m
  torchmpi_tpu_torch.examples.mnist_async_allreduce --devices 4
  --backend pallas``
"""

import torch
import torch.nn.functional as F

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import LeNet
from torchmpi_tpu_torch.utils import data as dutil


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    if args.buckets is None:
        args.buckets = 4
    with common.runtime(args) as dev:
        n = args.devices
        overlap = mpi.config().gradsync_overlap == "auto"
        print(f"rank {mpi.rank()}/{mpi.size()}"
              + (f", {n} ranks rank-major" if n else "")
              + (", overlapped sync" if overlap
                 else f", {args.buckets} buckets"))
        model = LeNet(device=dev, generator=torch.Generator(dev).manual_seed(
            args.seed))
        params = list(model.parameters())
        opt = torch.optim.SGD(params, lr=args.lr, momentum=args.momentum)
        if not overlap:
            # The DP steps sync after the backward in --buckets buckets
            # (Config.gradsync_buckets).
            def loss_of(m, x, y):
                return F.cross_entropy(m(x), y)

            step = (mpi.nn.data_parallel_step_rank_major(
                model, opt, loss_of, n, backend=args.backend) if n
                else mpi.nn.data_parallel_step(model, opt, loss_of))
        else:
            mpi.nn.synchronize_parameters(model)
            names = [k for k, _ in model.named_parameters()]

            def loss_fn(leaves, x, y):
                logits = torch.func.functional_call(
                    model, dict(zip(names, leaves)), (x,))
                return F.cross_entropy(logits, y)

            vag = (mpi.nn.make_overlapped_grad_fn_rank_major(
                loss_fn, params, n, backend=args.backend) if n
                else mpi.nn.make_overlapped_grad_fn(loss_fn, params,
                                                    backend=args.backend))

            def step(x, y):
                # The gradients come back synced: each bucket's allreduce
                # fired from the backward.
                if n:
                    outs, stacks = vag(params, x, y)
                    grads, loss = [st[0] for st in stacks], \
                        torch.stack(outs).mean()
                else:
                    loss, grads = vag(params, x, y)
                    loss = mpi.allreduce_in_axis(loss, op="mean")
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
                return loss

        X, Y = dutil.synthetic_mnist(4096, seed=args.seed)
        timer = common.StepTimer(dev)
        timer.start()
        losses = []
        for i, (xb, yb) in enumerate(
                dutil.batches(X, Y, args.batch_size, steps=args.steps,
                              seed=args.seed)):
            xb, yb = common.local_slice(xb, yb, rank_major=bool(n))
            loss = step(*common.to_device(xb, yb, dev))
            timer.tick()
            if i % 20 == 0 or i == args.steps - 1:
                losses.append(float(loss))
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        rate = timer.rate(args.batch_size)
        acc = common.evaluate(model, X[:1024], Y[:1024], dev)
        print(f"final accuracy {acc:.3f}  ({rate:.0f} img/s)")
    common.check_accuracy(acc, 0.9, args.steps,
                          "bucketed data-parallel MNIST")
    return {"losses": losses, "accuracy": acc, "img_per_s": rate,
            "overlap": overlap, "buckets": args.buckets}


if __name__ == "__main__":
    main()
