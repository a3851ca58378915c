"""MNIST LeNet, fully-sharded data parallelism (FSDP).

The counterpart of the JAX package's ``examples/mnist_fsdp.py``: the
parameters and the optimizer state live sharded per parameter
(``recipes.fsdp_specs``: each leaf on its largest dim the rank count
divides, the rest replicated).  JAX's compiler inserts the gathers and
the gradient reduce-scatters; here the step issues them itself
(``recipes.make_fsdp_train_step``): each sharded leaf all-gathered before
the forward, the gradients reduce-scattered as one fused tree.  The script
shows convergence and that the persistent state stays at 1/n a rank
through training.

Run as a world of one (``--device cpu`` on the CPU):
  ``python -m torchmpi_tpu_torch.examples.mnist_fsdp``
One rank per process:
  ``torchrun --nproc-per-node 2 -m torchmpi_tpu_torch.examples.mnist_fsdp``
4 ranks rank-major on one card, the gathers and reduce-scatters on the ring
kernels:
  ``python -m torchmpi_tpu_torch.examples.mnist_fsdp --devices 4
  --backend pallas``
"""

import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import recipes
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import LeNet
from torchmpi_tpu_torch.utils import data as dutil


def main(argv=None):
    args = common.parse_args(__doc__, argv, defaults={
        "lr": 0.02, "steps": 150, "batch_size": 128})
    with common.runtime(args) as dev:
        n = args.devices
        print(f"rank {mpi.rank()}/{mpi.size()}"
              + (f", {n} ranks rank-major" if n else ""))
        model = LeNet(device=dev, generator=torch.Generator(dev).manual_seed(
            args.seed))
        tx = mpi.optim.sgd(args.lr, momentum=args.momentum)
        full = [p.detach() for p in model.parameters()]
        if n:
            step, params, opt_state = recipes.make_fsdp_train_step_rank_major(
                model, tx, full, n, backend=args.backend)
        else:
            step, params, opt_state = recipes.make_fsdp_train_step(
                model, tx, full, backend=args.backend)
        sharded = sum(d is not None for d in step.dims)

        def rank_bytes():
            """Persistent bytes of one rank (parameters and momentum): its
            shard of each sharded leaf (a rank-major stack holds all n),
            each replicated leaf whole."""
            return sum(t.numel() * t.element_size()
                       // (n if n and d is not None else 1)
                       for d, p, s in zip(step.dims, params, opt_state)
                       for t in (p, *s) if torch.is_tensor(t))

        X, Y = dutil.synthetic_mnist(4096, seed=args.seed)
        timer = common.StepTimer(dev)
        timer.start()
        losses = []
        for i, (xb, yb) in enumerate(
                dutil.batches(X, Y, args.batch_size, steps=args.steps,
                              seed=args.seed)):
            xb, yb = common.local_slice(xb, yb, rank_major=bool(n))
            params, opt_state, loss = step(params, opt_state,
                                           *common.to_device(xb, yb, dev))
            timer.tick()
            if i % 25 == 0 or i == args.steps - 1:
                losses.append(float(loss))
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        rate = timer.rate(args.batch_size)
        replicated = 2 * sum(t.numel() * t.element_size() for t in full)
        print(f"sharded param leaves: {sharded}/{len(full)}; parameters "
              f"and momentum {rank_bytes()} B a rank, {replicated} B "
              f"replicated")
        unshard = (recipes.fsdp_unshard_rank_major if n
                   else recipes.fsdp_unshard)
        with torch.no_grad():
            for p, v in zip(model.parameters(), unshard(params, step.dims)):
                p.copy_(v)
        acc = common.evaluate(model, X[:1024], Y[:1024], dev)
        print(f"final accuracy {acc:.3f}  ({rate:.0f} img/s)")
    out = {"losses": losses, "accuracy": acc, "img_per_s": rate,
           "sharded_leaves": sharded, "leaves": len(full),
           "rank_bytes": rank_bytes(), "replicated_bytes": replicated}
    common.check_accuracy(acc, 0.9, args.steps, "FSDP MNIST")
    return out


if __name__ == "__main__":
    main()
