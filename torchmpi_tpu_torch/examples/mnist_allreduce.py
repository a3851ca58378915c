"""MNIST LeNet, synchronous data-parallel SGD via gradient allreduce.

The counterpart of the JAX package's ``examples/mnist_allreduce.py``: the
"add 4 lines to go distributed" pitch.  The four lines here:
``mpi.init()``, ``synchronize_parameters`` (inside ``data_parallel_step``),
``synchronize_gradients`` in the step, and ``mpi.stop()``.

Run as a world of one (``--device cpu`` on the CPU):
  ``python -m torchmpi_tpu_torch.examples.mnist_allreduce --steps 100``
One rank per process:
  ``torchrun --nproc-per-node 2 -m
  torchmpi_tpu_torch.examples.mnist_allreduce``
4 ranks rank-major on one card, gradients synced by the ring kernels:
  ``python -m torchmpi_tpu_torch.examples.mnist_allreduce --devices 4
  --backend pallas``

``--eager-loss`` reduces each step's logging loss through the host-staged
rank-major allreduce (``backend="host"``) and prints a LOSS-DIGEST line;
``--restart-loop`` (checkpointed restarts) is not ported and raises by
name.
"""

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import LeNet
from torchmpi_tpu_torch.utils import data as dutil


def main(argv=None):
    args = common.parse_args(
        __doc__, argv,
        eager_loss=dict(action="store_true",
                        help="reduce the logging loss through the host-"
                             "staged rank-major allreduce; prints "
                             "LOSS-DIGEST"),
        restart_loop=dict(action="store_true",
                          help="checkpointed restart loop: not ported"),
        save_every={"type": int, "default": 10,
                    "help": "checkpoint cadence (--restart-loop only)"})
    if args.restart_loop:
        raise NotImplementedError(
            "--restart-loop: the restart and watchdog layers are not ported "
            "yet (ROADMAP queue A, item 10)")
    with common.runtime(args) as dev:
        n = args.devices
        print(f"rank {mpi.rank()}/{mpi.size()}"
              + (f", {n} ranks rank-major" if n else ""))
        model = LeNet(device=dev, generator=torch.Generator(dev).manual_seed(
            args.seed))
        opt = torch.optim.SGD(model.parameters(), lr=args.lr,
                              momentum=args.momentum)

        def loss_fn(m, x, y):
            return F.cross_entropy(m(x), y)

        if n:
            step = mpi.nn.data_parallel_step_rank_major(
                model, opt, loss_fn, n, backend=args.backend)
        else:
            step = mpi.nn.data_parallel_step(model, opt, loss_fn)

        X, Y = dutil.synthetic_mnist(4096, seed=args.seed)
        timer = common.StepTimer(dev)
        timer.start()
        losses, eager = [], []
        for i, (xb, yb) in enumerate(
                dutil.batches(X, Y, args.batch_size, steps=args.steps,
                              seed=args.seed)):
            xb, yb = common.local_slice(xb, yb, rank_major=bool(n))
            loss = step(*common.to_device(xb, yb, dev))
            timer.tick()
            if args.eager_loss:
                # The replicated loss through the host-staged rank-major
                # allreduce (JAX examples/mnist_allreduce.py :93-102).
                loss = mpi.allreduce_rank_major(
                    loss.float().reshape(1, 1).expand(max(1, n), 1),
                    op="mean", backend="host")[0, 0]
                eager.append(float(loss))
            if i % 20 == 0 or i == args.steps - 1:
                losses.append(float(loss))
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        rate = timer.rate(args.batch_size)
        acc = common.evaluate(model, X[:1024], Y[:1024], dev)
        print(f"final accuracy {acc:.3f}  ({rate:.0f} img/s)")
    out = {"losses": losses, "accuracy": acc, "img_per_s": rate}
    if args.eager_loss:
        # Every loss that crossed the staged path, in step order.
        out["loss_digest"] = hashlib.blake2b(
            np.asarray(eager, np.float32).tobytes(),
            digest_size=16).hexdigest()
        print(f"LOSS-DIGEST {out['loss_digest']}")
    common.check_accuracy(acc, 0.9, args.steps, "data-parallel MNIST")
    return out


if __name__ == "__main__":
    main()
