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

``--eager-loss`` (the host-staged loss allreduce) and ``--restart-loop``
(checkpointed restarts) are not ported and raise by name.
"""

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
                        help="host-staged loss allreduce: not ported"),
        restart_loop=dict(action="store_true",
                          help="checkpointed restart loop: not ported"),
        save_every={"type": int, "default": 10,
                    "help": "checkpoint cadence (--restart-loop only)"})
    if args.eager_loss:
        raise NotImplementedError(
            "--eager-loss: the host-staged collectives (staged=True) are not "
            "ported yet (ROADMAP queue A, item 2)")
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
    common.check_accuracy(acc, 0.9, args.steps, "data-parallel MNIST")
    return {"losses": losses, "accuracy": acc, "img_per_s": rate}


if __name__ == "__main__":
    main()
