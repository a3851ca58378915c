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
Hierarchical two-level allreduce over an emulated 2-node grid:
  ``python -m torchmpi_tpu_torch.examples.mnist_allreduce --devices 8
  --dcn 2 --backend hierarchical``

``--eager-loss`` reduces each step's logging loss through the host-staged
rank-major allreduce (``backend="host"``) and prints a LOSS-DIGEST line.
``--restart-loop`` drives the steps through ``restart.run_with_restarts``
(a checkpoint every ``--save-every`` steps, restore and replay on a
failure) and prints RESTARTS and RECOVERED-STEP.  The watchdog recipe: a
plan with a ``stall`` at ``host_staged.gather`` on the eager-loss path
(``TORCHMPI_TPU_FAULTS=plan.json``) under ``TORCHMPI_TPU_WATCHDOG=break``
is broken into a typed ``CollectiveHangError``, the run recovers, and its
LOSS-DIGEST equals a clean run's:
  ``python -m torchmpi_tpu_torch.examples.mnist_allreduce --steps 8
  --eager-loss --restart-loop --save-every 2``
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
                          help="drive the steps through "
                               "restart.run_with_restarts; prints "
                               "RESTARTS / RECOVERED-STEP"),
        save_every={"type": int, "default": 10,
                    "help": "checkpoint cadence (--restart-loop only)"})
    info = None
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
        batches = list(dutil.batches(X, Y, args.batch_size,
                                     steps=args.steps, seed=args.seed))
        timer = common.StepTimer(dev)
        timer.start()
        # Keyed by step, so a restart's replayed steps overwrite their own
        # slots: a recovered run's digest equals a clean run's when the
        # replay gives the same losses.
        losses, eager = [], {}

        def train_step(i):
            xb, yb = common.local_slice(*batches[i], rank_major=bool(n))
            loss = step(*common.to_device(xb, yb, dev))
            timer.tick()
            if args.eager_loss:
                # The replicated loss through the host-staged rank-major
                # allreduce (JAX examples/mnist_allreduce.py :93-102).
                loss = mpi.allreduce_rank_major(
                    loss.float().reshape(1, 1).expand(max(1, n), 1),
                    op="mean", backend="host")[0, 0]
                eager[i] = float(loss)
            if i % 20 == 0 or i == args.steps - 1:
                losses.append(float(loss))
                print(f"step {i:4d}  loss {losses[-1]:.4f}")

        if args.restart_loop:
            info = _restart_loop(args, model, opt, train_step)
            print(f"RESTARTS {info['restarts_used']}")
            print(f"RECOVERED-STEP {info['recovered_step']}")
        else:
            for i in range(len(batches)):
                train_step(i)
        rate = timer.rate(args.batch_size)
        acc = common.evaluate(model, X[:1024], Y[:1024], dev)
        print(f"final accuracy {acc:.3f}  ({rate:.0f} img/s)")
    out = {"losses": losses, "accuracy": acc, "img_per_s": rate}
    if info is not None:
        out["restart_info"] = info
    if args.eager_loss:
        # Every loss that crossed the staged path, in step order.
        out["loss_digest"] = hashlib.blake2b(
            np.asarray([eager[i] for i in sorted(eager)],
                       np.float32).tobytes(), digest_size=16).hexdigest()
        print(f"LOSS-DIGEST {out['loss_digest']}")
    common.check_accuracy(acc, 0.9, args.steps, "data-parallel MNIST")
    return out


def _restart_loop(args, model, opt, train_step) -> dict:
    """The steps through ``restart.run_with_restarts`` (JAX :109-135): the
    state is the parameters and the SGD momentum buffers (zeros before the
    first step, which SGD's first step treats alike), checkpointed in a
    temporary directory; a restored state is loaded into the model and
    the optimizer before the step that follows it."""
    import shutil
    import tempfile

    from torchmpi_tpu_torch.utils import restart

    params = dict(model.named_parameters())
    init = {k: p.detach().clone() for k, p in params.items()}
    live = {}

    def snapshot():
        mom = {}
        for k, p in params.items():
            buf = opt.state[p].get("momentum_buffer")
            mom[k] = torch.zeros_like(p) if buf is None else buf
        return {"params": common.params_tree(model), "opt": mom}

    def init_fn():
        return {"params": {k: v.clone() for k, v in init.items()},
                "opt": {k: torch.zeros_like(v) for k, v in init.items()}}

    def step_fn(state, i):
        if state is not live.get("state"):
            common.load_params(model, state["params"])
            for k, p in params.items():
                opt.state[p]["momentum_buffer"] = state["opt"][k].clone()
        train_step(i)
        live["state"] = snapshot()
        return live["state"]

    ckpt_dir = tempfile.mkdtemp(prefix="tm_wd_ckpt_")
    try:
        state, info = restart.run_with_restarts(
            init_fn, step_fn, steps=args.steps, directory=ckpt_dir,
            save_every=args.save_every)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if state is not live.get("state"):
        common.load_params(model, state["params"])  # no step after it
    return info


if __name__ == "__main__":
    main()
