"""CIFAR-10 ResNet-20, synchronous data-parallel SGD (BASELINE config 2).

The counterpart of the JAX package's ``examples/cifar_resnet20.py``: the
full stateful-model path.  BatchNorm running statistics are averaged over
the ranks with the same collective route as the gradients
(``recipes.make_bn_dp_train_step``).

Run: ``python -m torchmpi_tpu_torch.examples.cifar_resnet20 --steps 60``
(``--device cpu`` on the CPU; ``--zero 1`` shards the optimizer state,
``--zero 3`` also the parameters between steps; ``--devices 4 --backend
pallas`` runs 4 ranks rank-major on one card over the ring kernels, with
``--dcn 2`` as a 2 x 2 two-level grid, ``--backend hierarchical`` over
the two-level verbs; ``torchrun --nproc-per-node N -m ...`` one rank per
process).
"""

import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import optim, recipes
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import ResNet20
from torchmpi_tpu_torch.parallel import zero as pzero
from torchmpi_tpu_torch.utils import data as dutil


def init_state(model, tx, args):
    """(step, params, opt_state, batch_stats, params_template) of the
    recipe at ``args.zero`` over ``args.devices`` ranks rank-major, or one
    rank per process: replicated from rank 0, or sharded."""
    n = args.devices
    params, stats = recipes.bn_state(model)
    # Shapes only: holding a full copy through the run would defeat
    # ZeRO-3's 1/n persistent parameters.
    template = [torch.empty_like(p, device="meta") for p in params]
    kw = dict(backend=args.backend, n_buckets=args.buckets, zero=args.zero,
              params_template=template if args.zero == 3 else None)
    if n:
        step = recipes.make_bn_dp_train_step_rank_major(model, tx, n, **kw)
    else:
        step = recipes.make_bn_dp_train_step(model, tx, **kw)
    if args.zero == 0:
        params, opt, stats = recipes.replicate_bn_state(
            params, [tx.init(p) for p in params], stats)
    else:
        recipes.replicate_bn_state(params, (), stats)
        opt = (pzero.init_rank_major(params, tx, n) if n
               else pzero.init(params, tx))
        if args.zero == 3:
            params = (pzero.shard_params_rank_major(params, n) if n
                      else pzero.shard_params(params))
    return step, params, opt, stats, template


def full_params(params, template, args):
    """The full parameter list (ZeRO-3 shards gathered, for evaluation)."""
    if args.zero != 3:
        return params
    if args.devices:
        return pzero.unshard_params_rank_major(params, template)
    return pzero.unshard_params(params, template)


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"lr": 0.2, "steps": 60, "batch_size": 128},
        zero=dict(type=int, default=0, choices=[0, 1, 3],
                  help="ZeRO level: 1 shards optimizer state, 3 also "
                       "shards the parameters between steps"))
    with common.runtime(args) as dev:
        model = ResNet20(device=dev, generator=torch.Generator(
            dev).manual_seed(args.seed))
        tx = optim.sgd(args.lr, momentum=args.momentum)
        step, params, opt, stats, template = init_state(model, tx, args)

        X, Y = dutil.synthetic_cifar(4096, seed=args.seed)
        timer = common.StepTimer(dev)
        timer.start()
        losses = []
        for i, (xb, yb) in enumerate(
                dutil.batches(X, Y, args.batch_size, steps=args.steps,
                              seed=args.seed)):
            xb, yb = common.local_slice(xb, yb,
                                        rank_major=bool(args.devices))
            params, opt, stats, loss = step(
                params, opt, stats, *common.to_device(xb, yb, dev))
            timer.tick()
            if i % 10 == 0 or i == args.steps - 1:
                losses.append(float(loss))
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        rate = timer.rate(args.batch_size)
        recipes.load_bn_state(model, full_params(params, template, args),
                              stats)
        acc = common.evaluate(model, X[:1024], Y[:1024], dev, train=False)
        print(f"final accuracy {acc:.3f}  ({rate:.0f} img/s)"
              f"  rank {mpi.rank()}/{mpi.size()}")
    common.check_accuracy(acc, 0.85, args.steps, "CIFAR ResNet-20")
    return {"losses": losses, "accuracy": acc, "img_per_s": rate}


if __name__ == "__main__":
    main()
