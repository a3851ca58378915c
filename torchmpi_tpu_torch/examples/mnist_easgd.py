"""MNIST LeNet, asynchronous EASGD via the parameter server's elastic rule.

The counterpart of the JAX package's ``examples/mnist_easgd.py``: each
worker runs local SGD and every ``tau`` steps makes an elastic exchange
with the center variable: ``delta = alpha * (x_i - center)``; the server
moves the center by ``+delta`` (the ``elastic`` rule) and the worker moves
itself by ``-delta``, the symmetric elastic averaging of Zhang et al.
Workers are host threads, each with its own replica of the model
(``common.run_workers``).

Run: ``python -m torchmpi_tpu_torch.examples.mnist_easgd``
(``--device cpu`` on the CPU; ``--workers``, ``--tau``, ``--alpha``,
``--shards``).
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
        workers=dict(type=int, default=4),
        tau=dict(type=int, default=4),
        alpha=dict(type=float, default=0.3),
        shards=dict(type=int, default=2),
        defaults={"steps": 120, "batch_size": 64, "lr": 0.02})
    with common.runtime(args) as dev:
        model0 = LeNet(device=dev, generator=torch.Generator(dev).manual_seed(
            args.seed))
        params0 = common.params_tree(model0)
        replicas = [LeNet(device=dev) for _ in range(args.workers)]
        for m in replicas:
            common.load_params(m, params0)
        X, Y = dutil.synthetic_mnist(4096, seed=args.seed)
        losses = [[] for _ in range(args.workers)]
        ps = mpi.parameterserver.init(params0, num_shards=args.shards)

        def worker(w):
            model = replicas[w]
            names, params = zip(*model.named_parameters())
            for step, (xb, yb) in enumerate(dutil.batches(
                    X, Y, args.batch_size, steps=args.steps,
                    seed=args.seed + w + 1)):
                x, y = common.to_device(xb, yb, dev)
                loss = F.cross_entropy(model(x), y)
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    for p, g in zip(params, grads):
                        p.sub_(args.lr * g)
                losses[w].append(loss.detach())
                if step % args.tau == args.tau - 1:
                    delta = ps.send(common.params_tree(model),
                                    rule="elastic", alpha=args.alpha).wait()
                    with torch.no_grad():
                        for n, p in zip(names, params):
                            p.sub_(delta[n])

        try:
            common.run_workers(worker, args.workers, dev)
            common.load_params(model0, ps.receive().wait())
            ops = ps.ops_served()
        finally:
            ps.shutdown()
        acc = common.evaluate(model0, X[:1024], Y[:1024], dev)
        out = {"losses": [float(v) for v in losses[0]], "accuracy": acc,
               "ops_served": ops}
        print(f"PS ops served: {ops}")
        print(f"final accuracy (center) {acc:.3f}")
    common.check_accuracy(acc, 0.9, args.steps, "EASGD MNIST")
    return out


if __name__ == "__main__":
    main()
