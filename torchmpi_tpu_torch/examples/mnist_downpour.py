"""MNIST LeNet, asynchronous Downpour SGD via the parameter server.

The counterpart of the JAX package's ``examples/mnist_downpour.py``: each
worker computes gradients on its own minibatch, pushes ``-lr * grad`` to
the sharded server with the ``add`` rule (the server *is* the optimizer),
steps its own replica by the same update so progress continues between
fetches, and refreshes the replica from an async prefetch that it polls
through ``handle.done``.  Workers are host threads, each with its own
replica of the model (``common.run_workers``: on the card they share it,
each on its own stream).

Run: ``python -m torchmpi_tpu_torch.examples.mnist_downpour``
(``--device cpu`` on the CPU; ``--workers``, ``--fetch-every``,
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
        fetch_every=dict(type=int, default=5),
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
        # Seeded with the initial parameters: the analog of
        # synchronizeParameters before async training starts.
        ps = mpi.parameterserver.init(params0, num_shards=args.shards)

        def worker(w):
            model = replicas[w]
            names, params = zip(*model.named_parameters())
            fetch = None
            for step, (xb, yb) in enumerate(dutil.batches(
                    X, Y, args.batch_size, steps=args.steps,
                    seed=args.seed + w + 1)):
                x, y = common.to_device(xb, yb, dev)
                loss = F.cross_entropy(model(x), y)
                grads = torch.autograd.grad(loss, params)
                update = {n: -args.lr * g for n, g in zip(names, grads)}
                ps.send(update, rule="add")  # async push, no wait
                with torch.no_grad():
                    for n, p in zip(names, params):
                        p.add_(update[n])
                losses[w].append(loss.detach())
                if fetch is not None and fetch.done:
                    common.load_params(model, fetch.wait())
                    fetch = None
                if step % args.fetch_every == 0 and fetch is None:
                    fetch = ps.receive()  # prefetch

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
        print(f"worker-0 loss first/last: {out['losses'][0]:.4f} / "
              f"{out['losses'][-1]:.4f}")
        print(f"final accuracy (PS params) {acc:.3f}")
    common.check_accuracy(acc, 0.9, args.steps, "downpour MNIST")
    return out


if __name__ == "__main__":
    main()
