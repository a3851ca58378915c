"""AlexNet asynchronous Downpour SGD — BASELINE config 4.

The counterpart of the JAX package's ``examples/alexnet_downpour.py``:
the Downpour structure of ``mnist_downpour`` with the reference's
ImageNet-era model, dropout 0.  Each worker keeps its own Adam
(``optim.adam``), pushes its update to the server with the ``axpy`` rule
scaled by 1 / K (so the center moves by the average of the K workers'
updates), prefetches the center at step s and adopts it at step s + 1
through ``wait()`` (staleness bounded at one step).  The defaults (64 x 64
images, 10 classes, batch 32, 2 workers, 4 shards, lr 3e-4, 80 steps)
are the JAX example's; the full configuration is ``--image-size 224
--num-classes 1000 --batch-size 128``.  The bar is the JAX example's:
the center's accuracy above twice chance.

Run: ``python -m torchmpi_tpu_torch.examples.alexnet_downpour``
(``--device cpu`` on the CPU).
"""

import torch
import torch.nn.functional as F

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import optim
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import AlexNet
from torchmpi_tpu_torch.utils import data as dutil


def downpour_step(model, names, params, tx, states, ps, x, y, alpha, fetch,
                  step, fetch_every):
    """One worker step: the loss's gradients, Adam per leaf (``states``
    updated in place), the update pushed with ``axpy`` at ``alpha`` and
    added locally, then the prefetch: a fetch in flight is adopted through
    ``wait()``, else one starts every ``fetch_every`` steps (prefetch at
    step s, adopt at s + 1).  Returns ``(loss, push, updates, fetch)``:
    the detached loss, the push's handle, the update tree and the fetch
    now in flight (None if none)."""
    loss = F.cross_entropy(model(x, train=False), y)
    grads = torch.autograd.grad(loss, params)
    updates = {}
    for i, (n, g) in enumerate(zip(names, grads)):
        updates[n], states[i] = tx.update(g, states[i])
    push = ps.send(updates, rule="axpy", alpha=alpha)
    with torch.no_grad():
        for n, p in zip(names, params):
            p.add_(updates[n])
    if fetch is not None:
        common.load_params(model, fetch.wait())
        fetch = None
    elif step % fetch_every == 0:
        fetch = ps.receive()
    return loss.detach(), push, updates, fetch


def main(argv=None):
    args = common.parse_args(
        __doc__, argv,
        workers=dict(type=int, default=2),
        fetch_every=dict(type=int, default=5),
        shards=dict(type=int, default=4),
        image_size=dict(type=int, default=64),
        num_classes=dict(type=int, default=10),
        # lr: AlexNet has no normalization layers; the JAX example found
        # Adam above ~1e-3 oscillating in place on this cold start while
        # 3e-4 trains.
        defaults={"steps": 80, "batch_size": 32, "lr": 3e-4})
    with common.runtime(args) as dev:

        def make():
            return AlexNet(args.num_classes, dropout=0.0,
                           image_size=args.image_size, device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               args.seed))

        model0 = make()
        params0 = common.params_tree(model0)
        replicas = [make() for _ in range(args.workers)]
        for m in replicas:
            common.load_params(m, params0)
        tx = optim.adam(args.lr)
        X, Y = dutil.synthetic_image_classification(
            1024, image_shape=(args.image_size, args.image_size, 3),
            num_classes=args.num_classes, seed=args.seed)
        losses = [[] for _ in range(args.workers)]
        ps = mpi.parameterserver.init(params0, num_shards=args.shards)

        def worker(w):
            model = replicas[w]
            names, params = zip(*model.named_parameters())
            states = [tx.init(p.detach()) for p in params]
            fetch = None
            for step, (xb, yb) in enumerate(dutil.batches(
                    X, Y, args.batch_size, steps=args.steps,
                    seed=args.seed + w + 1)):
                x, y = common.to_device(xb, yb, dev)
                loss, _, _, fetch = downpour_step(
                    model, names, params, tx, states, ps, x, y,
                    1.0 / args.workers, fetch, step, args.fetch_every)
                losses[w].append(loss)

        try:
            common.run_workers(worker, args.workers, dev)
            common.load_params(model0, ps.receive().wait())
            ops = ps.ops_served()
        finally:
            ps.shutdown()
        acc = common.evaluate(model0, X[:256], Y[:256], dev, train=False)
        out = {"losses": [float(v) for v in losses[0]], "accuracy": acc,
               "ops_served": ops}
        print(f"PS ops served: {ops}")
        print(f"final accuracy (PS params) {acc:.3f}  "
              f"(chance {1 / args.num_classes:.3f})")
    common.check_accuracy(acc, 2.0 / args.num_classes, args.steps,
                          "AlexNet downpour")
    return out


if __name__ == "__main__":
    main()
