"""MNIST LeNet, single-device sequential baseline.

The counterpart of the JAX package's ``examples/mnist_sequential.py``: the
non-distributed control run the distributed variants are compared against.
SGD with momentum (``torch.optim.SGD``, optax.sgd's update).

Run: ``python -m torchmpi_tpu_torch.examples.mnist_sequential --steps 100``
(``--device cpu`` on the CPU)
"""

import torch
import torch.nn.functional as F

from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import LeNet
from torchmpi_tpu_torch.models.layers import check_device
from torchmpi_tpu_torch.utils import data as dutil


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = check_device(args.device)
    model = LeNet(device=dev, generator=torch.Generator(dev).manual_seed(
        args.seed))
    opt = torch.optim.SGD(model.parameters(), lr=args.lr,
                          momentum=args.momentum)

    def step(x, y):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    X, Y = dutil.synthetic_mnist(4096, seed=args.seed)
    timer = common.StepTimer(dev)
    timer.start()
    losses = []
    for i, (xb, yb) in enumerate(
            dutil.batches(X, Y, args.batch_size, steps=args.steps,
                          seed=args.seed)):
        loss = step(*common.to_device(xb, yb, dev))
        timer.tick()
        if i % 20 == 0 or i == args.steps - 1:
            losses.append(float(loss))
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    rate = timer.rate(args.batch_size)
    acc = common.evaluate(model, X[:1024], Y[:1024], dev)
    print(f"final accuracy {acc:.3f}  ({rate:.0f} img/s)")
    common.check_accuracy(acc, 0.9, args.steps, "sequential MNIST")
    return {"losses": losses, "accuracy": acc, "img_per_s": rate}


if __name__ == "__main__":
    main()
