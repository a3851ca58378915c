"""ImageNet ResNet-50 data-parallel: the headline workload (BASELINE
config 3).

The counterpart of the JAX package's ``examples/imagenet_resnet50.py``, on
synthetic ImageNet-shaped data: the interesting part is the step
throughput.  Batches reach the card through the background prefetcher
(``utils.input_pipeline.prefetch_to_device``), so the host-to-device copy
of batch N+1 overlaps step N.

Run (card): ``python -m torchmpi_tpu_torch.examples.imagenet_resnet50
               --steps 30 --batch-size 256 --bf16``
Run (CPU, small): ``python -m torchmpi_tpu_torch.examples.imagenet_resnet50
               --device cpu --steps 3 --batch-size 4 --image-size 32
               --num-classes 10``
``--zero`` shards the optimizer state (ZeRO-1); ``--devices 4 --backend
pallas`` runs 4 ranks rank-major on one card over the ring kernels, and
``--dcn 2`` makes them a 2 x 2 two-level grid (BASELINE config 5 with
``--backend hierarchical``).
"""

import time

import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import optim
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.examples.cifar_resnet20 import init_state
from torchmpi_tpu_torch.models import ResNet50
from torchmpi_tpu_torch.utils import data as dutil
from torchmpi_tpu_torch.utils.input_pipeline import prefetch_to_device


def main(argv=None):
    args = common.parse_args(
        __doc__, argv,
        image_size=dict(type=int, default=224),
        num_classes=dict(type=int, default=1000),
        bf16=dict(action="store_true", help="bfloat16 compute"),
        warmup=dict(type=int, default=3),
        zero=dict(action="store_const", const=1, default=0,
                  help="ZeRO-1: shard optimizer state over the ranks"))
    with common.runtime(args) as dev:
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        model = ResNet50(num_classes=args.num_classes, dtype=dtype,
                         device=dev, generator=torch.Generator(
                             dev).manual_seed(args.seed))
        tx = optim.sgd(args.lr, momentum=args.momentum)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"ResNet-50: {n_params / 1e6:.1f}M params, dtype {dtype}"
              + (", ZeRO-1 sharded optimizer" if args.zero else ""))
        step, params, opt, stats, _ = init_state(model, tx, args)

        X, Y = dutil.synthetic_image_classification(
            max(512, args.batch_size * 2),
            image_shape=(args.image_size, args.image_size, 3),
            num_classes=args.num_classes, seed=args.seed)
        rank_major = bool(args.devices)
        it = prefetch_to_device(
            (common.local_slice(xb, yb, rank_major=rank_major)
             for xb, yb in dutil.batches(X, Y, args.batch_size,
                                         steps=args.steps + args.warmup,
                                         seed=args.seed)),
            depth=2, device=dev)
        losses = []
        t0 = None
        for i, (xb, yb) in enumerate(it):
            if i == args.warmup:
                common.sync(dev)
                t0 = time.perf_counter()
            params, opt, stats, loss = step(
                params, opt, stats, xb.permute(0, 3, 1, 2), yb.long())
            if i % 10 == 0 or i == args.steps + args.warmup - 1:
                losses.append(float(loss))
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
        common.sync(dev)
        dt = time.perf_counter() - t0
        cards = 1 if rank_major else mpi.size()
        imgs = args.steps * args.batch_size
        print(f"throughput {imgs / dt:.1f} img/s total, "
              f"{imgs / dt / cards:.1f} img/s/card ({cards} cards)")
    return {"losses": losses, "img_per_s": imgs / dt}


if __name__ == "__main__":
    main()
