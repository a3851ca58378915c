"""Checkpoint / restart recovery: train, "crash", resume from the latest
checkpoint.

The counterpart of the JAX package's ``examples/checkpoint_resume.py``,
its default path: LeNet trained with ``data_parallel_step`` (SGD with
momentum), a step-0 checkpoint and then one every 10 steps through
``checkpoint.save_async`` (the host snapshot in the step loop, the write,
fsync and rename on the native writer, overlapping the following steps),
a "crash" at the halfway mark, then a fresh model and optimizer restored
from the latest checkpoint, the data stream replayed to the resume point,
and training continued to ``--steps``; the final loss must be below the
loss at the crash.  Each process writes its own files
(``ckpt_<step>_p<rank>``), so it runs as well under ``torchrun``.

``--restart-loop`` (the JAX package's ``restart.run_with_restarts`` loop
with durable checkpoints) is not ported and raises by name.

Run: ``python -m torchmpi_tpu_torch.examples.checkpoint_resume``
(``--device cpu`` on the CPU).
"""

import shutil
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import LeNet
from torchmpi_tpu_torch.utils import checkpoint
from torchmpi_tpu_torch.utils import data as dutil


def _tools(args, dev):
    model = LeNet(device=dev, generator=torch.Generator(dev).manual_seed(
        args.seed))
    opt = torch.optim.SGD(model.parameters(), lr=args.lr,
                          momentum=args.momentum)
    return model, opt


def _state(model, opt, step: int) -> dict:
    """The checkpointed tree: parameters, the SGD momentum buffers (zeros
    before the first step, which SGD's first step treats alike) and the
    step."""
    mom = {}
    for n, p in model.named_parameters():
        buf = opt.state[p].get("momentum_buffer")
        mom[n] = torch.zeros_like(p) if buf is None else buf
    return {"params": common.params_tree(model), "opt": mom,
            "step": np.int64(step)}


def _loss(model, x, y):
    return F.cross_entropy(model(x), y)


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 40, "batch_size": 128},
        restart_loop={"action": "store_true",
                      "help": "the run_with_restarts durable-checkpoint "
                              "recipe: not ported"},
        save_every={"type": int, "default": 10},
        ckpt_dir={"type": str, "default": None,
                  "help": "checkpoint directory (default: a temp dir, "
                          "removed on exit)"})
    if args.restart_loop:
        raise NotImplementedError(
            "--restart-loop: the restart loop and the durable checkpoints "
            "are not ported yet (ROADMAP queue A, item 13)")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="tm_ckpt_")
    try:
        with common.runtime(args) as dev:
            X, Y = dutil.synthetic_mnist(2048, seed=args.seed)

            def batch(xb, yb):
                xb, yb = common.local_slice(xb, yb, rank_major=False)
                return common.to_device(xb, yb, dev)

            # --- phase 1: train, checkpointing every save_every steps,
            # "crash" midway.  The single-thread writer is FIFO, so only
            # the last save needs a wait at the crash point.
            model, opt = _tools(args, dev)
            step = mpi.nn.data_parallel_step(model, opt, _loss)
            crash_at = args.steps // 2
            pending = checkpoint.save_async(ckpt_dir, _state(model, opt, 0),
                                            step=0)
            losses = []
            for i, (xb, yb) in enumerate(dutil.batches(
                    X, Y, args.batch_size, steps=crash_at, seed=args.seed)):
                losses.append(float(step(*batch(xb, yb))))
                if i % args.save_every == args.save_every - 1:
                    # Fence the previous save before the next: the wait is
                    # where a failed write surfaces as an exception.
                    pending.wait(timeout=120.0)
                    pending = checkpoint.save_async(
                        ckpt_dir, _state(model, opt, i + 1), step=i + 1)
            pending.wait(timeout=120.0)
            print(f"phase 1: step {crash_at} loss {losses[-1]:.4f}; "
                  f"latest ckpt step {checkpoint.latest_step(ckpt_dir)}")
            pre_crash = losses[-1]
            del model, opt, step  # the crash

            # --- phase 2: fresh state, resumed from the latest checkpoint.
            model, opt = _tools(args, dev)
            restored = checkpoint.restore(ckpt_dir, _state(model, opt, 0))
            resume_step = int(restored["step"])
            common.load_params(model, restored["params"])
            for n, p in model.named_parameters():
                opt.state[p]["momentum_buffer"] = restored["opt"][n].clone()
            step = mpi.nn.data_parallel_step(model, opt, _loss)
            print(f"phase 2: resumed from step {resume_step}")
            for i, (xb, yb) in enumerate(dutil.batches(
                    X, Y, args.batch_size, steps=args.steps,
                    seed=args.seed)):
                if i < resume_step:
                    continue  # replay the stream to the resume point
                losses.append(float(step(*batch(xb, yb))))
            final = losses[-1]
            print(f"final loss {final:.4f} (pre-crash {pre_crash:.4f})")
    finally:
        if not args.ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not final < pre_crash:
        raise AssertionError(f"resume did not continue improving: final "
                             f"{final} >= pre-crash {pre_crash}")
    return {"losses": losses, "pre_crash": pre_crash, "final": final,
            "resume_step": resume_step}


if __name__ == "__main__":
    main()
