"""Split the synchronous cost of ``checkpoint.save_async`` on the card.

    python3 scripts/torch_ckpt_split.py [--reps 3]

The tree is the one ``chip_smoke.py``'s ``downpour_ps`` phase saves: the
center of AlexNet at 224 x 224, 1000 classes (62,378,344 float32
parameters) and one worker's Adam state over it (748.6 MB in all), every
tensor on the card, filled from a seed.  Each repetition times, on a fresh
tree:

- ``snapshot_s``: ``checkpoint._snapshot``, the copies to pinned host
  memory and their one wait;
- ``savez_s``: ``np.savez`` of those arrays into an in-memory buffer;
- ``call_s``: one ``save_async`` call (both of the above, then the
  submission to the writer);
- ``write_s``: from the call's return until its handle is done (the write,
  fsync and rename on the writer thread).

Prints the card's name and power limit, then one JSON line with every
repetition and the medians.  Writes under ``build/`` and removes what it
wrote.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ckpt_split: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.examples import common
    from torchmpi_tpu_torch.utils import checkpoint

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    model = mpi.models.AlexNet(1000, dropout=0.0, image_size=224,
                               device=dev)
    tx = mpi.optim.adam(3e-4)
    g = torch.Generator(dev).manual_seed(0)

    def tree():
        center = {n: torch.randn(v.shape, device=dev, generator=g)
                  for n, v in common.params_tree(model).items()}
        adam = []
        for v in center.values():
            s = tx.init(v)
            s.mu.normal_(generator=g)
            s.nu.uniform_(generator=g)
            adam.append(s)
        return {"center": center, "adam": adam}

    out_dir = tempfile.mkdtemp(prefix="ckpt_split_",
                               dir=os.path.join(ROOT, "build"))
    reps = []
    try:
        for rep in range(args.reps):
            t = tree()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arrays, _ = checkpoint._snapshot(t)
            t1 = time.perf_counter()
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            t2 = time.perf_counter()
            nbytes = buf.getbuffer().nbytes
            del arrays, buf
            t = tree()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            h = checkpoint.save_async(out_dir, t, step=rep)
            t4 = time.perf_counter()
            while not h.done():
                time.sleep(0.002)
            t5 = time.perf_counter()
            h.wait()
            reps.append({"snapshot_s": t1 - t0, "savez_s": t2 - t1,
                         "call_s": t4 - t3, "write_s": t5 - t4,
                         "bytes": nbytes})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    med = {k: statistics.median(r[k] for r in reps)
           for k in ("snapshot_s", "savez_s", "call_s", "write_s")}
    print(json.dumps({"reps": reps, "median": med}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
