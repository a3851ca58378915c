#!/usr/bin/env python3
"""How far the bf16 flagship's flash and local (dense) attention paths
each sit from a float32 evaluation of the same weights, as the weights
train.

    python3 scripts/torch_lm_consistency.py [--steps 0,4,11]

needs one CUDA card and nvcc.  It builds chip_smoke.py's flagship
TransformerLM (bf16 compute, flash attention) at its seed weights and
batch, takes the fused bf16 DP step of chip_smoke.py's stage B' up to each
step count, and there takes the dense loss's gradients three ways on the
same weights: flash attention in bf16, local attention in bf16 (chip_smoke's
consistency oracle) and local attention in float32.  Prints one JSON line
per step count: the largest per-tensor relative L2 difference of flash vs
local, flash vs float32 and local vs float32, and the four tensors where
flash and local differ most, with their float32 gradient norms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="0,4,11")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torchmpi_tpu_torch as mpi

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = mpi.init()
    try:
        model, tok = cs.flagship(torch, mpi, dev, torch.bfloat16)
        opt = torch.optim.SGD(model.parameters(), lr=cs.LR)
        step = mpi.nn.data_parallel_step(
            model, opt, lambda m, t: cs.fused_lm_loss(torch, mpi, m, t))

        def grads(m):
            return cs._loss_and_grads(m, lambda: cs.lm_loss(torch, m, tok))

        def rel(a, b):
            return {n: float((a[n].float() - b[n].float()).norm()
                             / b[n].float().norm().clamp_min(1e-30))
                    for n in b}

        done = 0
        for target in sorted(int(v) for v in args.steps.split(",")):
            while done < target:
                step(tok)
                done += 1
            got = {"flash": grads(model)}
            for impl, dtype in (("local", torch.bfloat16),
                                ("float32", torch.float32)):
                other = mpi.models.TransformerLM(
                    **cs.LM, attn_impl="local", dtype=dtype, device=dev)
                other.load_state_dict(model.state_dict())
                got[impl] = grads(other)
                del other
                torch.cuda.empty_cache()
            (_, gf), (_, gl), (_, gt) = (got[k] for k in
                                         ("flash", "local", "float32"))
            fl, ft, lt = rel(gf, gl), rel(gf, gt), rel(gl, gt)
            worst = sorted(fl, key=fl.get)[-4:]
            print(json.dumps({
                "card": card, "steps": target,
                "losses": {k: v[0] for k, v in got.items()},
                "flash_vs_local_max": max(fl.values()),
                "flash_vs_float32_max": max(ft.values()),
                "local_vs_float32_max": max(lt.values()),
                "worst": {n: {"flash_vs_local": fl[n],
                              "flash_vs_float32": ft[n],
                              "local_vs_float32": lt[n],
                              "float32_norm": float(gt[n].norm())}
                          for n in worst}}), flush=True)
            del got, gf, gl, gt
    finally:
        mpi.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
