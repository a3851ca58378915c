#!/usr/bin/env python3
"""How often the float32 backward's TF32 product (rows 5 f32 and 6 f32 of
PERF.md's kernel table, the ``wgmma_tf32`` route) must start a fresh
partial sum: variants of its flush period timed and checked side by side.

    python3 scripts/torch_xent_tf32_variants.py [--rounds 2]

needs one CUDA card and nvcc.  It compiles the port's
``torchmpi_tpu_torch/ops/csrc/xent_bwd_dx.cu`` and ``xent_bwd_dw.cu``
(nvcc, sm_90a, the port's own flags) into
``build/torch_kernels/variants_tf32/`` once for each flush period, from a
copy of the sources whose ``xent_wgmma.cuh`` sets ``TFLUSH`` to it (2, 4,
the committed one, 8 and 16 stages of 32, and one accumulator over the
whole depth), then at the flagship's LM-head
shape (N 8188, E 2048, V 32768, float32) runs ``xent_bwd_dx``,
``xent_bwd_dw`` and ``xent_bwd`` (g once per chunk) through each
variant's libraries: CUDA events, median of 7 calls, in ``--rounds``
turns, and dx's and dW's largest error relative to the largest
|plain float32 result|.  Prints one JSON line with the card's name and
power limit and whether ptxas warned of serialized wgmmas (C7518).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E, V = 8188, 2048, 32768
# Flush periods in 32-deep stages; 4096 exceeds dx's 1024 stages: one
# accumulator.
PERIODS = {"flush2": 2, "flush4": 4, "flush8": 8, "flush16": 16,
           "one_accumulator": 4096}
LIBS = ("xent_bwd_dx", "xent_bwd_dw")


COMMITTED = "TFLUSH = 4;"


def build(_build) -> dict:
    """{(variant, lib): (CDLL, warned)}, all compiled in parallel."""
    out_dir = _build.BUILD_DIR / "variants_tf32"
    nvcc = _build.nvcc_path()
    header = (_build.CSRC / "xent_wgmma.cuh").read_text()
    if header.count(COMMITTED) != 1:
        raise RuntimeError(f"xent_wgmma.cuh no longer sets {COMMITTED!r}")
    procs = {}
    for name, period in PERIODS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        (src / "xent_wgmma.cuh").write_text(
            header.replace(COMMITTED, f"TFLUSH = {period};"))
        for lib in LIBS:
            so = out_dir / f"lib{lib}-{name}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(so),
                   str(src / f"{lib}.cu")]
            procs[(name, lib)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = (ctypes.CDLL(str(so)), "C7518" in log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torchmpi_tpu_torch.ops import _build, xent

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(_build)
    _build.build(["xent_fwd"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(N, E, generator=g, device=dev)
    w = torch.randn(E, V, generator=g, device=dev) / E ** 0.5
    lab = torch.randint(0, V, (N,), generator=g, device=dev)
    dl = torch.full((N,), 1.0 / N, device=dev)
    _, lse = xent.xent_fwd(x, w, lab)
    ref_dx = xent.xent_bwd_dx_plain(x, w, lab, lse, dl)
    ref_dw = xent.xent_bwd_dw_plain(x, w, lab, lse, dl)

    def time_ms(fn, iters=7):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    res = {}
    saved = {lib: _build._libs.get(lib) for lib in LIBS}
    try:
        for _ in range(args.rounds):
            for name in PERIODS:
                for lib in LIBS:
                    _build._libs[lib] = libs[(name, lib)][0]
                r = res.setdefault(name, {
                    "dx_ms": [], "dw_ms": [], "bwd_ms": [],
                    "c7518": any(libs[(name, lib)][1] for lib in LIBS)})
                r["dx_ms"].append(time_ms(
                    lambda: xent.xent_bwd_dx(x, w, lab, lse, dl)))
                r["dw_ms"].append(time_ms(
                    lambda: xent.xent_bwd_dw(x, w, lab, lse, dl)))
                r["bwd_ms"].append(time_ms(
                    lambda: xent.xent_bwd(x, w, lab, lse, dl)))
                if "dx_rel_err" not in r:
                    dx, dw = xent.xent_bwd(x, w, lab, lse, dl)
                    r["dx_rel_err"] = rel(dx, ref_dx)
                    r["dw_rel_err"] = rel(dw, ref_dw)
                    del dx, dw
    finally:
        for lib, v in saved.items():
            if v is None:
                _build._libs.pop(lib, None)
            else:
                _build._libs[lib] = v
    print(json.dumps({"card": card, "shape": dict(N=N, E=E, V=V,
                                                  dtype="float32"),
                      "periods": PERIODS, "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
