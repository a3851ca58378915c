#!/usr/bin/env python3
"""Where the fused loss's forward (row 4 of PERF.md's kernel table) spends
its time on the card: variants of its wgmma epilogue timed side by side.

    python3 scripts/torch_xent_fwd_variants.py [--rounds 2]

needs one CUDA card and nvcc.  It compiles four versions of the port's
``torchmpi_tpu_torch/ops/csrc/xent_fwd.cu`` (nvcc, sm_90a, the port's own
flags) into ``build/torch_kernels/variants/``, each differing only in the
``StatFold`` epilogue that folds the 128 x 256 tile of z = x . W (as
``StatEpi``; the float32 route's ``StatF32Epi`` shares the fold):

- ``committed``: the source as it is;
- ``masked``: the column mask tested for every element of every tile;
- ``no_exp``: l summed without ``expf`` (not the function: cost only);
- ``product_only``: one store a row, no fold (the product's own time).

Then, at the flagship's LM-head shape (N 8188, E 2048, V 32768, bf16), it
times each variant's C entry on the wgmma route (CUDA events, median of
20 calls, in ``--rounds`` turns), reports whether ``committed`` and
``masked`` give the same bits, and times beside them the g kernel alone
(the backward's dx launch with and without forming g over all rows) and
one bf16 ``torch.matmul`` of the same shape.  Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E, V = 8188, 2048, 32768


def variants(src: str) -> dict:
    """{name: source} of the epilogue variants of xent_fwd.cu."""
    i0 = src.index("  __device__ __forceinline__ void operator()",
                   src.index("struct StatFold"))
    i1 = src.index("\n};\n", i0)
    body = src[i0:i1]
    product_only = '''  __device__ __forceinline__ void operator()(
      const float (&d)[NACC], int r0, int c0) const {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NACC; ++i) s += d[i];
    if (r0 < N && (threadIdx.x & 3) == 0) part[(long)blockIdx.y * N + r0] = s;
  }'''
    no_exp = body
    for k in ("", " + 1"):
        no_exp = no_exp.replace(f"l += expf(d[4 * j + 2 * h{k}] - m);",
                                f"l += d[4 * j + 2 * h{k}] - m;")
    out = {"committed": body, "masked": body.replace("all || ", ""),
           "no_exp": no_exp, "product_only": product_only}
    for name, b in out.items():
        if name != "committed" and b == body:
            raise RuntimeError(f"variant {name} did not change the source")
    return {k: src[:i0] + b + src[i1:] for k, b in out.items()}


def build(build_dir: str) -> dict:
    from torchmpi_tpu_torch.ops import _build

    src = open(_build.CSRC / "xent_fwd.cu").read()
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(build_dir, f"xent_fwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(build_dir, f"libxent_fwd_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = so
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torchmpi_tpu_torch.ops import xent

    wgmma = xent.ROUTES.index("wgmma")  # the launchers' route code

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build(os.path.join(ROOT, "build", "torch_kernels", "variants"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(N, E, generator=g, device=dev).bfloat16()
    w = (torch.randn(E, V, generator=g, device=dev) / E ** 0.5).bfloat16()
    lab = torch.randint(0, V, (N,), generator=g, device=dev).int()
    nt = -(-V // 256)
    P, I = ctypes.c_void_p, ctypes.c_int

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    out = {name: [] for name in libs}
    out.update(g_ms=[], matmul_ms=[])
    outputs = {}
    for _ in range(args.rounds):
        for name, so in libs.items():
            fn = ctypes.CDLL(so).tm_xent_fwd
            fn.argtypes = [P] * 6 + [I] * 5 + [P] * 4
            part = torch.empty(3, nt, N, device=dev)
            loss, lse = torch.empty(N, device=dev), torch.empty(N, device=dev)

            def run():
                rc = fn(x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                        part.data_ptr(), loss.data_ptr(), lse.data_ptr(), N,
                        E, V, nt, wgmma, None, None, None,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            run()
            outputs[name] = (loss.clone(), lse.clone())
            out[name].append(time_ms(run))
        lse = outputs["committed"][1]
        dl = torch.full((N,), 1.0 / N, device=dev)
        gw = torch.empty(N, V, dtype=torch.bfloat16, device=dev)
        dx = torch.empty_like(x)

        def dx_launch(make_g):
            xent._launch("xent_bwd_dx", dev, x, w, lab, lse, dl, gw, dx, N, E,
                         V, make_g, wgmma)

        out["g_ms"].append(time_ms(lambda: dx_launch(1), 10)
                           - time_ms(lambda: dx_launch(0), 10))
        out["matmul_ms"].append(time_ms(lambda: torch.matmul(x, w), 10))
        del gw, dx
    same = all(torch.equal(a, b) for a, b in zip(outputs["committed"],
                                                  outputs["masked"]))
    print(json.dumps({"card": card, "shape": dict(N=N, E=E, V=V),
                      "ms": out, "masked_bitwise_committed": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
