#!/usr/bin/env python3
"""Variants of the bf16 flash backward (rows 2 bf16 and 3 bf16 of PERF.md's
kernel table, the ``wgmma_bf16`` route) timed and checked side by side.

    python3 scripts/torch_flash_bwd_bf16_variants.py [--rounds 2]

needs one CUDA card and nvcc.  It compiles the port's
``torchmpi_tpu_torch/ops/csrc/flash_bwd_dq_wgmma.cu`` and
``flash_bwd_dkv_wgmma.cu`` (nvcc, sm_90a, the port's own flags) into
``build/torch_kernels/variants_flash_bf16/`` once for each variant, by
``-D`` flags on the committed sources: the committed tiles (dK/dV 64 q
rows a step, dQ 64 keys a step), dK/dV at 32 q rows a step and dQ at 128
keys a step.
At the flagship's attention shape (B 4, T 2048, 16 q / 4 kv heads, head
dim 128, causal, window 1024, bf16 q / k / v) it runs each variant's dO
split, dQ and dK/dV kernels through their C launchers on a float32 dO
that is not bf16-exact (every split product) and on that dO rounded to
bf16 (its lo products skipped), in ``--rounds`` turns (variants in order,
then reversed): CUDA events, median of 7 calls each; beside them one bf16
autograd backward of PyTorch's scaled_dot_product_attention on the same
inputs and mask (the yardstick).  Each variant's largest error relative
to the largest |plain float32-dO result| of dq, dk and dv is reported on
both dO kinds: the bf16 one is the error of skipping the lo products of
a dO that has them.  Prints one JSON line with the card's name and power
limit, each variant's ptxas registers, spills and performance notes on
its wgmma (C75xx: ptxas serialized them), the times, the errors and the
split form's floors at the bf16 dense rate.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, HKV, D, WINDOW = 4, 2048, 16, 4, 128, 1024
PEAK_BF16_FLOPS = 989e12
LIBS = ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
# -D flags a variant.
VARIANTS = {
    "committed": {},
    "dkv_bq32": {"TMF_DKV_BQ": 32},
    "dq_bk128": {"TMF_DQ_BK": 128},
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SCALARS = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]


def build(_build) -> dict:
    """{(variant, lib): (CDLL, ptxas summary)}, all compiled in parallel."""
    out_dir = _build.BUILD_DIR / "variants_flash_bf16"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, defs in VARIANTS.items():
        flags = [f"-D{k}={v}" for k, v in defs.items()]
        for lib in LIBS:
            so = out_dir / f"lib{lib}-{name}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so),
                   str(_build.CSRC / f"{lib}.cu")]
            procs[(name, lib)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = sorted(set(int(n) for n in re.findall(r"Used (\d+) registers",
                                                     log)))
        spills = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", log))
        libs[key] = (ctypes.CDLL(str(so)),
                     {"registers": regs, "spill_bytes": spills,
                      "wgmma_notes": sorted(set(re.findall(r"C75\d\d",
                                                           log)))})
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
    from torchmpi_tpu_torch.ops import _build, flash

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(_build)
    _build.build(["flash_fwd"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    q = torch.randn(B, T, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, T, HKV, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, T, HKV, D, generator=g, device=dev).bfloat16()
    dof = torch.randn(B, T, H, D, generator=g, device=dev)
    dob = dof.bfloat16()
    scale = 1.0 / math.sqrt(D)
    kw = dict(scale=scale, causal=True, window=WINDOW)
    o, lse = flash.flash_fwd(q, k, v, **kw)
    dvec = {"f32": torch.einsum("bqhd,bqhd->bhq", dof,
                                o.float()).contiguous(),
            "bf16": torch.einsum("bqhd,bqhd->bhq", dob.float(),
                                 o.float()).contiguous()}
    refs = (flash.flash_bwd_dq_plain(q, k, v, dof, lse, dvec["f32"], **kw),
            *flash.flash_bwd_dkv_plain(q, k, v, dof, lse, dvec["f32"], **kw))
    ref_max = [float(r.abs().max()) for r in refs]
    n = dof.numel()
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, sym, n_ptrs):
        fn = getattr(lib, sym)
        fn.argtypes = [_P] * n_ptrs + _SCALARS
        fn.restype = ctypes.c_int
        return fn

    def calls(name):
        """(split, dq, dkv) closures of variant ``name`` on a float32 dO,
        and (dq, dkv) on its bf16 rounding; outputs preallocated."""
        ldq, ldkv = libs[(name, LIBS[0])][0], libs[(name, LIBS[1])][0]
        split_fn = ldq.tm_flash_bwd_split
        split_fn.argtypes = [_P, _P, _P, ctypes.c_long, _P]
        split_fn.restype = ctypes.c_int
        dq_fn = launcher(ldq, "tm_flash_bwd_dq_bf16", 9)
        dkv_fn = launcher(ldkv, "tm_flash_bwd_dkv_bf16", 10)
        hi = torch.empty_like(dob)
        lo = torch.empty_like(dob)
        dq = torch.empty_like(dof)
        dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
        tail = (B, T, T, H, HKV, D, scale, 1, WINDOW, 0, 0, stream)

        def check(rc):
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        def split():
            check(split_fn(dof.data_ptr(), hi.data_ptr(), lo.data_ptr(), n,
                           stream))

        def run_dq(kind):
            do_ptrs = ((hi.data_ptr(), lo.data_ptr(), dof.data_ptr())
                       if kind == "f32" else (dob.data_ptr(), None, None))
            check(dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *do_ptrs,
                        lse.data_ptr(), dvec[kind].data_ptr(),
                        dq.data_ptr(), *tail))

        def run_dkv(kind):
            do_ptrs = ((hi.data_ptr(), lo.data_ptr(), dof.data_ptr())
                       if kind == "f32" else (dob.data_ptr(), None, None))
            check(dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *do_ptrs,
                         lse.data_ptr(), dvec[kind].data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), *tail))

        return split, run_dq, run_dkv, (dq, dk, dv)

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

    fns = {name: calls(name) for name in VARIANTS}
    out = {name: {"ptxas": {lib: libs[(name, lib)][1] for lib in LIBS},
                  "defines": VARIANTS[name]} for name in VARIANTS}
    for name, (split, run_dq, run_dkv, outs) in fns.items():
        errs = {}
        for kind in ("f32", "bf16"):
            if kind == "f32":
                split()
            run_dq(kind)
            run_dkv(kind)
            torch.cuda.synchronize()
            errs[kind] = max(float((a - r).abs().max()) / m
                             for a, r, m in zip(outs, refs, ref_max))
        out[name]["rel_err_f32_do"] = errs["f32"]
        out[name]["rel_err_lo_skipped"] = errs["bf16"]
    del refs

    pos = torch.arange(T, device=dev)
    live = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                             < WINDOW)
    pairs = B * H * int(live.sum())
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=live, scale=scale, enable_gqa=True)
    do_t = dob.transpose(1, 2)
    times = {name: {} for name in VARIANTS}
    sdpa_ms = []
    order = list(VARIANTS)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            split, run_dq, run_dkv, _ = fns[name]
            t = times[name]
            t.setdefault("split", []).append(time_ms(split))
            for kind in ("f32", "bf16"):
                t.setdefault(f"dq_{kind}", []).append(
                    time_ms(lambda: run_dq(kind)))
                t.setdefault(f"dkv_{kind}", []).append(
                    time_ms(lambda: run_dkv(kind)))
        sdpa_ms.append(time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True)))
    for name, t in times.items():
        med = {key: statistics.median(vals) for key, vals in t.items()}
        out[name]["ms"] = med
        out[name]["ms_rounds"] = t
        out[name]["total_ms_f32_do"] = (med["split"] + med["dq_f32"] +
                                        med["dkv_f32"])
        out[name]["total_ms_bf16_do"] = med["dq_bf16"] + med["dkv_bf16"]
    floors = {"dq_split": 8 * D * pairs, "dkv_split": 14 * D * pairs,
              "dq_lo_skipped": 6 * D * pairs, "dkv_lo_skipped": 10 * D * pairs,
              "dq_all_bf16": 6 * D * pairs, "dkv_all_bf16": 8 * D * pairs}
    print(json.dumps({
        "script": "torch_flash_bwd_bf16_variants", "card": card,
        "shape": dict(B=B, T=T, H=H, Hkv=HKV, D=D, window=WINDOW,
                      dtype="bfloat16"),
        "live_pairs": pairs, "rounds": args.rounds,
        "floor_ms": {k: f / PEAK_BF16_FLOPS * 1e3 for k, f in floors.items()},
        "sdpa_bwd_ms": statistics.median(sdpa_ms), "sdpa_bwd_ms_rounds":
        sdpa_ms, "variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
