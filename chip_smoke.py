#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchmpi_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (nvcc), and nothing else of the
JAX package.  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ops/csrc with nvcc (sm_90a, one compiler per
   source, in parallel) into build/torch_kernels/: fourteen kernels in
   seven libraries;
3. kernel phases: at the flagship LM's attention shapes (B 4, T 2048, 16 q /
   4 kv heads, head_dim 128, causal, window 1024, float32) runs each flash
   kernel against its plain PyTorch version on the same seeded inputs (each
   also run twice and required bitwise equal; a small pass at head dims 8
   and 96, which the wrappers zero-pad to the kernels' 16 and 128), and times
   kernel, plain version and, as the yardstick only, PyTorch's
   scaled_dot_product_attention with the same mask: its forward beside the
   forward kernel, one autograd backward through it (dq, dk and dv
   together) beside each of the two backward kernels;
   then, at the flagship's LM-head shapes (N 4 x 2047 tokens, E 2048,
   V 32768, bf16), the three fused linear + cross-entropy kernels the same
   way, each also run twice and required bitwise equal (rows 4, 5 and 6 on
   their wgmma route, which the route counters must show, with one bf16
   torch.matmul at each product's shape timed beside them as context), the
   backward as the step runs it (xent_bwd: g once per chunk, dx and dW;
   against the plain versions, bitwise against rows 5 and 6 and a repeat,
   timed also in one chunk), and the dense
   two-call loss (bf16 x @ w, then cross_entropy; forward and backward) timed
   beside them as context only; the same three kernels on float32 operands
   (the tf32x3 route: within 1e-4 of the plain float32 versions, bitwise on
   a repeat, one float32 torch.matmul of each product as context); then
   the four ring-allreduce kernels on 4
   ranks' float32 buffers on the card at the flagship's gradient bucket
   (8,249,691 elements a rank, rows 16 bytes apart as the fused sync lays
   a bucket out), each under the chunk_bytes / pallas_bidirectional config
   that maps the bucket onto it, bitwise against the plain ring and
   against a repeat call, plus a bfloat16 and an int32 pass at 300,001
   elements (rows 8, 7, 11 and 12, all direct reductions, also against
   their own folds and on contiguous rows, their element path; row 12 also
   at 16,385 elements, where its halves fold in ring chunks of different
   lengths; row 11 also timed at 300,001 elements under the default
   chunk_bytes, which maps that size onto it); then the four ring
   reduce-scatter and all-gather kernels at the flagship's ZeRO shapes (4
   ranks, the
   reduce-scatter of 486,731,776 float32 a rank, the all-gather of the
   121,682,944-element shards) under chunk_bytes 4 MiB (rows 9 and 10)
   and 512 MiB (the resident rows 13 and 14), all four direct, the same
   way, with the stock rank-major routes timed beside them;
4. dense train phase (stage B): mpi.init() (NCCL, world of 1) and three
   data-parallel SGD steps (lr 0.02) of the flagship TransformerLM at full
   width and depth (embed 2048, depth 8, GQA 16/4, head_dim 128, T 2048,
   vocab 32768, window 1024, RoPE, bf16 compute, float32 parameters,
   batch 4) with attn_impl="flash" and the dense loss (f32 x @ head);
5. fused train phase (stage B', the main path of the first two slices):
   the same steps with the fused loss, fused_linear_cross_entropy(h.bf16,
   head.bf16, labels); every kernel's launch count must be > 0, every
   launch of the head (forward and backward) on the wgmma route, and the
   loss finite and falling; then the same fused steps at the model's
   default float32 (the head's every launch on the tf32x3 route); in every
   train phase one more, untimed step counts the host-device
   synchronizations of a step, which must be 0;
6. consistency phases: one forward and backward of the same weights and
   batch with attn_impl="local" (dense oracle) and "flash", and with the
   dense and the fused loss;
7. ring DP phase (the main path of the ring slice): the flagship as a DP
   step of 4 ranks on the one card, each rank's gradients stacked
   rank-major and synced by the fused rank-major allreduce under backend
   "pallas" (59 buckets, one ring launch each); 3 steps under the default
   config (row 8 of the kernel table), one each under the configs of rows
   7, 11 and 12; every sync bitwise equal to the plain ring on the same
   stacks, the first within 2e-2 (rel. L2) of the batch-4 gradients, the
   loss falling, 0 host syncs in a step, all four ring kernels launched,
   every launch of the four on its 16-byte path; then one more sync's
   device
   time by kernel (torch.profiler) and 3 more whole steps on the host's
   clock;
8. ZeRO phase (the main path of the ZeRO slice): the flagship as ZeRO data
   parallelism of 4 ranks on the one card with Adam (lr 1e-3): the 4 ranks'
   gradients in one [4, 486,731,776] stack, 3 ZeRO-1 steps under the
   default config (rows 9 and 10), 1 under chunk_bytes 512 MiB (rows 13 and
   14), 2 ZeRO-3 steps (gather_params, then update3); every reduce-scatter
   and all-gather bitwise equal to the plain ring, the gathered ranks
   equal, each ZeRO-3 update equal to a ZeRO-1 update on the same stack,
   the first ZeRO-1 step within 1e-4 (rel. L2 of the updates) of a
   replicated Adam step from the same state (every step's gap reported),
   the loss falling, 0 host syncs in a step, all four kernels launched,
   every launch of the four on its 16-byte path; the peak device memory
   of each leg, and one more update's device time by kernel
   (torch.profiler);
9. ResNet-50 phase (the main path of the CNN slice): ResNet-50 at full
   width and depth (224 x 224, 1000 classes, bf16 compute, float32
   parameters) as the BatchNorm DP recipe
   (recipes.make_bn_dp_train_step_rank_major) of 4 ranks on the one card,
   64 images a rank, SGD lr 0.01 momentum 0.9, backend "pallas", batches
   from synthetic_image_classification through prefetch_to_device: 3
   replicated steps with every gradient bucket (row 8) and the BatchNorm
   statistics (row 11) bitwise equal to the plain ring, 3 timed by CUDA
   events (step ms, img/s, peak memory), one counting host syncs (0), one
   profiled by part (convolutions, batch norm, ring rows, copies), then a
   ZeRO-1 and a ZeRO-3 step from the same state and batch as a replicated
   one (rows 9 and 10 bitwise equal to the plain ring, ZeRO-1's update
   within 1e-4 of the replicated one), every launch of rows 8 and 11 on
   the 16-byte path (ZeRO's 6,389,258-element shard is not a multiple of
   16 bytes: rows 9 and 10 take their element path there);
10. CNN examples phase: the port's mnist_sequential, mnist_allreduce and
   cifar_resnet20 (ZeRO 0 and 3) in-process as a world of one on the
   card, each to its accuracy bar (MNIST > 0.9, CIFAR > 0.85);
11. prints the kernels' summary line (each kernel's launches summed over
   the main paths, and by path), then {"ok": true, "device": ...}.

Each phase prints one JSON line.  Any failed check raises and the script
exits non-zero; it exits non-zero without a result when no card is visible
or the package is missing.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

SEED = 0
# The flagship LM (bench.py stage B', dense loss of stage B).
LM = dict(vocab=32768, embed=2048, depth=8, num_heads=16, head_dim=128,
          num_kv_heads=4, max_len=2048, window=1024, pos_emb="rope")
BATCH, SEQ, LR, STEPS = 4, 2048, 0.02, 3
# The flagship's LM-head shapes: every token but the last of each row.
HEAD_N = BATCH * (SEQ - 1)
# H100 SXM peaks (NVIDIA data sheet): TF32 and bf16 dense tensor-core
# rates, HBM3 rate.
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_RTOL = 1e-4      # f32 kernel vs plain: summation order differs
# xent kernels: loss / lse are f32 sums in another order; dx / dW come out
# in bf16, so one bf16 rounding of the largest element; on float32
# operands (the tf32x3 route) g is not rounded and the three-product form
# keeps f32's accuracy, so dx / dW are held as loss and lse are.
XENT_STAT_RTOL = 1e-4
XENT_GRAD_RTOL = 2.0 ** -7
XENT_F32_GRAD_RTOL = 1e-4
CONSISTENCY_RTOL = 2e-2  # bf16 model: local vs flash, dense vs fused loss
# The ring slice: RING_N ranks rank-major on the one card.  The flagship's
# 486,731,776 float32 gradients cut by FusedSpec at fuse_max_bytes 32 MiB
# give 59 buckets; the first one is the kernels' size.
RING_N = 4
FLAGSHIP_GRADS = 486_731_776
RING_BUCKETS = 59
RING_BUCKET = FLAGSHIP_GRADS // RING_BUCKETS  # linspace's first bucket
# (chunk_bytes, pallas_bidirectional) that map the bucket onto each row.
RING_CONFIGS = {
    "ring_allreduce_chunked": (4 << 20, False),       # row 8, the default
    "ring_allreduce_bidir_chunked": (1 << 20, True),  # row 7
    "ring_allreduce": (16 << 20, False),              # row 11
    "ring_allreduce_bidir": (16 << 20, True),         # row 12
}
RING_SMALL = 300_001  # elements per rank of the bf16 and int32 passes
# Row 12 at 16,385 elements a rank: its halves (8,192 and 8,193) pad to
# ring chunks of 2,048 and 3,072 elements for RING_N ranks.
RING_UNEQUAL_HALVES = 16_385
# The flash kernels at head dims they are not built for (zero-padded by the
# wrappers): (B, T, H, Hkv, window), causal.
FLASH_PAD_SHAPE = (1, 256, 4, 2, 64)
FLASH_PAD_HEAD_DIMS = (8, 96)
DP_RTOL = 2e-2  # synced mean vs the batch-4 gradients (bf16 model)
# The ZeRO slice: the flagship's 486,731,776 float32 parameters (a multiple
# of 4, no padding) sharded over RING_N ranks, 121,682,944 a rank.  The
# chunk_bytes that map the reduce-scatter of the whole gradient stack and
# the all-gather of the shards onto each row: 4 MiB (the default) plans C =
# 117 subchunks, 512 MiB holds a ring chunk in one slot.
ZERO_SHARD = FLAGSHIP_GRADS // RING_N
ZERO_CONFIGS = {"chunked": 4 << 20, "resident": 512 << 20}
ZERO_ROWS = {
    "chunked": ("ring_reduce_scatter_chunked", "ring_all_gather_chunked"),
    "resident": ("ring_reduce_scatter", "ring_all_gather"),
}
ZERO_SMALL = 300_000  # elements per rank of the bf16 and int32 passes
# Recorded constants, not measured here: the times and figures of the
# kernels that the redesigned rows replaced (the ring-walking kernels of
# rows 7-14, the f32-FMA flash kernels of rows 1, 2 and 3, the
# cp.async / wmma kernels of the fused loss, rows 4, 5 and 6), at the
# same shapes and by the same time_ms (PERF.md's kernel table and section
# 5, H100 80GB HBM3 at 700 W).  The output prints them under
# ring_recorded_* keys (earlier_ms in the kernel rows).
RING_RECORDED_MS = {"ring_allreduce_bidir_chunked": 1.042,
                    "ring_allreduce_chunked": 0.731,
                    "ring_reduce_scatter_chunked": 23.480,
                    "ring_all_gather_chunked": 14.340,
                    "ring_allreduce": 0.708,
                    "ring_allreduce_bidir": 0.925,
                    "ring_reduce_scatter": 18.970,
                    "ring_all_gather": 10.518}
FLASH_RECORDED_MS = {"flash_fwd": 3.215, "flash_bwd_dq": 4.212,
                     "flash_bwd_dkv": 6.005}
# The wmma-product kernels of rows 4, 5 and 6 (PERF.md's kernel table).
XENT_RECORDED_MS = {"xent_fwd": 7.083, "xent_bwd_dx": 12.665,
                    "xent_bwd_dw": 14.460}
RING_RECORDED_DP_SYNC_MS = 60.5
RING_RECORDED_ZERO_PEAK_GB = 33.20
ZERO_LR = 1e-3  # Adam, as benchmarks/memory_bench.py :58
ZERO_RTOL = 1e-4  # ZeRO-1 vs replicated Adam: rel. L2 of the updates
# The CNN slice: ResNet-50 (BASELINE config 3, examples/imagenet_resnet50.py's
# card line: 224 x 224, 1000 classes, bf16 compute, a batch of 256) as R50_N
# ranks rank-major on the one card, R50_BATCH images a rank, SGD as the
# examples' defaults.  Its 25,557,032 float32 gradients cut into 4 buckets
# of about 6.39 M a rank at fuse_max_bytes 32 MiB (row 8 at the default 4
# MiB chunk_bytes); its BatchNorm statistics, 53,120 float32, sync as one
# bucket on row 11; its ZeRO-1 / ZeRO-3 legs are rows 9 and 10.
R50_N, R50_BATCH, R50_IMAGE, R50_CLASSES = 4, 64, 224, 1000
R50_LR, R50_MOMENTUM = 0.01, 0.9
R50_PARAMS, R50_STATS, R50_BUCKETS = 25_557_032, 53_120, 4
R50_ROWS = ("ring_allreduce_chunked", "ring_allreduce",
            "ring_reduce_scatter_chunked", "ring_all_gather_chunked")
# The replicated sync's rows, whose every launch must take the 16-byte
# path (the fused sync's buckets are 16-byte aligned).  ZeRO's shard,
# 6,389,258 float32, is not a multiple of 16 bytes, so rows 9 and 10 run
# their element path on it (reported).
R50_VECTOR_ROWS = ("ring_allreduce_chunked", "ring_allreduce")
R50_CHECKED_STEPS = R50_TIMED_STEPS = 3
R50_ZERO_RTOL = 1e-4  # ZeRO-1 vs replicated SGD: rel. L2 of the updates
# Where a step's device time goes: the first pattern a kernel's name
# matches names its part.
STEP_PARTS = (
    ("ring rows", r"ring_direct"),
    ("batch norm", r"batch_?norm|bn_fw|bn_bw"),
    ("pooling", r"pool"),
    ("convolutions", r"conv|xmma|implicit|dgrad|wgrad|fprop|gemm|cutlass|"
                     r"nhwc|nchw"),
    ("copies and casts", r"copy|Copy|Memcpy|CatArray|cat_"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise|vectorized"),
)
# The examples run in-process, a world of one on the card, to their
# accuracy bars (MNIST > 0.9, CIFAR > 0.85; each raises below it).
CNN_EXAMPLES = (("mnist_sequential", (), 0.9), ("mnist_allreduce", (), 0.9),
                ("cifar_resnet20", ("--zero", "0"), 0.85),
                ("cifar_resnet20", ("--zero", "3"), 0.85))

SOURCES = {
    "flash_fwd": ("torchmpi_tpu_torch/ops/csrc/flash_fwd.cu",
                  "torchmpi_tpu/ops/flash.py:265"),
    "flash_bwd_dq": ("torchmpi_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "torchmpi_tpu/ops/flash.py:358"),
    "flash_bwd_dkv": ("torchmpi_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "torchmpi_tpu/ops/flash.py:424"),
    "xent_fwd": ("torchmpi_tpu_torch/ops/csrc/xent_fwd.cu",
                 "torchmpi_tpu/ops/xent.py:35"),
    "xent_bwd_dx": ("torchmpi_tpu_torch/ops/csrc/xent_bwd_dx.cu",
                    "torchmpi_tpu/ops/xent.py:82"),
    "xent_bwd_dw": ("torchmpi_tpu_torch/ops/csrc/xent_bwd_dw.cu",
                    "torchmpi_tpu/ops/xent.py:114"),
    "ring_allreduce_bidir_chunked": (
        "torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
        "torchmpi_tpu/ops/ring.py:534"),
    "ring_allreduce_chunked": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                               "torchmpi_tpu/ops/ring.py:511"),
    "ring_allreduce": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                       "torchmpi_tpu/ops/ring.py:265"),
    "ring_allreduce_bidir": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                             "torchmpi_tpu/ops/ring.py:203"),
    "ring_reduce_scatter_chunked": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                                    "torchmpi_tpu/ops/ring.py:707"),
    "ring_all_gather_chunked": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                                "torchmpi_tpu/ops/ring.py:733"),
    "ring_reduce_scatter": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                            "torchmpi_tpu/ops/ring.py:310"),
    "ring_all_gather": ("torchmpi_tpu_torch/ops/csrc/ring_direct.cu",
                        "torchmpi_tpu/ops/ring.py:342"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call of ``fn`` over ``iters`` calls, by
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_rows(torch, fn) -> list:
    """(kernel name, calls, device ms) of one call of ``fn``
    (torch.profiler), largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0.0) if t is None else t
        if t > 0:
            rows.append((e.key, e.count, t / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def device_breakdown(torch, fn, top: int = 8) -> dict:
    """Device time of one call of ``fn`` by kernel name (torch.profiler):
    the total and the ``top`` largest names with their call counts."""
    rows = [(k[:100], c, ms) for k, c, ms in profile_rows(torch, fn)]
    return {"total_ms": sum(r[2] for r in rows),
            "top": [{"kernel": k, "calls": c, "ms": ms}
                    for k, c, ms in rows[:top]]}


def nvidia_smi(query: str) -> str:
    """First card's ``--query-gpu=<query>`` as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def count_host_syncs(torch, fn) -> int:
    """Host-device synchronizations inside one call of ``fn``: PyTorch's
    sync debug mode warns at each one, and the warnings are counted."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def ptxas_summary(log: str) -> dict:
    """{"D<head_dim>", "<kernel name>", "<kernel name><dtype>" or
    "wgmma<epilogue>": "registers; spills"} per kernel instantiation, from
    nvcc's -Xptxas -v report."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(.*?)'", ln)
        if m:
            d = re.search(r"ILi(\d+)E", m.group(1))
            name = re.search(r"(?:flash|xent|ring)_\w*?kernel(I\w*?EE)?",
                             m.group(1))
            epi = re.search(r"gemm_kernelI\w*?\d([A-Z][a-z][A-Za-z]*Epi)E",
                            m.group(1))
            key = (f"D{d.group(1)}" if d else
                   f"wgmma<{epi.group(1)}>" if epi else
                   name.group(0) if name else m.group(1))
            cur = out.setdefault(key, [])
        elif cur is not None and ("registers" in ln or "spill" in ln):
            cur.append(ln.split("info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_phase(torch, flash, dev):
    B, T, H, Hkv, D, W = (BATCH, SEQ, LM["num_heads"], LM["num_kv_heads"],
                          LM["head_dim"], LM["window"])
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(B, T, H, D, generator=g, device=dev)
    k = torch.randn(B, T, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, T, Hkv, D, generator=g, device=dev)
    do = torch.randn(B, T, H, D, generator=g, device=dev)
    kw = dict(scale=1.0 / math.sqrt(D), causal=True, window=W)

    o, lse = flash.flash_fwd(q, k, v, **kw)
    o2, lse2 = flash.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, **kw)
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    dq2 = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    dq_ref = flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dk2, dv2 = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    torch.cuda.synchronize()
    # Every flash kernel is deterministic: a second call gives the same bits.
    bitwise = {
        "flash_fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
        "flash_bwd_dq": torch.equal(dq, dq2),
        "flash_bwd_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2),
    }
    del o2, lse2, dq2, dk2, dv2

    # Live (q, k) pairs of this mask, counted from the mask itself.
    pos = torch.arange(T, device=dev)
    live = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    pairs = B * H * int(live.sum())
    nbytes = lambda *ts: 4 * sum(t.numel() for t in ts)  # noqa: E731
    work = {  # matmul flops (2 per multiply-add) and bytes moved
        "flash_fwd": (4 * D * pairs, nbytes(q, k, v, o, lse)),
        "flash_bwd_dq": (6 * D * pairs, nbytes(q, k, v, do, lse, dvec, dq)),
        "flash_bwd_dkv": (8 * D * pairs,
                          nbytes(q, k, v, do, lse, dvec, dk, dv)),
    }
    errs = {
        "flash_fwd": (max_err(o, o_ref), float(o_ref.abs().max()),
                      max_err(lse, lse_ref)),
        "flash_bwd_dq": (max_err(dq, dq_ref), float(dq_ref.abs().max()),
                         None),
        "flash_bwd_dkv": (max(max_err(dk, dk_ref), max_err(dv, dv_ref)),
                          max(float(dk_ref.abs().max()),
                              float(dv_ref.abs().max())), None),
    }
    del o_ref, lse_ref, dq_ref, dk_ref, dv_ref

    runs = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, **kw),
                      lambda: flash.flash_fwd_plain(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw),
            lambda: flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw)),
        "flash_bwd_dkv": (
            lambda: flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw),
            lambda: flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)),
    }
    # Yardsticks (never used by the port): one PyTorch call on the same
    # inputs and mask for the forward, and one autograd backward through
    # that call for the backward kernels.  No PyTorch call computes dq or
    # dk / dv alone: the backward's time is for all three, so it compares
    # with rows 2 and 3 together.
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=live, scale=kw["scale"], enable_gqa=True)

    with torch.no_grad():
        sdpa_err = max_err(sdpa().transpose(1, 2), o)
    sdpa_out, do_t = sdpa(), do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                   retain_graph=True)

    library_ms = {"flash_fwd": time_ms(torch, torch.no_grad()(sdpa))}
    library_ms["flash_bwd_dq"] = library_ms["flash_bwd_dkv"] = time_ms(
        torch, sdpa_bwd)

    rows = []
    for name, (kern, plain) in runs.items():
        err, ref_max, lse_err = errs[name]
        flops, nb = work[name]
        t_op, t_b = flops / PEAK_TF32_FLOPS * 1e3, nb / PEAK_HBM_BYTES * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "max_abs_err": err, "tolerance": KERNEL_RTOL * ref_max,
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "library_ms": library_ms[name],
            "library_call": ("sdpa forward" if name == "flash_fwd" else
                             "sdpa backward: dq + dk + dv together"),
            "flops": flops, "bytes": nb,
        }
        if lse_err is not None:
            row["lse_max_abs_err"] = lse_err
            row["sdpa_max_abs_err"] = sdpa_err
        row["bitwise_repeat"] = bitwise[name]
        row["earlier_ms"] = FLASH_RECORDED_MS[name]
        rows.append(row)
    del sdpa_out, qt, kt, vt
    emit({"phase": "kernels", "shape": dict(B=B, T=T, H=H, Hkv=Hkv, D=D,
                                            window=W, dtype="float32"),
          "live_pairs": pairs, "launches_in_phase": dict(flash.LAUNCHES),
          "kernels": rows})
    for row in rows:
        check(row["max_abs_err"] <= row["tolerance"],
              f"{row['name']} max_abs_err {row['max_abs_err']} > "
              f"{row['tolerance']}")
        check(row["bitwise_repeat"], f"{row['name']}: two calls differ")
    check(errs["flash_fwd"][2] <= KERNEL_RTOL * float(lse.abs().max()),
          "flash_fwd lse disagrees with the plain version")
    flash_pad_pass(torch, flash, dev)
    return rows


def flash_pad_pass(torch, flash, dev):
    """The three flash kernels at head dims they are not built for
    (FLASH_PAD_HEAD_DIMS; the wrappers zero-pad q / k / v / dO to the next
    kernel head dim and slice the outputs back) against their plain
    versions, within the flash tolerance; the launches are counted."""
    B, T, H, Hkv, W = FLASH_PAD_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = []
    for D in FLASH_PAD_HEAD_DIMS:
        q, do = (torch.randn(B, T, H, D, generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, T, Hkv, D, generator=g, device=dev)
                for _ in range(2))
        kw = dict(scale=1.0 / math.sqrt(D), causal=True, window=W)
        before = dict(flash.LAUNCHES)
        o, lse = flash.flash_fwd(q, k, v, **kw)
        dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
        got = {"flash_fwd": (o, lse),
               "flash_bwd_dq": (flash.flash_bwd_dq(q, k, v, do, lse, dvec,
                                                   **kw),),
               "flash_bwd_dkv": flash.flash_bwd_dkv(q, k, v, do, lse, dvec,
                                                    **kw)}
        launches = {n: flash.LAUNCHES[n] - before[n] for n in before}
        want = {"flash_fwd": flash.flash_fwd_plain(q, k, v, **kw),
                "flash_bwd_dq": (flash.flash_bwd_dq_plain(
                    q, k, v, do, lse, dvec, **kw),),
                "flash_bwd_dkv": flash.flash_bwd_dkv_plain(
                    q, k, v, do, lse, dvec, **kw)}
        torch.cuda.synchronize()
        for name in got:
            err = max(max_err(a, b) for a, b in zip(got[name], want[name]))
            tol = KERNEL_RTOL * max(float(b.abs().max()) for b in want[name])
            out.append({"name": name, "head_dim": D,
                        "kernel_head_dim": flash.kernel_head_dim(D),
                        "shape_ok": all(a.shape == b.shape for a, b in zip(
                            got[name], want[name])),
                        "max_abs_err": err, "tolerance": tol,
                        "launches": launches[name]})
    emit({"phase": "flash_head_dim_pad",
          "shape": dict(zip(("B", "T", "H", "Hkv", "window"),
                            FLASH_PAD_SHAPE)), "kernels": out})
    for r in out:
        check(r["shape_ok"] and r["max_abs_err"] <= r["tolerance"],
              f"{r['name']} at head dim {r['head_dim']}: max_abs_err "
              f"{r['max_abs_err']} > {r['tolerance']}")
        check(r["launches"] == 1, f"{r['name']} at head dim "
              f"{r['head_dim']}: {r['launches']} launches")


def xent_kernel_phase(torch, xent, dev):
    """The three fused linear + cross-entropy kernels at the flagship's
    LM-head shapes, against their plain versions on the same inputs."""
    N, E, V = HEAD_N, LM["embed"], LM["vocab"]
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    # h after the final LayerNorm is ~N(0, 1); the head is drawn as the
    # model draws it; dl is the mean loss's 1/N.
    x = torch.randn(N, E, generator=g, device=dev).bfloat16()
    w = (torch.randn(E, V, generator=g, device=dev) / math.sqrt(E)).bfloat16()
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    dl = torch.full((N,), 1.0 / N, device=dev)

    runs = {
        "xent_fwd": (lambda: xent.xent_fwd(x, w, labels),
                     lambda: xent.xent_fwd_plain(x, w, labels)),
    }
    loss, lse = runs["xent_fwd"][0]()
    runs["xent_bwd_dx"] = (
        lambda: xent.xent_bwd_dx(x, w, labels, lse, dl),
        lambda: xent.xent_bwd_dx_plain(x, w, labels, lse, dl))
    runs["xent_bwd_dw"] = (
        lambda: xent.xent_bwd_dw(x, w, labels, lse, dl),
        lambda: xent.xent_bwd_dw_plain(x, w, labels, lse, dl))
    errs, bitwise = {}, {}
    for name, (kern, plain) in runs.items():
        out, again = kern(), kern()
        ref = plain()
        out, again, ref = ((t,) if torch.is_tensor(t) else t
                           for t in (out, again, ref))
        torch.cuda.synchronize()
        bitwise[name] = all(torch.equal(a, b) for a, b in zip(out, again))
        rtol = XENT_STAT_RTOL if name == "xent_fwd" else XENT_GRAD_RTOL
        errs[name] = [(max_err(a, r), rtol * float(r.float().abs().max()))
                      for a, r in zip(out, ref)]
        del out, again, ref

    nb = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                         for t in ts)
    lab32 = labels.to(torch.int32)
    stats = nb(lab32, lse, dl)
    work = {  # tensor-core flops (2 per multiply-add) and bytes moved
        "xent_fwd": (2 * N * E * V, nb(x, w, lab32) + 2 * nb(lse)),
        "xent_bwd_dx": (4 * N * E * V, nb(x, w) + stats + nb(x)),
        "xent_bwd_dw": (4 * N * E * V, nb(x, w) + stats + nb(w)),
    }
    route_counts = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    rows = []
    for name, (kern, plain) in runs.items():
        flops, nbytes = work[name]
        t_op = flops / PEAK_BF16_FLOPS * 1e3
        t_b = nbytes / PEAK_HBM_BYTES * 1e3
        err = max(e for e, _ in errs[name])
        tol = max(t for _, t in errs[name])
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "bitwise_repeat": bitwise[name],
            "all_errs": errs[name],
        }
        rows.append(row)
    # Context only, timed after the kernels: one torch.matmul of bf16
    # operands at each product's shape (z = x W, g W^T, x^T g); the port
    # never calls them, and no single PyTorch call computes a row's
    # function (library_ms is null).
    gb = xent._grad_plain(x, w, labels, lse, dl).bfloat16()
    matmul_ms = {"z": time_ms(torch, lambda: torch.matmul(x, w)),
                 "g_wT": time_ms(torch, lambda: torch.matmul(gb, w.t())),
                 "xT_g": time_ms(torch, lambda: torch.matmul(x.t(), gb))}
    del gb
    products = {"xent_fwd": ("z",), "xent_bwd_dx": ("z", "g_wT"),
                "xent_bwd_dw": ("z", "xT_g")}
    for row in rows:
        name = row["name"]
        if name in XENT_RECORDED_MS:
            row.update(design="wgmma", route_launches=route_counts[name],
                       earlier_ms=XENT_RECORDED_MS[name],
                       matmul_ms={p: matmul_ms[p] for p in products[name]})
    step_form = xent_step_form(torch, xent, x, w, labels, lse, dl,
                               matmul_ms, nb(x, w) + stats + nb(x, w))
    emit({"phase": "xent_kernels", "shape": dict(N=N, E=E, V=V,
                                                 dtype="bfloat16",
                                                 bwd_chunk=xent.BWD_CHUNK),
          "launches_in_phase": dict(xent.LAUNCHES),
          "route_launches_in_phase": {n: dict(c) for n, c in
                                      xent.ROUTE_LAUNCHES.items()},
          "kernels": rows, "step_form": step_form})
    for name in XENT_RECORDED_MS:
        counts = route_counts[name]
        check(counts["wgmma"] > 0 and counts["wmma"] == 0,
              f"{name} at the flagship shapes left the wgmma route: "
              f"{counts}")
    check(step_form["max_abs_err"] <= step_form["tolerance"],
          f"xent_bwd step form max_abs_err {step_form['max_abs_err']} > "
          f"{step_form['tolerance']}")
    check(step_form["bitwise_repeat"] and step_form["bitwise_rows_5_6"],
          "xent_bwd step form: two calls differ, or differ from rows 5, 6")

    # Context only: the dense two-call loss on the same inputs (a bf16
    # product, then cross_entropy), forward and backward, beside the fused
    # forward and backward (g formed once per chunk).  Neither is a
    # yardstick of one kernel; the port never calls the dense pair.
    def dense():
        xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
        per_tok = torch.nn.functional.cross_entropy(
            (xs @ ws).float(), labels, reduction="none")
        per_tok.backward(dl)

    def fused():
        _, s = xent.xent_fwd(x, w, labels)
        xent.xent_bwd(x, w, labels, s, dl)

    emit({"phase": "xent_dense_context", "dense_fwd_bwd_ms": time_ms(
        torch, dense, iters=5), "fused_fwd_bwd_ms": time_ms(torch, fused,
                                                            iters=5)})
    for row in rows:
        check(row["max_abs_err"] <= row["tolerance"],
              f"{row['name']} max_abs_err {row['max_abs_err']} > "
              f"{row['tolerance']}")
        check(row["bitwise_repeat"], f"{row['name']}: two calls differ")
    return rows


def xent_step_form(torch, xent, x, w, labels, lse, dl, matmul_ms, nbytes):
    """The backward as the step runs it: xent_bwd (g formed once per chunk,
    dx and dW from it), against the plain versions, against rows 5 and 6's
    own outputs (the same g, so the same bits) and a repeat call; timed at
    BWD_CHUNK and, as context for the chunk size, in one chunk."""
    N, E = x.shape
    V = w.shape[1]
    dx, dw = xent.xent_bwd(x, w, labels, lse, dl)
    again = xent.xent_bwd(x, w, labels, lse, dl)
    rows_5_6 = (xent.xent_bwd_dx(x, w, labels, lse, dl),
                xent.xent_bwd_dw(x, w, labels, lse, dl))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip((dx, dw), again))
    same = all(torch.equal(a, b) for a, b in zip((dx, dw), rows_5_6))
    del again, rows_5_6
    errs = []
    for got, plain in ((dx, xent.xent_bwd_dx_plain),
                       (dw, xent.xent_bwd_dw_plain)):
        ref = plain(x, w, labels, lse, dl)
        errs.append((max_err(got, ref),
                     XENT_GRAD_RTOL * float(ref.float().abs().max())))
        del ref
    del dx, dw
    flops = 6 * N * E * V
    t_op = flops / PEAK_BF16_FLOPS * 1e3
    t_b = nbytes / PEAK_HBM_BYTES * 1e3

    def run():
        xent.xent_bwd(x, w, labels, lse, dl)

    ms = time_ms(torch, run)
    chunk = xent.BWD_CHUNK
    try:
        xent.BWD_CHUNK = N
        one_chunk_ms = time_ms(torch, run)
    finally:
        xent.BWD_CHUNK = chunk
    return {"name": "xent_bwd", "what": "g once per chunk, dx and dW",
            "ms": ms, "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "flops": flops, "bytes": nbytes,
            "max_abs_err": max(e for e, _ in errs),
            "tolerance": max(t for _, t in errs), "all_errs": errs,
            "bitwise_repeat": bitwise, "bitwise_rows_5_6": same,
            "matmul_ms": sum(matmul_ms.values()),
            "bwd_chunk": chunk, "one_chunk_ms": one_chunk_ms}


def xent_f32_phase(torch, xent, dev):
    """Rows 4, 5 and 6 on float32 operands (the tf32x3 route) at the
    flagship's LM-head shapes: each kernel against its plain float32
    version on the same inputs and a repeat call, every launch on
    tf32x3; timed beside its plain version, its bound (the function's
    operations at TF32 peak; `issued_flops` is the three-product form's
    three times that) and, as context, one float32 torch.matmul (no TF32)
    of each product."""
    N, E, V = HEAD_N, LM["embed"], LM["vocab"]
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn(N, E, generator=g, device=dev)
    w = torch.randn(E, V, generator=g, device=dev) / math.sqrt(E)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    dl = torch.full((N,), 1.0 / N, device=dev)
    before = {n: dict(c) for n, c in xent.ROUTE_LAUNCHES.items()}
    _, lse = xent.xent_fwd(x, w, labels)
    runs = {
        "xent_fwd": (lambda: xent.xent_fwd(x, w, labels),
                     lambda: xent.xent_fwd_plain(x, w, labels)),
        "xent_bwd_dx": (lambda: xent.xent_bwd_dx(x, w, labels, lse, dl),
                        lambda: xent.xent_bwd_dx_plain(x, w, labels, lse,
                                                       dl)),
        "xent_bwd_dw": (lambda: xent.xent_bwd_dw(x, w, labels, lse, dl),
                        lambda: xent.xent_bwd_dw_plain(x, w, labels, lse,
                                                       dl)),
    }
    nb = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                         for t in ts)
    stats = nb(labels.to(torch.int32), lse, dl)
    # The function's products (2 flops a multiply-add) at TF32 peak, as
    # the flash rows count theirs; the three-product form issues 3x that.
    work = {"xent_fwd": (2 * N * E * V, nb(x, w) + stats),
            "xent_bwd_dx": (4 * N * E * V, nb(x, w) + stats + nb(x)),
            "xent_bwd_dw": (4 * N * E * V, nb(x, w) + stats + nb(w))}
    gf = xent._grad_plain(x, w, labels, lse, dl)
    matmul_ms = {"z": time_ms(torch, lambda: torch.matmul(x, w)),
                 "g_wT": time_ms(torch, lambda: torch.matmul(gf, w.t())),
                 "xT_g": time_ms(torch, lambda: torch.matmul(x.t(), gf))}
    del gf
    products = {"xent_fwd": ("z",), "xent_bwd_dx": ("z", "g_wT"),
                "xent_bwd_dw": ("z", "xT_g")}
    rows = []
    for name, (kern, plain) in runs.items():
        out, again = kern(), kern()
        ref = plain()
        out, again, ref = ((t,) if torch.is_tensor(t) else t
                           for t in (out, again, ref))
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        rtol = XENT_STAT_RTOL if name == "xent_fwd" else XENT_F32_GRAD_RTOL
        errs = [(max_err(a, r), rtol * float(r.float().abs().max()))
                for a, r in zip(out, ref)]
        dtypes = sorted({str(t.dtype) for t in out})
        del out, again, ref
        flops, nbytes = work[name]
        t_op = flops / PEAK_TF32_FLOPS * 1e3
        t_b = nbytes / PEAK_HBM_BYTES * 1e3
        rows.append({
            "name": f"{name}[tf32x3]", "route": "cuda",
            "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "max_abs_err": max(e for e, _ in errs),
            "tolerance": max(t for _, t in errs), "all_errs": errs,
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "library_ms": None, "flops": flops, "issued_flops": 3 * flops,
            "bytes": nbytes,
            "bitwise_repeat": bitwise, "out_dtypes": dtypes,
            "matmul_ms": {p: matmul_ms[p] for p in products[name]}})
    counts = {n: {r: c[r] - before[n][r] for r in c}
              for n, c in xent.ROUTE_LAUNCHES.items()}
    emit({"phase": "xent_f32", "shape": dict(N=N, E=E, V=V, dtype="float32",
                                             bwd_chunk=xent.BWD_CHUNK),
          "route_launches_in_phase": counts, "kernels": rows})
    for name, c in counts.items():
        check(c["tf32x3"] > 0 and c["tf32x3"] == sum(c.values()),
              f"{name} on float32 operands off the tf32x3 route: {c}")
    for row in rows:
        check(row["max_abs_err"] <= row["tolerance"],
              f"{row['name']} max_abs_err {row['max_abs_err']} > "
              f"{row['tolerance']}")
        check(row["bitwise_repeat"], f"{row['name']}: two calls differ")
        check(row["out_dtypes"] == ["torch.float32"],
              f"{row['name']}: outputs {row['out_dtypes']}")
    return rows


def lm_loss(torch, model, tok):
    """Stage B's dense loss: logits = x @ head, softmax cross-entropy of
    each next token, mean."""
    logits = model(tok)
    V = logits.shape[-1]
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, V).float(), tok[:, 1:].reshape(-1))


def fused_lm_loss(torch, mpi, model, tok, dtype=None):
    """The fused loss of stage B' (bench.py :1706-1720): the final LayerNorm's
    output and the head, both in ``dtype`` (bf16 by default; float32 takes
    the tf32x3 route), through the fused linear + cross-entropy kernels,
    mean over the next tokens."""
    dtype = dtype or torch.bfloat16
    h, head = model(tok, return_prehead=True)
    E = h.shape[-1]
    return mpi.ops.fused_linear_cross_entropy(
        h[:, :-1].reshape(-1, E).to(dtype), head.to(dtype),
        tok[:, 1:].reshape(-1)).mean()


LOSSES = {
    "dense": lambda torch, mpi, m, t, dtype: lm_loss(torch, m, t),
    "fused": fused_lm_loss,
}


def train_phase(torch, mpi, ops, dev, loss: str, dtype=None):
    """Three timed DP steps of the flagship with the ``loss`` of LOSSES at
    compute ``dtype`` (bf16 by default); every kernel counter is set to 0
    just before and read just after.  With the fused loss every launch of
    the head must take the route of ``dtype``: wgmma for bf16, tf32x3 for
    float32."""
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash", dtype=dtype,
                                     device=dev, generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    loss_fn = LOSSES[loss]
    step = mpi.nn.data_parallel_step(
        model, opt, lambda m, t: loss_fn(torch, mpi, m, t, dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.reset_launches()
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss_v = step(tok)
        losses.append(float(loss_v))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: c for mod in ops.values() for n, c in mod.LAUNCHES.items()}
    routes = {n: dict(c) for n, c in ops["xent"].ROUTE_LAUNCHES.items()}
    med = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated()
    # One more, untimed step: how often a step makes the host wait for the
    # card (each wait drains the queue of work the host had run ahead on).
    syncs = count_host_syncs(torch, lambda: step(tok))
    emit({"phase": "train", "loss": loss,
          "config": dict(LM, batch=BATCH, seq=SEQ, lr=LR,
                         dtype=str(dtype).split(".")[-1]),
          "params": n_params, "losses": losses, "step_ms": step_ms,
          "median_step_ms": med,
          "tokens_per_s": BATCH * SEQ / (med / 1e3),
          "peak_mem_bytes": peak, "host_syncs_per_step": syncs,
          "launches": launches, "xent_route_launches": routes,
          "world_size": mpi.size(),
          "backend": mpi.runtime.backend_name()})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    path = [n for n in launches if loss == "fused" or n.startswith("flash")]
    for name in path:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"{loss} train path")
    if loss == "fused":
        route = "tf32x3" if dtype == torch.float32 else "wgmma"
        for name, counts in routes.items():
            check(counts == {r: launches[name] * (r == route)
                             for r in ops["xent"].ROUTES},
                  f"{name}: stage B' head launches off the {route} route: "
                  f"{counts} of {launches[name]}")
    return model, tok, launches, routes


def _loss_and_grads(model, fn):
    model.zero_grad(set_to_none=True)
    loss = fn()
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad for n, p in model.named_parameters()})


def _compare(name, a, b):
    """Emit and check the loss and per-tensor gradient differences of two
    (loss, grads) results; ``b`` is the reference."""
    (la, ga), (lb, gb) = a, b
    loss_rel = abs(la - lb) / abs(lb)
    grad_rel = {n: float((ga[n].float() - gb[n].float()).norm()
                         / gb[n].float().norm().clamp_min(1e-30))
                for n in gb}
    worst = max(grad_rel, key=grad_rel.get)
    emit({"phase": "consistency", "compare": name, "loss_a": la,
          "loss_b": lb, "loss_rel_diff": loss_rel,
          "grad_max_rel_norm_diff": grad_rel[worst], "worst_grad": worst,
          "head_grad_rel_norm_diff": grad_rel.get("head"),
          "tolerance": CONSISTENCY_RTOL})
    check(loss_rel <= CONSISTENCY_RTOL, f"{name}: loss differs by {loss_rel}")
    check(grad_rel[worst] <= CONSISTENCY_RTOL,
          f"{name}: gradient {worst} differs by {grad_rel[worst]}")


def consistency_phase(torch, mpi, model, tok, dev):
    """Same weights and batch through attn_impl "flash" vs "local" (dense
    loss), and through the fused vs the dense loss (flash attention)."""
    local = mpi.models.TransformerLM(**LM, attn_impl="local",
                                     dtype=torch.bfloat16, device=dev)
    local.load_state_dict(model.state_dict())
    dense = _loss_and_grads(model, lambda: lm_loss(torch, model, tok))
    _compare("flash vs local attention (dense loss)", dense,
             _loss_and_grads(local, lambda: lm_loss(torch, local, tok)))
    del local
    fused = _loss_and_grads(model,
                            lambda: fused_lm_loss(torch, mpi, model, tok))
    _compare("fused (bf16 head) vs dense (f32 head) loss", fused, dense)


def ring_kernel_phase(torch, mpi, ring, dev):
    """Rows 7, 8, 11 and 12: RING_N ranks rank-major on the card at the
    flagship's gradient bucket, float32, each with the config that maps the
    bucket onto it; each kernel against its plain version and its own torch
    fold, bitwise, and bitwise on a repeat call; then a bfloat16 and an
    int32 pass at a small size.  The buffers' rows sit 16 bytes apart, as
    the fused rank-major sync lays a bucket out (fusion.gather_bucket); the
    rows are also run on contiguous rows, which their kernel reads element
    by element.  Then row 12 where its halves' ring chunks differ, and row
    11 at a small size under the default config."""
    n, L = RING_N, RING_BUCKET

    def rows16(t):
        """[n, m] on rows padded to 16 bytes (a view)."""
        v = 16 // t.element_size()
        out = t.new_empty(n, -(-t.shape[1] // v) * v)[:, :t.shape[1]]
        return out.copy_(t)

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = rows16(torch.randn(n, L, generator=g, device=dev))
    small = {dt: rows16(torch.randn(n, RING_SMALL, generator=g,
                                    device=dev).to(dt)
                        if dt.is_floating_point else
                        torch.randint(-2 ** 30, 2 ** 30, (n, RING_SMALL),
                                      generator=g, device=dev, dtype=dt))
             for dt in (torch.bfloat16, torch.int32)}
    rows = []
    for name, (cb, bidir) in RING_CONFIGS.items():
        picked, plan = ring.schedule(L, n, x.dtype, chunk_bytes=cb,
                                     bidirectional=bidir)
        check(picked == name, f"{name}: the config maps the bucket to "
              f"{picked}")
        kern = lambda: ring.WRAPPERS[name](x, *plan)  # noqa: E731
        plain = lambda: ring.PLAINS[name](x, *plan)  # noqa: E731
        vec0 = dict(ring.VECTOR_LAUNCHES)
        out, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        bitwise = torch.equal(out, ref) and torch.equal(out, again)
        err = max_err(out, ref)
        # The direct kernel: its own torch fold, its 16-byte path, and
        # contiguous rows (the element path) beside it.
        vec = ring.VECTOR_LAUNCHES[name] - vec0[name]
        xc = x.contiguous()
        elem = ring.WRAPPERS[name](xc, *plan)
        torch.cuda.synchronize()
        extra = {
            "design": "direct", "vector_launches": vec,
            "launches_checked": 2,
            "fold_bitwise": torch.equal(out, ring.FOLDS[name](x, *plan)),
            "element_path_bitwise": torch.equal(elem, ref) and (
                ring.VECTOR_LAUNCHES[name] - vec0[name] == vec),
            "element_path_ms": time_ms(torch, lambda: ring.WRAPPERS[
                name](xc, *plan)),
            "earlier_ms": RING_RECORDED_MS[name]}
        del xc, elem, out, again, ref
        passes = {}
        for dt, xs in small.items():
            # chunk_bytes scaled with the size and the element, so that
            # the small pass runs the same row.
            scb = cb * RING_SMALL // L * xs.element_size() // 4
            spicked, splan = ring.schedule(RING_SMALL, n, dt,
                                           chunk_bytes=scb,
                                           bidirectional=bidir)
            check(spicked == name, f"{name} {dt}: small pass maps to "
                  f"{spicked}")
            a, b = ring.WRAPPERS[name](xs, *splan), ring.PLAINS[name](xs, *splan)
            torch.cuda.synchronize()
            passes[str(dt).split(".")[-1]] = torch.equal(a, b)
        # Bound.  The function reads every rank's buffer once and writes
        # every rank's result once: 2 n L 4 bytes, which is what a direct
        # row moves (the ring schedule on one card moved 4.4 times that).
        fn_bytes = 2 * n * L * 4
        ms = time_ms(torch, kern)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "max_abs_err": err,
            "tolerance": 0.0, "bitwise": bitwise,
            "small_passes_bitwise": passes,
            "chunk_bytes": cb, "bidirectional": bidir,
            "chunk_elems": ring._chunk_lengths(name, n, L, plan),
            "ms": ms, "plain_ms": time_ms(torch, plain),
            "bound_ms": fn_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
            "bytes": fn_bytes, "achieved_tb_s": fn_bytes / ms / 1e9,
            "schedule_bytes": fn_bytes,
            # The stock rank-major route computes the same function: the
            # rank-axis sum, copied to every rank.
            "library_ms": time_ms(torch, lambda: x.sum(0).expand_as(x).clone()),
            "library_call": "x.sum(0) copied to every rank",
            **extra,
        })
    del x
    # Row 12 where its halves pad to ring chunks of different lengths, and
    # row 11 at a small size on the default config's route.
    unequal = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        xs = rows16(small[dt][:, :RING_UNEQUAL_HALVES]
                    if dt in small else torch.randn(
                        n, RING_UNEQUAL_HALVES, generator=g, device=dev))
        name = "ring_allreduce_bidir"
        a, b = ring.WRAPPERS[name](xs), ring.WRAPPERS[name](xs)
        torch.cuda.synchronize()
        unequal[str(dt).split(".")[-1]] = (
            torch.equal(a, ring.PLAINS[name](xs)) and torch.equal(a, b)
            and torch.equal(a, ring.FOLDS[name](xs)))
    ce = ring._chunk_lengths("ring_allreduce_bidir", n, RING_UNEQUAL_HALVES)
    emit({"phase": "ring_unequal_halves", "name": "ring_allreduce_bidir",
          "ranks": n, "elems_per_rank": RING_UNEQUAL_HALVES,
          "chunk_elems": ce, "bitwise_vs_plain_fold_repeat": unequal})
    check(ce[0] != ce[1], f"row 12's halves at {RING_UNEQUAL_HALVES}: {ce}")
    check(all(unequal.values()), f"row 12 with unequal halves: {unequal}")
    default_small = ring_default_small(torch, mpi, ring, dev, rows16)
    emit({"phase": "ring_kernels", "ranks": n, "elems_per_rank": L,
          "dtype": "float32", "small_elems_per_rank": RING_SMALL,
          "launches_in_phase": dict(ring.LAUNCHES), "kernels": rows})
    for row in rows:
        check(row["bitwise"], f"{row['name']}: kernel != plain or repeat")
        for dt, ok in row["small_passes_bitwise"].items():
            check(ok, f"{row['name']} {dt}: kernel != plain")
        check_direct(row)
    check(default_small["bitwise"], "row 11 on the default config != plain")
    return rows


def ring_default_small(torch, mpi, ring, dev, rows16):
    """Row 11 where the default config runs it: RING_SMALL float32 elements
    a rank (rows 16 bytes apart) under the default chunk_bytes, whose ring
    chunk fits one slot; its time beside the stock route's, on a line of
    its own, each also as device time alone (torch.profiler), since at
    this size the host's launch path can take longer than the device."""
    n = RING_N
    cb = mpi.runtime.effective_config().chunk_bytes
    name, plan = ring.schedule(RING_SMALL, n, torch.float32, chunk_bytes=cb,
                               bidirectional=False)
    check(name == "ring_allreduce" and not plan,
          f"{RING_SMALL} f32 a rank under chunk_bytes {cb} maps to {name}")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = rows16(torch.randn(n, RING_SMALL, generator=g, device=dev))
    vec0 = ring.VECTOR_LAUNCHES[name]
    out = ring.WRAPPERS[name](x)
    fn_bytes = 2 * n * RING_SMALL * 4
    kern = lambda: ring.WRAPPERS[name](x)  # noqa: E731
    library = lambda: x.sum(0).expand_as(x).clone()  # noqa: E731
    line = {"phase": "ring_default_small", "name": name, "ranks": n,
            "elems_per_rank": RING_SMALL, "chunk_bytes": cb,
            "chunk_elems": ring._chunk_lengths(name, n, RING_SMALL),
            "bitwise": torch.equal(out, ring.PLAINS[name](x)),
            "vector": ring.VECTOR_LAUNCHES[name] - vec0 == 1,
            "ms": time_ms(torch, kern),
            "device_ms": device_breakdown(torch, kern)["total_ms"],
            "library_ms": time_ms(torch, library),
            "library_device_ms": device_breakdown(torch, library)["total_ms"],
            "library_call": "x.sum(0) copied to every rank",
            "bound_ms": fn_bytes / PEAK_HBM_BYTES * 1e3}
    emit(line)
    check(line["vector"], "row 11 on the default config off the 16-byte path")
    return line


def check_direct(row) -> None:
    """A direct row's extra checks: its fold, its element path, and every
    launch on the main path's aligned rows on the 16-byte path."""
    check(row["fold_bitwise"], f"{row['name']}: kernel != its torch fold")
    check(row.get("element_path_bitwise", True),
          f"{row['name']}: element path != plain ring")
    check(row["vector_launches"] == row["launches_checked"],
          f"{row['name']}: {row['vector_launches']} of "
          f"{row['launches_checked']} launches on the 16-byte path")


def ring_rs_ag_kernel_phase(torch, ring, dev):
    """Rows 9, 10, 13 and 14: RING_N ranks rank-major on the card at the
    flagship's ZeRO shapes, float32: the reduce-scatter of every rank's
    486,731,776 gradients and the all-gather of the 121,682,944-element
    shards, each row under the chunk_bytes that maps it; each kernel
    against its plain version and a repeat call, bitwise; then a bfloat16
    and an int32 pass at a small size."""
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    small = {dt: (torch.randn(n, ZERO_SMALL, generator=g, device=dev).to(dt)
                  if dt.is_floating_point else
                  torch.randint(-2 ** 30, 2 ** 30, (n, ZERO_SMALL),
                                generator=g, device=dev, dtype=dt))
             for dt in (torch.bfloat16, torch.int32)}

    def plan_of(name, L, dtype, cb):
        if name.startswith("ring_reduce_scatter"):
            return ring.schedule_reduce_scatter(L, n, dtype, chunk_bytes=cb)
        return ring.schedule_all_gather(L, n, dtype, chunk_bytes=cb)

    rows = []
    for mode, cb in ZERO_CONFIGS.items():
        for name in ZERO_ROWS[mode]:
            rs = name.startswith("ring_reduce_scatter")
            L = FLAGSHIP_GRADS if rs else ZERO_SHARD
            x = torch.randn(n, L, generator=g, device=dev)
            picked, plan = plan_of(name, L, x.dtype, cb)
            check(picked == name, f"{name}: chunk_bytes {cb} maps to "
                  f"{picked}")
            kern = lambda: ring.WRAPPERS[name](x, *plan)  # noqa: E731
            plain = lambda: ring.PLAINS[name](x, *plan)  # noqa: E731
            vec0 = ring.VECTOR_LAUNCHES[name]
            out, again = kern(), kern()
            torch.cuda.synchronize()
            repeat = torch.equal(out, again)
            del again
            ref = plain()
            bitwise = torch.equal(out, ref) and repeat
            err = max_err(out, ref)
            del ref
            # The direct kernel: its own torch fold (copy for the
            # all-gather) and its 16-byte path (the flats and shards are
            # aligned as allocated).
            fold = (ring.reduce_scatter_direct_plain if rs
                    else ring.all_gather_direct_plain)
            extra = {
                "design": "direct",
                "vector_launches": ring.VECTOR_LAUNCHES[name] - vec0,
                "launches_checked": 2,
                "fold_bitwise": torch.equal(out, fold(x)),
                "earlier_ms": RING_RECORDED_MS[name]}
            rows_equal = rs or all(torch.equal(out[r], out[0])
                                   for r in range(1, n))
            del out
            passes = {}
            for dt, xs in small.items():
                # A small pass runs the same row: chunk_bytes scaled with
                # the size and the element; the all-gather takes shards.
                m = ZERO_SMALL if rs else ZERO_SMALL // n
                scb = cb * m // L * xs.element_size() // 4
                xs = xs if rs else xs[:, :m].contiguous()
                spicked, splan = plan_of(name, m, dt, scb)
                check(spicked == name, f"{name} {dt}: small pass maps to "
                      f"{spicked}")
                a, b = ring.WRAPPERS[name](xs, *splan), ring.PLAINS[name](
                    xs, *splan)
                torch.cuda.synchronize()
                passes[str(dt).split(".")[-1]] = torch.equal(a, b)
            # Bounds.  The function reads every rank's input once and
            # writes every rank's output once: reduce-scatter n L in, n L/n
            # out; all-gather n L in, n n L out (4-byte elements).  A
            # direct row moves just these bytes (schedule_bytes).
            if rs:
                fn_bytes = 4 * (n * L + L)
                library = lambda: x.view(n, n, -1).sum(0)  # noqa: E731
                library_call = "x.view(n, n, -1).sum(0)"
            else:
                fn_bytes = 4 * (n * L + n * n * L)
                library = lambda: x.unsqueeze(0).expand(  # noqa: E731
                    n, n, L).clone()
                library_call = "shards expanded to every rank, copied"
            ms = time_ms(torch, kern)
            rows.append({
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "max_abs_err": err,
                "tolerance": 0.0, "bitwise": bitwise,
                "all_gather_rows_equal": rows_equal,
                "small_passes_bitwise": passes, "chunk_bytes": cb,
                "elems_per_rank": L,
                "plan": dict(zip(("sub_elems", "C"), ring._slots(
                    L // n if rs else L, plan))),
                "ms": ms, "plain_ms": time_ms(torch, plain),
                "bound_ms": fn_bytes / PEAK_HBM_BYTES * 1e3,
                "bound_by": "bytes", "bytes": fn_bytes,
                "achieved_tb_s": fn_bytes / ms / 1e9,
                "schedule_bytes": fn_bytes,
                # The stock rank-major route: the rank-axis sum of the
                # [rank, tile] view / a copy of the stack per rank.
                "library_ms": time_ms(torch, library),
                "library_call": library_call,
                **extra,
            })
            del x
            torch.cuda.empty_cache()
    emit({"phase": "ring_rs_ag_kernels", "ranks": n, "dtype": "float32",
          "small_elems_per_rank": ZERO_SMALL,
          "launches_in_phase": {k: ring.LAUNCHES[k] for k in
                                ZERO_ROWS["chunked"] + ZERO_ROWS["resident"]},
          "kernels": rows})
    for row in rows:
        check(row["bitwise"], f"{row['name']}: kernel != plain or repeat")
        check(row["all_gather_rows_equal"], f"{row['name']}: ranks differ")
        for dt, ok in row["small_passes_bitwise"].items():
            check(ok, f"{row['name']} {dt}: kernel != plain")
        check_direct(row)
    return rows


def plain_rank_major_sync(torch, mpi, ring, stacks, spec):
    """The fused rank-major allreduce of ``stacks`` through the plain ring
    (each bucket gathered, reduced by ``ring_allreduce_plain`` under the
    active config, scattered back): what the kernels must give bitwise."""
    fusion = mpi.fusion
    for g in spec.groups:
        for lo, hi in g.bounds:
            buf = fusion.gather_bucket(stacks, g, lo, hi, rank_major=True)
            fusion.scatter_bucket(ring.ring_allreduce_plain(buf, op="mean"),
                                  stacks, g, lo, rank_major=True)


def ring_dp_phase(torch, mpi, ops, dev):
    """This slice's main path: the flagship as a DP step of RING_N ranks on
    one card.  Rank r takes sequence r of the batch of 4 (the ranks run one
    after another on the same weights), the gradients are stacked
    rank-major, synced by the fused rank-major allreduce under backend
    "pallas" (mean), and SGD steps.  3 steps under the default config (row
    8), then one under each other row's config; each sync is held bitwise
    to the plain ring on the same stacks, the first against the batch-4
    gradients of the same weights; then one untimed step counts the host
    syncs.  Every kernel counter is set to 0 just before and read just
    after."""
    ring = ops["ring"]
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=LR)
    spec = mpi.fusion.FusedSpec(params)
    first = spec.groups[0].bounds[0]
    check(spec.n_launches == RING_BUCKETS and first[1] - first[0]
          == RING_BUCKET, f"flagship buckets {spec.n_launches}, first "
          f"{first}")
    stacks = [torch.empty((n, *p.shape), device=dev) for p in params]

    def rank_grads():
        losses = []
        for r in range(n):
            model.zero_grad(set_to_none=True)
            loss = fused_lm_loss(torch, mpi, model, tok[r:r + 1])
            loss.backward()
            losses.append(loss.detach())
            for st, p in zip(stacks, params):
                st[r].copy_(p.grad)
        model.zero_grad(set_to_none=True)
        return torch.stack(losses).mean()

    def sync():
        mpi.fusion.fused_allreduce_rank_major_(stacks, spec=spec,
                                               backend="pallas", op="mean")

    def sgd():
        for st, p in zip(stacks, params):
            p.grad = st[0]
        opt.step()
        model.zero_grad(set_to_none=True)

    torch.cuda.synchronize()
    # The batch-4 gradients of the first step's weights (DP equality).
    ref_loss = fused_lm_loss(torch, mpi, model, tok)
    ref_loss.backward()
    ref = [p.grad.clone() for p in params]
    model.zero_grad(set_to_none=True)

    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.reset_launches()
    schedule = ["ring_allreduce_chunked"] * 3 + [
        "ring_allreduce_bidir_chunked", "ring_allreduce",
        "ring_allreduce_bidir"]
    losses, sync_ms, bitwise, dp_rel = [], {}, {}, None
    for step, name in enumerate(schedule):
        cb, bidir = RING_CONFIGS[name]
        mpi.set_config(chunk_bytes=cb, pallas_bidirectional=bidir)
        losses.append(rank_grads())
        before = [st.clone() for st in stacks]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sync()
        end.record()
        plain_rank_major_sync(torch, mpi, ring, before, spec)
        end.synchronize()
        sync_ms.setdefault(name, []).append(start.elapsed_time(end))
        bitwise.setdefault(name, []).append(
            all(torch.equal(a, b) for a, b in zip(stacks, before)))
        del before
        if step == 0:
            rel = [float((st[0] - r).norm() / r.norm().clamp_min(1e-30))
                   for st, r in zip(stacks, ref)]
            worst = max(range(len(rel)), key=rel.__getitem__)
            dp_rel = (rel[worst], [nm for nm, _ in
                                   model.named_parameters()][worst])
            del ref
        sgd()
    mpi.set_config(chunk_bytes=RING_CONFIGS["ring_allreduce_chunked"][0],
                   pallas_bidirectional=False)
    launches = {nm: c for mod in ops.values() for nm, c in
                mod.LAUNCHES.items()}
    row8 = "ring_allreduce_chunked"
    direct_vector = {nm: {"all": launches[nm],
                          "vector": ring.VECTOR_LAUNCHES[nm]}
                     for nm in RING_CONFIGS}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]

    def one_step():
        rank_grads()
        sync()
        sgd()

    # Where one sync's device time goes, by kernel (after the main path);
    # then the whole step (4 ranks' forward and backward, the sync, SGD)
    # on the host's clock, 3 more steps under the default config.
    breakdown = device_breakdown(torch, sync)
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # The step's own peak, without the verification copy of the stacks.
    torch.cuda.reset_peak_memory_stats()
    syncs = count_host_syncs(torch, one_step)
    step_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "ring_dp", "ranks": n, "config": dict(
        LM, batch=BATCH, seq=SEQ, lr=LR, dtype="bfloat16"),
        "params": sum(p.numel() for p in params),
        "buckets": spec.n_launches, "rows": schedule, "losses": losses,
        "batch4_loss_step0": float(ref_loss.detach()),
        "sync_ms": sync_ms,
        "median_sync_ms": {k: statistics.median(v)
                           for k, v in sync_ms.items()},
        "ring_recorded_median_sync_ms": {row8: RING_RECORDED_DP_SYNC_MS},
        "sync_device_breakdown": breakdown, "step_ms": step_ms,
        "median_step_ms": statistics.median(step_ms),
        "launches_on_16_byte_path": direct_vector,
        "bitwise_vs_plain": bitwise,
        "dp_max_rel_l2_vs_batch4": dp_rel[0], "dp_worst_tensor": dp_rel[1],
        "dp_tolerance": DP_RTOL, "peak_mem_bytes_with_check": peak,
        "peak_mem_bytes_step": step_peak,
        "stack_bytes": sum(st.numel() * 4 for st in stacks),
        "host_syncs_per_step": syncs, "launches": launches})
    check(all(all(v) for v in bitwise.values()),
          f"a kernel sync differs from the plain ring: {bitwise}")
    check(dp_rel[0] <= DP_RTOL, f"synced mean vs batch-4 gradients "
          f"{dp_rel[0]} ({dp_rel[1]})")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    for name in RING_CONFIGS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"ring DP path")
    for nm, c in direct_vector.items():
        check(c["vector"] == c["all"], f"{nm}: {c['vector']} of "
              f"{c['all']} launches on the 16-byte path")
    return launches, {k: statistics.median(v) for k, v in sync_ms.items()}


def tap_rank_major_routes(torch, mpi, ring, log,
                          ops=("reduce_scatter_rank_major",
                               "allgather_rank_major")):
    """Wrap the selector's "pallas" routes of the rank-major ``ops``
    (reduce-scatter and all-gather for the checked steps of the ZeRO path;
    the allreduce too on the ResNet-50 path): each call runs the route (the
    kernels) between two CUDA events, then the plain ring on the same
    input, and appends to ``log`` whether the two agree bitwise (and, for
    the all-gather, whether every rank's slice is the same), the rows the
    route launched, its elements a rank, and the peak device memory while
    the route ran (the peak so far is kept in ``log.peak``).  Returns the
    function that restores the plain routes."""
    sel = mpi.selector

    def wrap(verb, route, plain):
        def tapped(xs, **kw):
            log.peak = max(log.peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = dict(ring.LAUNCHES)
            start.record()
            out = route(xs, **kw)
            end.record()
            entry = {"verb": verb, "events": (start, end),
                     "label": log.label, "elems": xs[0].numel(),
                     "rows": [k for k, v in ring.LAUNCHES.items()
                              if v != before[k]],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "bitwise": torch.equal(out, plain(xs, **kw))}
            if verb == "all_gather":
                entry["rows_equal"] = all(torch.equal(out[r], out[0])
                                          for r in range(1, out.shape[0]))
            log.append(entry)
            return out
        return tapped

    routes = {"reduce_scatter_rank_major": (
        "reduce_scatter", ring.ring_reduce_scatter,
        ring.ring_reduce_scatter_plain),
        "allgather_rank_major": ("all_gather", ring.ring_all_gather,
                                 ring.ring_all_gather_plain),
        "allreduce_rank_major": ("allreduce", ring.ring_allreduce,
                                 ring.ring_allreduce_plain)}
    routes = {op: routes[op] for op in ops}
    for op, (verb, route, plain) in routes.items():
        sel.register(op, "pallas", wrap(verb, route, plain))

    def restore():
        for op, (_, route, _) in routes.items():
            sel.register(op, "pallas", route)
    return restore


class TapLog(list):
    label = ""
    peak = 0


def zero_dp_phase(torch, mpi, ops, dev, ring_sync_ms):
    """This slice's main path: the flagship as ZeRO data parallelism of
    RING_N ranks on one card.  Rank r takes sequence r of the batch of 4;
    its gradients go into its row of one [4, 486,731,776] float32 stack
    (fusion.rank_major_buffers), and zero.update_rank_major (ZeRO-1) or
    zero.gather_params_rank_major + update3_rank_major (ZeRO-3) step with
    Adam (lr 1e-3) under backend "pallas": 3 ZeRO-1 steps under the default
    config (rows 9 + 10), 1 under the resident config (rows 13 + 14), then
    2 ZeRO-3 steps.  Every reduce-scatter and all-gather is held bitwise to
    the plain ring on the same input; the first ZeRO-1 step to a
    replicated step from the same parameters, state and stack (fused ring
    allreduce mean, Adam on the full tensors; the later steps' gaps are
    reported); each ZeRO-3 update to a ZeRO-1 update on the same stack;
    then one untimed ZeRO-1 step counts the host syncs.  Every kernel
    counter is set to 0 just before the main path and read just after;
    the checks' own launches are taken out."""
    ring = ops["ring"]
    zero, fusion = mpi.parallel.zero, mpi.fusion
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    spec = zero.flat_spec(params, n_shards=n)
    check(len(spec.groups) == 1 and spec.padded == FLAGSHIP_GRADS
          and spec.shard == ZERO_SHARD,
          f"flagship shard layout {spec.padded} / {spec.shard}")
    flats, views = fusion.rank_major_buffers(spec, n, device=dev)
    tx = mpi.optim.adam(ZERO_LR)
    state = zero.init_rank_major(params, tx, n)

    def rank_grads():
        losses = []
        for r in range(n):
            model.zero_grad(set_to_none=True)
            loss = fused_lm_loss(torch, mpi, model, tok[r:r + 1])
            loss.backward()
            losses.append(loss.detach())
            for v, p in zip(views, params):
                v[r].copy_(p.grad)
        model.zero_grad(set_to_none=True)
        return torch.stack(losses).mean()

    def load(new):
        with torch.no_grad():
            for p, v in zip(params, new):
                p.copy_(v)

    def zero1(state):
        new, state = zero.update_rank_major(params, flats, state, tx,
                                            backend="pallas")
        load(new)
        return state

    rows = ZERO_ROWS["chunked"] + ZERO_ROWS["resident"]

    def counts():
        return {k: ring.LAUNCHES[k] for k in rows}

    @torch.no_grad()
    def replicated_rel(p0, prev):
        """Per-tensor rel. L2 of the ZeRO-1 update against a replicated
        step from the same parameters, optimizer state and gradient stack:
        the mean by the fused ring allreduce, Adam on the full tensors.  One
        unpadded dtype group: the [n, shard] state read flat is the
        replicated state."""
        p1 = fusion.flatten_tree(params, spec)
        buf = flats[0].clone()
        fusion.fused_allreduce_rank_major_([buf], backend="pallas",
                                           op="mean")
        upd, _ = tx.update(buf[0], type(prev)(*(
            t.reshape(-1) if torch.is_tensor(t) else t for t in prev)))
        del buf
        d_zero = fusion.unflatten_tree(p1 - p0, spec)
        d_rep = fusion.unflatten_tree(upd, spec)
        rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
               for a, b in zip(d_zero, d_rep)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        return rel[worst], [nm for nm, _ in model.named_parameters()][worst]

    log = TapLog()
    restore = tap_rank_major_routes(torch, mpi, ring, log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.reset_launches()
    excluded = dict.fromkeys(rows, 0)
    schedule = ["zero1 chunked"] * 3 + ["zero1 resident"] + ["zero3 chunked"] * 2
    losses, step_ms, rep, z3_eq_z1 = [], {}, [], []
    try:
        shards = None
        for i, label in enumerate(schedule):
            stage, mode = label.split()
            mpi.set_config(chunk_bytes=ZERO_CONFIGS[mode])
            log.label = label
            t0 = time.perf_counter()
            if stage == "zero1":
                losses.append(rank_grads())
                p0 = fusion.flatten_tree(params, spec).detach()
                prev, state = state, zero1(state)
            else:
                if shards is None:
                    shards = zero.shard_params_rank_major(params, n)
                load(zero.gather_params_rank_major(shards, spec,
                                                   backend="pallas"))
                losses.append(rank_grads())
                new_shards, new_state = zero.update3_rank_major(
                    shards, flats, state, tx, spec=spec, backend="pallas")
            torch.cuda.synchronize()
            step_ms.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
            before = counts()
            log.label = "check"
            if stage == "zero1":
                rep.append(replicated_rel(p0, prev))
                del p0, prev
            if stage == "zero3":
                # ZeRO-1 from the same parameters, state and stack.
                z1_new, z1_state = zero.update_rank_major(
                    params, flats, state, tx, backend="pallas")
                z3_eq_z1.append(
                    torch.equal(fusion.local_shards(z1_new, spec),
                                new_shards)
                    and torch.equal(z1_state.mu, new_state.mu)
                    and torch.equal(z1_state.nu, new_state.nu))
                del z1_new, z1_state
                shards, state = new_shards, new_state
                del new_shards, new_state
            for k, v in counts().items():
                excluded[k] += v - before[k]
        log.label = "zero3 final gather"
        load(zero.gather_params_rank_major(shards, spec, backend="pallas"))
    finally:
        restore()
        mpi.set_config(chunk_bytes=ZERO_CONFIGS["chunked"])
    launches = {k: v - excluded[k] for k, v in counts().items()}
    # Every launch of the four rows in the phase, the checks' included, and
    # those on the 16-byte path.
    vector = {nm: {"all": ring.LAUNCHES[nm],
                   "vector": ring.VECTOR_LAUNCHES[nm]} for nm in rows}
    peak = max(log.peak, torch.cuda.max_memory_allocated())
    losses = [float(v) for v in losses]
    main = [e for e in log if e["label"] != "check"]
    leg_ms, leg_peak = {}, {}
    for e in main:
        leg_ms.setdefault(e["label"], {}).setdefault(e["verb"], []).append(
            e["events"][0].elapsed_time(e["events"][1]))
        d = leg_peak.setdefault(e["label"], {})
        d[e["verb"]] = max(d.get(e["verb"], 0), e["peak_bytes"])

    def one_step():
        nonlocal state
        rank_grads()
        state = zero1(state)

    # One step without the verification taps, timed on the host clock, and
    # its own peak; then one more, untimed, counts the host syncs.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3
    step_peak = torch.cuda.max_memory_allocated()
    syncs = count_host_syncs(torch, one_step)

    def update():
        nonlocal state
        state = zero1(state)

    # Where one ZeRO-1 update's device time goes (the legs, Adam, copies).
    breakdown = device_breakdown(torch, update)
    state_bytes = sum(t.numel() * t.element_size() for t in state
                      if torch.is_tensor(t)) // n
    emit({"phase": "zero_dp", "ranks": n, "optimizer": f"adam({ZERO_LR})",
          "config": dict(LM, batch=BATCH, seq=SEQ, dtype="bfloat16"),
          "params": sum(p.numel() for p in params), "shard": spec.shard,
          "steps": schedule, "losses": losses,
          "step_ms_with_check": step_ms, "zero1_step_ms": plain_step_ms,
          "leg_ms": leg_ms,
          "median_leg_ms": {lb: {v: statistics.median(t)
                                 for v, t in d.items()}
                            for lb, d in leg_ms.items()},
          "leg_peak_mem_bytes": leg_peak,
          "update_device_breakdown": breakdown,
          "ring_dp_median_sync_ms": ring_sync_ms,
          "bitwise_vs_plain": all(e["bitwise"] for e in log),
          "n_collectives_checked": len(log),
          "all_gather_rows_equal": all(e.get("rows_equal", True)
                                       for e in log),
          "zero3_equals_zero1": z3_eq_z1,
          "replicated_max_rel_l2": [r[0] for r in rep],
          "replicated_worst_tensor": [r[1] for r in rep],
          "replicated_tolerance": ZERO_RTOL,
          "opt_state_bytes_per_rank": state_bytes,
          "opt_state_bytes_replicated": 2 * spec.padded * 4,
          "zero3_param_shard_bytes": spec.shard * 4,
          "grad_stack_bytes": sum(f.numel() * f.element_size()
                                  for f in flats),
          "peak_mem_bytes_with_check": peak,
          "peak_mem_bytes_step": step_peak,
          "ring_recorded_peak_mem_gb_step": RING_RECORDED_ZERO_PEAK_GB,
          "host_syncs_per_step": syncs, "launches": launches,
          "check_launches": excluded,
          "launches_on_16_byte_path": vector})
    check(all(e["bitwise"] for e in log)
          and len(main) == 2 * len(schedule) + 1,
          "a ZeRO reduce-scatter or all-gather differs from the plain ring")
    check(all(e.get("rows_equal", True) for e in log),
          "the all-gathered ranks differ")
    check(len(z3_eq_z1) == 2 and all(z3_eq_z1),
          "a ZeRO-3 update differs from the ZeRO-1 update")
    # Held on the first step; later steps are reported: Adam's moments
    # carry the sums' rounding forward, so the gap grows with the count.
    check(rep[0][0] <= ZERO_RTOL, f"ZeRO-1 vs replicated Adam: {rep}")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    for name in rows:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"ZeRO path")
    for name, c in vector.items():
        check(c["all"] == c["vector"], f"{name}: {c['vector']} of "
              f"{c['all']} launches on the 16-byte path")
    return launches


def step_profile(torch, fn, top: int = 15) -> dict:
    """Device time of one call of ``fn`` (torch.profiler) by part of the
    step (``STEP_PARTS``: the first pattern a kernel's name matches) and
    the ``top`` largest kernels with their call counts."""
    rows = profile_rows(torch, fn)
    parts = {name: {"ms": 0.0, "calls": 0} for name, _ in STEP_PARTS}
    parts["other"] = {"ms": 0.0, "calls": 0}
    for key, calls, ms in rows:
        part = next((name for name, pat in STEP_PARTS
                     if re.search(pat, key)), "other")
        parts[part]["ms"] += ms
        parts[part]["calls"] += calls
    return {"total_ms": sum(r[2] for r in rows), "parts": parts,
            "top": [{"kernel": k[:120], "calls": c, "ms": ms}
                    for k, c, ms in rows[:top]]}


def resnet50_dp_phase(torch, mpi, ops, dev):
    """The CNN slice's main path: ResNet-50 at full width and depth as a
    BatchNorm DP recipe of R50_N ranks rank-major on the card
    (recipes.make_bn_dp_train_step_rank_major, backend "pallas", SGD),
    batches from synthetic_image_classification through
    prefetch_to_device.  Three replicated steps with every allreduce (the
    gradient buckets on row 8, the BatchNorm statistics on row 11) held
    bitwise to the plain ring on the same stacks; three more timed by CUDA
    events; one counting the host syncs; one profiled by part; then one
    ZeRO-1 and one ZeRO-3 step from the same state and batch as one more
    replicated step (cuDNN's deterministic algorithms for the three, so
    they differ only in the sync), their reduce-scatters and all-gathers
    (rows 9, 10) bitwise to the plain ring, ZeRO-1's update within
    R50_ZERO_RTOL of the replicated one; every launch of rows 8 and 11 on
    the 16-byte path.  Every kernel counter is set to 0
    just before the main path and read just after; the replicated
    reference step's launches are taken out."""
    from torchmpi_tpu_torch.utils import data as dutil
    from torchmpi_tpu_torch.utils.input_pipeline import prefetch_to_device

    ring = ops["ring"]
    recipes, zero, fusion = mpi.recipes, mpi.parallel.zero, mpi.fusion
    n, b = R50_N, R50_BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    model = mpi.models.ResNet50(num_classes=R50_CLASSES,
                                dtype=torch.bfloat16, device=dev,
                                generator=g)
    params, stats = recipes.bn_state(model)
    spec = fusion.FusedSpec(params)
    check(sum(p.numel() for p in params) == R50_PARAMS
          and sum(t.numel() for t in stats) == R50_STATS
          and spec.n_launches == R50_BUCKETS,
          f"ResNet-50 layout: {sum(p.numel() for p in params)} params, "
          f"{sum(t.numel() for t in stats)} statistics, "
          f"{spec.n_launches} buckets")
    tx = mpi.optim.sgd(R50_LR, momentum=R50_MOMENTUM)
    opt = [tx.init(p) for p in params]
    step = recipes.make_bn_dp_train_step_rank_major(model, tx, n,
                                                    backend="pallas")
    t0 = time.perf_counter()
    X, Y = dutil.synthetic_image_classification(
        2 * n * b, image_shape=(R50_IMAGE, R50_IMAGE, 3),
        num_classes=R50_CLASSES, seed=SEED)
    data_s = time.perf_counter() - t0
    n_batches = R50_CHECKED_STEPS + R50_TIMED_STEPS + 3
    it = prefetch_to_device(dutil.batches(X, Y, n * b, steps=n_batches,
                                          seed=SEED), depth=2, device=dev)

    def batch():
        xb, yb = next(it)   # NHWC on the card: NCHW in channels-last
        return xb.permute(0, 3, 1, 2), yb

    def one_step(xb, yb):
        nonlocal params, opt, stats
        params, opt, stats, loss = step(params, opt, stats, xb, yb)
        return loss

    def counts():
        return {k: ring.LAUNCHES[k] for k in R50_ROWS}

    log = TapLog()
    losses = []
    torch.cuda.synchronize()
    for mod in ops.values():
        mod.reset_launches()
    restore = tap_rank_major_routes(torch, mpi, ring, log,
                                    ops=("allreduce_rank_major",))
    try:
        log.label = "replicated"
        for _ in range(R50_CHECKED_STEPS):
            losses.append(one_step(*batch()))
    finally:
        restore()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(R50_TIMED_STEPS):
        xb, yb = batch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(one_step(xb, yb))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    xb, yb = batch()
    syncs = count_host_syncs(torch, lambda: losses.append(one_step(xb, yb)))
    xb, yb = batch()
    profile = step_profile(torch, lambda: losses.append(one_step(xb, yb)))

    # ZeRO-1 and ZeRO-3 from the replicated state: the momentum traces as
    # [n, shard] shards; the same parameters, statistics and batch.
    zspec = zero.flat_spec(params, n_shards=n)
    zstate = mpi.optim.TraceState(
        fusion.local_shards([s.trace for s in opt], zspec))
    template = [torch.empty_like(p, device="meta") for p in params]
    step1 = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="pallas", zero=1)
    step3 = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="pallas", zero=3, params_template=template)
    xb, yb = batch()
    restore = tap_rank_major_routes(torch, mpi, ring, log, ops=(
        "reduce_scatter_rank_major", "allgather_rank_major",
        "allreduce_rank_major"))
    torch.backends.cudnn.deterministic = True
    try:
        log.label = "check"
        before = counts()
        p_rep, _, _, l_rep = step(params, opt, stats, xb, yb)
        excluded = {k: v - before[k] for k, v in counts().items()}
        log.label = "zero1"
        p_z1, s_z1, st_z1, l_z1 = step1(params, zstate, stats, xb, yb)
        log.label = "zero3"
        shards = zero.shard_params_rank_major(params, n)
        p_z3, s_z3, st_z3, l_z3 = step3(shards, zstate, stats, xb, yb)
    finally:
        torch.backends.cudnn.deterministic = False
        restore()
    launches = {k: v - excluded[k] for k, v in counts().items()}
    vector = {k: {"all": ring.LAUNCHES[k], "vector": ring.VECTOR_LAUNCHES[k]}
              for k in R50_ROWS}
    losses += [l_z1, l_z3]
    with torch.no_grad():
        rel = [float(((a - p) - (r - p)).norm()
                     / (r - p).norm().clamp_min(1e-30))
               for a, r, p in zip(p_z1, p_rep, params)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    z3_eq_z1 = (torch.equal(fusion.local_shards(p_z1, zspec), p_z3)
                and torch.equal(s_z1.trace, s_z3.trace)
                and all(torch.equal(a, c) for a, c in zip(st_z1, st_z3)))
    losses = [float(v) for v in losses]
    by_row = {}
    for e in log:
        for row in e["rows"]:
            d = by_row.setdefault(f"{e['label']} {row}", {
                "calls": 0, "elems": set(), "bitwise": True})
            d["calls"] += 1
            d["elems"].add(e["elems"])
            d["bitwise"] = d["bitwise"] and e["bitwise"]
    by_row = {k: dict(v, elems=sorted(v["elems"])) for k, v in by_row.items()}
    med = statistics.median(step_ms)
    emit({"phase": "resnet50_dp", "ranks": n, "batch_per_rank": b,
          "config": {"model": "ResNet50", "image": R50_IMAGE,
                     "classes": R50_CLASSES, "dtype": "bfloat16",
                     "params": "float32", "optimizer":
                     f"sgd({R50_LR}, momentum={R50_MOMENTUM})",
                     "backend": "pallas", "memory_format": "channels_last"},
          "params": R50_PARAMS, "batch_stats": R50_STATS,
          "buckets": spec.n_launches,
          "bucket_elems": [hi - lo for gr in spec.groups
                           for lo, hi in gr.bounds],
          "data_seconds": data_s, "losses": losses,
          "step_ms": step_ms, "median_step_ms": med,
          "img_per_s": n * b * 1e3 / med, "peak_mem_bytes": peak,
          "host_syncs_per_step": syncs, "step_device_profile": profile,
          "syncs_by_row": by_row,
          "bitwise_vs_plain": all(e["bitwise"] for e in log),
          "n_collectives_checked": len(log),
          "all_gather_rows_equal": all(e.get("rows_equal", True)
                                       for e in log),
          "zero1_vs_replicated_max_rel_l2": rel[worst],
          "zero1_worst_tensor": [nm for nm, _ in
                                 model.named_parameters()][worst],
          "zero1_tolerance": R50_ZERO_RTOL,
          "zero3_equals_zero1": z3_eq_z1,
          "launches": launches, "check_launches": excluded,
          "launches_on_16_byte_path": vector,
          "zero_shard_elems": zspec.shard})
    grad_rows = {tuple(e["rows"]) for e in log if e["verb"] == "allreduce"
                 and e["elems"] != R50_STATS}
    stat_rows = {tuple(e["rows"]) for e in log if e["verb"] == "allreduce"
                 and e["elems"] == R50_STATS}
    check(all(e["bitwise"] for e in log) and len(log) == (
        R50_CHECKED_STEPS + 1) * (R50_BUCKETS + 1) + 2 * 2 + 2,
          f"a ResNet-50 sync differs from the plain ring ({len(log)} "
          f"checked): {by_row}")
    check(grad_rows == {("ring_allreduce_chunked",)}
          and stat_rows == {("ring_allreduce",)},
          f"gradient syncs on {grad_rows}, statistics on {stat_rows}")
    check(all(e.get("rows_equal", True) for e in log),
          "the all-gathered ranks differ")
    check(rel[worst] <= R50_ZERO_RTOL,
          f"ZeRO-1 vs replicated: {rel[worst]} ({worst})")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    for name in R50_ROWS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"ResNet-50 path")
    for name in R50_VECTOR_ROWS:
        check(vector[name]["all"] == vector[name]["vector"],
              f"{name}: {vector[name]} launches on the 16-byte path")
    return launches


def cnn_examples_phase(torch):
    """The port's three main-path examples (and CIFAR under ZeRO-3) run
    in-process as a world of one on the card, each to its accuracy bar."""
    import importlib

    runs = []
    for name, argv, bar in CNN_EXAMPLES:
        mod = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        out = mod.main(["--device", "cuda", *argv])
        runs.append({"example": name, "argv": list(argv), "bar": bar,
                     "accuracy": out["accuracy"],
                     "img_per_s": out["img_per_s"],
                     "losses": out["losses"],
                     "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    emit({"phase": "cnn_examples", "runs": runs})
    for r in runs:
        check(r["accuracy"] > r["bar"], f"{r['example']} {r['argv']}: "
              f"accuracy {r['accuracy']} <= {r['bar']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torchmpi_tpu_torch as mpi
        from torchmpi_tpu_torch.ops import _build, flash, ring, xent
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    # Full float32 products in every plain reference (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build()
    ptxas = {n: ptxas_summary(log) for n, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(_build.BUILD_DIR), "ptxas": ptxas,
          "card_uuid": nvidia_smi("uuid")})

    ops = {"flash": flash, "xent": xent}
    dev = mpi.init()
    try:
        rows = kernel_phase(torch, flash, dev)
        rows += xent_kernel_phase(torch, xent, dev)
        rows += xent_f32_phase(torch, xent, dev)
        rows += ring_kernel_phase(torch, mpi, ring, dev)
        rows += ring_rs_ag_kernel_phase(torch, ring, dev)
        model, _, _, _ = train_phase(torch, mpi, ops, dev, "dense")
        del model
        torch.cuda.empty_cache()
        # The main path of slices 1 and 2: stage B', the fused LM-head loss.
        model, tok, launches, _ = train_phase(torch, mpi, ops, dev, "fused")
        consistency_phase(torch, mpi, model, tok, dev)
        del model
        torch.cuda.empty_cache()
        # The main path of the float32 head (slice 11): stage B' at the
        # model's default float32, the head on the tf32x3 route.
        model, _, _, routes = train_phase(torch, mpi, ops, dev, "fused",
                                          torch.float32)
        launches.update({f"{n}[tf32x3]": c["tf32x3"]
                         for n, c in routes.items()})
        del model
        torch.cuda.empty_cache()
        # The main path of slice 3: the DP step of RING_N ranks on the
        # card, its gradients synced by the ring kernels.
        ring_launches, ring_sync_ms = ring_dp_phase(
            torch, mpi, dict(ops, ring=ring), dev)
        launches.update({k: v for k, v in ring_launches.items()
                         if k in RING_CONFIGS})
        torch.cuda.empty_cache()
        # The main path of slice 4: ZeRO-1 / ZeRO-3 of RING_N ranks on the
        # card, its reduce-scatters and all-gathers on the ring kernels.
        launches.update(zero_dp_phase(torch, mpi, dict(ops, ring=ring), dev,
                                      ring_sync_ms))
        torch.cuda.empty_cache()
        # The main path of slice 12: ResNet-50 as the BatchNorm DP recipe of
        # RING_N ranks on the card, its syncs on rows 8 and 11 and its ZeRO
        # legs on rows 9 and 10; then the CNN examples to their bars.
        r50_launches = resnet50_dp_phase(torch, mpi, dict(ops, ring=ring),
                                         dev)
        torch.cuda.empty_cache()
        cnn_examples_phase(torch)
    finally:
        mpi.stop()

    # library_call says what library_ms timed: for rows 2 and 3 it is one
    # backward that computes dq, dk and dv together.
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: every main path's count of the kernel; by path beside it.
    def by_path(name):
        earlier = ("ring_dp" if name in RING_CONFIGS else
                   "zero_dp" if name.startswith("ring") else "train")
        return {earlier: launches[name],
                **({"resnet50_dp": r50_launches[name]}
                   if name in r50_launches else {})}

    kernels = [{**{k: dict(row, launches=sum(by_path(
                    row["name"]).values()))[k] for k in keys},
                "launches_by_path": by_path(row["name"]),
                "library_call": row.get("library_call")} for row in rows]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
